#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``accel_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. build: compile the CUDA kernels from ``accel_tpu_torch/kernels/*.cu``.
2. kernel: each kernel against its plain PyTorch version on the card, at
   the main path's shapes, with the max error (or the class-map agreement
   and the logit margins at disagreements) and median CUDA-event times.
3. small_reference: a tiny f32 Accel model on the card (kernels) against
   the same model on the CPU (plain versions): logits and class maps.
4. e2e: Accel-18 (R101 keyframe branch, R18 update branch, FlowNet-S at
   full width, frozenbn + fused7 stem, bf16) at 1024x2048, B=1, k=5,
   through ``VideoSegmenter.push_group``: three incremental + 'last'
   groups and one direct group, with every kernel launch counted; then the
   same groups with every kernel replaced by its plain version, and the
   class-map agreement between the two.
5. e2e_flagship: one incremental + 'last' group with the flagship cfg's
   groupnorm + conv7 stem + scale_field_norm mean1.

Then the ``{"kernels": [...]}`` line, the card's name and power limit from
nvidia-smi, and, last, ``{"ok": true, "device": {...}}``. Any failed check
raises, so the script exits non-zero and prints no result line. Without a
CUDA device it exits with code 2. Weights are random, drawn from a seed;
the flow heads are re-drawn so the flow moves content (at init it is 0).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from accel_tpu_torch import kernels
from accel_tpu_torch.core.pipeline import clip_logits
from accel_tpu_torch.core.serving import VideoSegmenter
from accel_tpu_torch.models.accel import build_model
from accel_tpu_torch.ops import fused_stem as stem_ops
from accel_tpu_torch.ops import upsample_argmax as ua_ops
from accel_tpu_torch.ops import warp_cuda as warp_ops

SEED = 0
H, W = 1024, 2048
K = 5
BENCH_NET = dict(ref_depth=101, update_depth=18, feat_stride=16, head_channels=1024,
                 head_dilation=6, norm="frozenbn", stem="fused7", dtype="bfloat16",
                 use_pallas_warp=True, warp_max_disp=8, warp_dtype="f32",
                 warp_gather="taps", scale_field_norm="none", scale_cascade="last",
                 flow_width_mult=1.0)
FLAGSHIP_NET = dict(BENCH_NET, norm="groupnorm", stem="conv7", scale_field_norm="mean1")
LAUNCHERS = {
    "warp": warp_ops.warp_cuda,
    "upsample_argmax": ua_ops.upsample_argmax_cuda,
    "fused_stem": stem_ops.fused_stem_cuda,
}
REPLACES = {
    "warp": "accel_tpu/ops/warp_pallas.py:84",
    "upsample_argmax": "accel_tpu/ops/upsample_argmax.py:48",
    "fused_stem": "accel_tpu/ops/fused_stem.py:84",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def median_ms(fn, iters: int = 10) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` calls, after 2 warm-ups."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def reset_counts() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0


def counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in LAUNCHERS.items()}


# ---- phase 2: each kernel against its plain version ------------------------


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def kernel_warp(results: dict) -> None:
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        g = _gen(SEED + 1)
        feat = torch.randn((4, 19, 64, 128), generator=g, device="cuda").to(dtype)
        flow = (torch.rand((4, 2, 64, 128), generator=g, device="cuda") * 2 - 1) * 12.0
        got = warp_ops.warp_cuda(feat, flow, 8)
        ref = warp_ops.warp_plain(feat, flow, 8)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        bound = 1e-5 if dtype == torch.float32 else 1e-2 * ref.float().abs().max().item()
        check(got.dtype == dtype and err <= bound, f"warp {dtype}: max err {err} > {bound}")
        row = dict(kernel="warp", dtype=str(dtype), shape=list(feat.shape), max_abs_flow=12.0,
                   max_disp=8, max_abs_err=err, tol=bound,
                   ms=median_ms(lambda: warp_ops.warp_cuda(feat, flow, 8)),
                   plain_ms=median_ms(lambda: warp_ops.warp_plain(feat, flow, 8)))
        emit(dict(phase="kernel", **row))
        rows.append(row)
    results["warp"] = rows[0]


def kernel_upsample_argmax(results: dict) -> None:
    rows = []
    for shape, out_hw in (((20, 19, 64, 128), (H, W)), ((2, 19, 45, 60), (720, 960))):
        logits = torch.randn(shape, generator=_gen(SEED + 2), device="cuda")
        got = ua_ops.upsample_argmax_cuda(logits, out_hw)
        ref = ua_ops.upsample_argmax_plain(logits, out_hw)
        up = F.interpolate(logits, size=out_hw, mode="bilinear", align_corners=False)
        diff = got != ref
        agree = 1.0 - diff.float().mean().item()
        # logit gap between the plain version's class and the kernel's class
        gap = (up.gather(1, ref[:, None].long()) - up.gather(1, got[:, None].long()))[:, 0]
        max_gap = gap.abs().max().item()
        tie = 1e-5 * up.abs().max().item()
        check(got.dtype == torch.uint8 and tuple(got.shape) == (shape[0], *out_hw),
              "upsample_argmax output shape/dtype")
        check(agree >= 0.9999, f"upsample_argmax agreement {agree}")
        check(max_gap <= tie, f"upsample_argmax disagreement at margin {max_gap} > {tie}")
        row = dict(kernel="upsample_argmax", shape=list(shape), out_hw=list(out_hw),
                   agreement=agree, n_disagree=int(diff.sum().item()),
                   max_abs_err=max_gap, tie_tol=tie,
                   ms=median_ms(lambda: ua_ops.upsample_argmax_cuda(logits, out_hw)),
                   plain_ms=median_ms(lambda: ua_ops.upsample_argmax_plain(logits, out_hw)))
        del up, gap
        emit(dict(phase="kernel", **row))
        rows.append(row)
    results["upsample_argmax"] = rows[0]


def kernel_fused_stem(results: dict) -> None:
    rows = []
    for shape in ((4, 3, H, W), (1, 3, 720, 960)):
        g = _gen(SEED + 3)
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        w = (torch.randn((64, 3, 7, 7), generator=g, device="cuda") * 0.1).to(torch.bfloat16)
        inv = torch.rand((64,), generator=g, device="cuda") + 0.5
        shift = torch.randn((64,), generator=g, device="cuda") * 0.1
        got = stem_ops.fused_stem_cuda(x, w, inv, shift)
        ref = stem_ops.fused_stem_plain(x, w, inv, shift)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        bound = 2e-2 * ref.float().abs().max().item()
        check(got.dtype == torch.bfloat16 and got.shape == ref.shape and err <= bound,
              f"fused_stem {shape}: max err {err} > {bound}")
        row = dict(kernel="fused_stem", dtype="bfloat16", shape=list(shape), max_abs_err=err,
                   tol=bound, ms=median_ms(lambda: stem_ops.fused_stem_cuda(x, w, inv, shift)),
                   plain_ms=median_ms(lambda: stem_ops.fused_stem_plain(x, w, inv, shift)))
        emit(dict(phase="kernel", **row))
        rows.append(row)
    results["fused_stem"] = rows[0]


# ---- end to end ---------------------------------------------------------------


@torch.no_grad()
def live_flow_heads(model, frames: torch.Tensor, seed: int, target: float = 3.0) -> float:
    """Re-draw the zero-initialised flow head and the scale field from a
    seed; the flow head is then scaled (the flow is linear in it) so the
    largest displacement between the first two frames is ``target``
    feature pixels. Returns that displacement."""
    g = torch.Generator().manual_seed(seed)
    fn = model.flownet
    for conv, sigma in ((fn.predict_flow2, 1.0), (fn.scale_field, 0.05)):
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=g) * sigma)
    cur = frames[:, 1].permute(0, 3, 1, 2)
    anchor = frames[:, 0].permute(0, 3, 1, 2)
    flow, _ = model.flow(cur, anchor)
    fn.predict_flow2.weight.mul_(target / flow.abs().max())
    flow, _ = model.flow(cur, anchor)
    return flow.abs().max().item()


def moving_clip(n_frames: int, hw: tuple[int, int], seed: int, device) -> torch.Tensor:
    """(1, n_frames, H, W, 3) f32: a smooth random scene panning 4 px per frame."""
    g = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn((1, 3, hw[0] // 8, hw[1] // 8), generator=g, device=device)
    base = F.interpolate(base, size=hw, mode="bilinear", align_corners=False)
    frames = [torch.roll(base, shifts=4 * t, dims=3) for t in range(n_frames)]
    return torch.stack(frames, dim=1).permute(0, 1, 3, 4, 2).contiguous()


def timed_group(seg: VideoSegmenter, frames: torch.Tensor) -> tuple[torch.Tensor, float]:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = seg.push_group(frames)
    torch.cuda.synchronize()
    return pred, (time.perf_counter() - t0) * 1e3


def check_pred(pred: torch.Tensor, shape: tuple) -> None:
    check(tuple(pred.shape) == shape and pred.dtype == torch.uint8,
          f"prediction {tuple(pred.shape)} {pred.dtype}, expected {shape} uint8")
    check(int(pred.max().item()) < 19, "class index out of range")


def small_reference() -> None:
    """Tiny f32 model: kernels on the card against plain versions on the CPU."""
    net = dict(ref_depth=18, update_depth=18, head_channels=32, dtype="float32",
               stem="fused7")
    cpu = build_model(net, device="cpu", generator=torch.Generator().manual_seed(SEED))
    clip = moving_clip(10, (128, 128), SEED + 4, "cpu")
    max_flow = live_flow_heads(cpu, clip, SEED + 5)
    gpu = build_model(net, device="cuda", generator=torch.Generator().manual_seed(SEED))
    gpu.load_state_dict(cpu.state_dict())
    for propagate in ("incremental", "direct"):
        want = clip_logits(cpu, clip.permute(0, 1, 4, 2, 3), K, propagate)
        got = clip_logits(gpu, clip.cuda().permute(0, 1, 4, 2, 3), K, propagate).cpu()
        err = (got - want).abs().max().item()
        bound = 1e-3 * (1 + want.abs().max().item())
        seg_c, seg_g = (VideoSegmenter(m, K, propagate=propagate) for m in (cpu, gpu))
        agree = min((seg_g.push_group(clip[:, g:g + K].cuda()).cpu()
                     == seg_c.push_group(clip[:, g:g + K])).float().mean().item()
                    for g in (0, K))
        emit(dict(phase="small_reference", propagate=propagate, max_abs_flow=max_flow,
                  logits_max_abs_err=err, tol=bound, class_agreement=agree))
        check(err <= bound, f"small reference logits {propagate}: {err} > {bound}")
        check(agree >= 0.999, f"small reference class maps {propagate}: {agree}")


def e2e_bench() -> dict[str, int]:
    """Phase 4. Returns the launch counts of the main path's run."""
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    model = build_model(BENCH_NET, device="cuda", generator=gen)
    clip = moving_clip(4 * K, (H, W), SEED + 6, "cuda")
    max_flow = live_flow_heads(model, clip, SEED + 7)
    check(max_flow > 0.5, f"flow {max_flow} too small to exercise the warp")
    setup_s = time.perf_counter() - t0
    groups = [("incremental", clip[:, g * K:(g + 1) * K]) for g in range(3)]
    groups.append(("direct", clip[:, 3 * K:4 * K]))

    def run(m):
        segs = {p: VideoSegmenter(m, K, propagate=p) for p in ("incremental", "direct")}
        return [timed_group(segs[p], frames) for p, frames in groups]

    run(model)  # warm-up: cuDNN algorithm choice, allocator
    reset_counts()
    out = run(model)
    launched = counts()
    for (p, _), (pred, ms) in zip(groups, out):
        check_pred(pred, (1, K, H, W))
    inc_ms = [ms for (p, _), (_, ms) in zip(groups, out) if p == "incremental"]
    emit(dict(phase="e2e", config="accel18 frozenbn fused7 bf16", hw=[H, W], B=1, k=K,
              setup_s=setup_s, max_abs_flow=max_flow,
              group_ms={f"{p}{i}": ms for i, ((p, _), (_, ms)) in enumerate(zip(groups, out))},
              incremental_fps=K * len(inc_ms) / (sum(inc_ms) / 1e3),
              direct_fps=K / (out[-1][1] / 1e3), launches=launched))
    for name, n in launched.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    plain = build_model(BENCH_NET, device="cuda", generator=torch.Generator().manual_seed(SEED),
                        use_kernels=False)
    plain.load_state_dict(model.state_dict())
    run(plain)  # warm-up
    plain_out = run(plain)
    check(counts() == launched, "the plain path launched a kernel")
    agree = {}
    for i, ((p, _), (pred, _), (ref, _)) in enumerate(zip(groups, out, plain_out)):
        agree[f"{p}{i}"] = (pred == ref).float().mean().item()
    emit(dict(phase="e2e_plain", group_ms={f"{p}{i}": ms for i, ((p, _), (_, ms))
                                           in enumerate(zip(groups, plain_out))},
              class_agreement_vs_kernels=agree))
    for key, a in agree.items():
        check(a >= 0.999, f"e2e class maps kernel vs plain, group {key}: {a}")
    return launched


def e2e_flagship() -> None:
    model = build_model(FLAGSHIP_NET, device="cuda",
                        generator=torch.Generator().manual_seed(SEED))
    clip = moving_clip(K, (H, W), SEED + 8, "cuda")
    live_flow_heads(model, clip, SEED + 9)
    seg = VideoSegmenter(model, K, propagate="incremental")
    seg.push_group(clip)  # warm-up
    seg.reset()
    reset_counts()
    pred, ms = timed_group(seg, clip)
    launched = counts()
    check_pred(pred, (1, K, H, W))
    emit(dict(phase="e2e_flagship", config="accel18 groupnorm conv7 mean1 bf16", hw=[H, W], B=1,
              k=K, group_ms=ms, fps=K / (ms / 1e3), launches=launched))
    check(launched["warp"] > 0 and launched["upsample_argmax"] > 0,
          "flagship path skipped a kernel")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # f32 convs and matmuls in full f32 on both sides of every comparison
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    built = kernels.build()
    for name in kernels.SOURCES:
        kernels.load(name)
    ptxas = {name: [ln.strip() for ln in kernels.library_path(name).with_suffix(".log")
                    .read_text().splitlines() if "Used" in ln or "spill" in ln]
             for name in built}
    emit(dict(phase="build", wall_s=time.perf_counter() - t0, nvcc_s=built, ptxas=ptxas))

    results: dict = {}
    kernel_warp(results)
    kernel_upsample_argmax(results)
    kernel_fused_stem(results)
    small_reference()
    launched = e2e_bench()
    torch.cuda.empty_cache()
    e2e_flagship()

    emit({"kernels": [
        dict(name=name, route="cuda", source=f"accel_tpu_torch/kernels/{name}.cu",
             replaces=REPLACES[name], launches=launched[name],
             max_abs_err=results[name]["max_abs_err"], ms=results[name]["ms"],
             plain_ms=results[name]["plain_ms"])
        for name in LAUNCHERS]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
