#!/usr/bin/env python3
"""Device time per group of the port's main paths on one GPU: the kernel
path against the plain path, from ``torch.profiler`` traces.

    python3 port_profile.py [--tree DIR] [--repeat N]

``--tree`` imports ``accel_tpu_torch`` (and ``chip_smoke``'s model
settings) from another checkout, e.g. an older commit unpacked with
``git archive``, so two versions are profiled by this one script on one
card. Configurations, at 1024x2048, B=1, k=5, bf16, random weights from
``chip_smoke.py``'s seed (flow heads re-drawn so the flow moves content):
Accel-18 (chip_smoke's ``BENCH_NET``) and the DFF row (``DFF_NET``), each
one incremental + 'last' group and one direct group, and per-frame
DeepLab-101 with ``dilated_conv: pallas`` on 5 frames: the kernel path
(``use_kernels=True``) against the plain path, both through
``push_group``. Then Accel-18's kernel path served frame by frame
(``push_frame``, each frame ending in ``torch.cuda.synchronize()``, as a
server sends each frame's class map) against ``push_group``. The two paths
of a row alternate ``--repeat`` times; every turn serves two groups
untimed (warm-up) and a third under the profiler (device activity only)
and on the host clock (ending in ``torch.cuda.synchronize()``). One JSON
line per turn, all from that one group: host ms, device ms (the time in
which at least one device event ran), idle share 1 - device/host, the
device ms of each of the port's kernels and the eight largest device
events by name (summed per name's first 80 characters). The profiler's
own host overhead is inside host ms.

Two rows compare two models on the same weights, both on the kernel
path: int8 Accel-18 (``INT8_NET``) against the bf16 one, and the folded
accel18_fast (``FOLD_NET``, conv7 stem) against the same model with the
downscales resized. Then the int8 convs of one group split into their
parts (``int8_split``) and the folded first convs against resize + conv
(``fold_split``). Then Accel-18 and the DFF row, direct, through their
programs exported and loaded by ``core/export.py`` (B=1) against
``push_group`` of the same model. Every row also counts its device
events (``device_events``).

Then one train step of the flagship cfg (``experiments/cfgs/
accel18_cityscapes.yaml``: the clip objective, B=2 x 5 frames at 768x768,
remat, aux loss, SGD on f32 master weights) and of the pair cfg (B=4),
kernel path against plain path, on a synthetic panning batch with one
annotated frame per clip: two steps untimed, a third under the profiler,
the same line per turn. The card's name and power limit come last.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time


# the port's kernels: the function names in kernels/<name>.cu (each in an
# anonymous namespace, so a mangled name also carries "_<name>_cu_")
KERNELS = {"warp": "warp_kernel", "upsample_argmax": "upsample_argmax_kernel",
           "fused_stem": "fused_stem_", "warp_onehot": "warp_onehot_kernel",
           "dilated_conv": "dilated_conv_"}


def port_kernel(event_name: str) -> str | None:
    """Which of the port's kernels a device event is, if any."""
    for name, fn in KERNELS.items():
        if f"(anonymous namespace)::{fn}" in event_name or f"_{name}_cu_" in event_name:
            return name
    return None


def busy_ms(events) -> float:
    """The time in which at least one of the device events ran: the union
    of their intervals, so events that overlap count once."""
    total, end = 0.0, -math.inf
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in events):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def int8_split(cs, hw) -> None:
    """Int8 Accel-18's int8 convs of one B=1 incremental group, timed part
    by part at the shapes the group gives them: the activation's quantize
    pass (abs-max, divide, round, clip, int8), the im2col, the int8 GEMM
    (``torch._int_mm``), the f32 rescale to bf16, and the bf16 cuDNN conv
    of the same shape (the float model's conv). Median CUDA-event ms of
    each part per conv, summed over the group's convs; one line per
    branch."""
    import torch
    import torch.nn.functional as F

    from accel_tpu_torch.core.serving import VideoSegmenter
    from accel_tpu_torch.models.accel import build_model
    from accel_tpu_torch.models.resnet import Int8Conv2d
    from accel_tpu_torch.ops import quant

    model = build_model(cs.INT8_NET, device="cuda",
                        generator=torch.Generator().manual_seed(cs.SEED))
    calls, hooks = [], []
    for branch in ("ref_net", "update_net"):
        for m in getattr(model, branch).modules():
            if isinstance(m, Int8Conv2d):
                hooks.append(m.register_forward_hook(
                    lambda mod, i, o, b=branch: calls.append((b, mod, tuple(i[0].shape)))))
    clip = cs.moving_clip(cs.K, hw, cs.SEED + 6, "cuda")
    with torch.inference_mode():
        VideoSegmenter(model, cs.K, propagate="incremental").push_group(clip)
    for h in hooks:  # the timed calls below are not the group's
        h.remove()
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    parts = {b: dict(convs=0, quantize=0.0, im2col=0.0, int_mm=0.0, rescale=0.0,
                     int8_total=0.0, bf16_cudnn=0.0, gemm_ops=0) for b in ("ref_net", "update_net")}
    with torch.inference_mode():
        for branch, mod, shape in calls:
            x = torch.randn(shape, generator=g, device="cuda", dtype=torch.bfloat16)
            w = mod._quantized(mod.weight)
            st, pad, dil = mod.stride, mod.padding, mod.dilation
            xq, xs = quant.quantize_symmetric(x)
            cols, ho, wo = quant.im2col_int8(xq, w.q.shape[2:], st, pad, dil)
            acc = quant.int_mm(cols, w.mat)
            scale = (xs * w.scale).view(1, -1, 1, 1)
            acc4 = acc.reshape(shape[0], ho, wo, -1).permute(0, 3, 1, 2)
            row = parts[branch]
            row["convs"] += 1
            row["gemm_ops"] += 2 * cols.shape[0] * cols.shape[1] * w.mat.shape[1]
            row["quantize"] += cs.median_ms(lambda: quant.quantize_symmetric(x), 3)
            row["im2col"] += cs.median_ms(
                lambda: quant.im2col_int8(xq, w.q.shape[2:], st, pad, dil), 3)
            row["int_mm"] += cs.median_ms(lambda: quant.int_mm(cols, w.mat), 3)
            row["rescale"] += cs.median_ms(lambda: (acc4.float() * scale).to(x.dtype), 3)
            row["int8_total"] += cs.median_ms(lambda: mod(x), 3)
            row["bf16_cudnn"] += cs.median_ms(
                lambda: F.conv2d(x, mod.weight, None, st, pad, dil), 3)
            del x, xq, cols, acc, acc4
    for branch, row in parts.items():
        print(json.dumps(dict(config="accel18 int8 conv split", branch=branch,
                              group="B=1 incremental, k=5", **row)), flush=True)
    del model
    torch.cuda.empty_cache()


def fold_split(cs, hw) -> None:
    """The folded first convs of accel18_fast at one group's shapes
    (B*k = 5 frames at 1024x2048, bf16), against the resize + conv they
    replace: the update stem (f=2, a 16x16 stride-4 composed kernel) and
    FlowNet's conv1 at ``flow_input_downscale`` 4 (f=4, two 32x32
    stride-8 half kernels per frame, then the pair sum, against the resize,
    the 6-channel pair concat and conv1 on the k-1 pairs). Median CUDA-event
    ms of each."""
    import torch
    import torch.nn.functional as F

    from accel_tpu_torch.ops.fold_downscale import fold_downscale_conv
    from accel_tpu_torch.ops.upsample import resize_bilinear

    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    x = torch.randn((cs.K, 3, *hw), generator=g, device="cuda", dtype=torch.bfloat16)
    w7 = torch.randn((64, 3, 7, 7), generator=g, device="cuda", dtype=torch.bfloat16) / 12
    c1 = torch.randn((32, 6, 7, 7), generator=g, device="cuda", dtype=torch.bfloat16) / 17
    b1 = torch.zeros(32, device="cuda", dtype=torch.bfloat16)
    h2, w2 = hw[0] // 2, hw[1] // 2
    h4, w4 = hw[0] // 4, hw[1] // 4

    def flow_fold():
        cur = fold_downscale_conv(x, c1[:, :3], 4, 2, 3) + b1.view(1, -1, 1, 1)
        anchor = fold_downscale_conv(x, c1[:, 3:], 4, 2, 3)
        return cur[1:] + anchor[:-1]

    def flow_resize():
        small = resize_bilinear(x, (h4, w4))
        return F.conv2d(torch.cat([small[1:], small[:-1]], dim=1), c1, b1, 2, 3)

    with torch.inference_mode():
        rows = dict(
            update_stem_fold_ms=cs.median_ms(lambda: fold_downscale_conv(x, w7, 2, 2, 3)),
            update_stem_resize_ms=cs.median_ms(lambda: resize_bilinear(x, (h2, w2))),
            update_stem_resize_conv7_ms=cs.median_ms(
                lambda: F.conv2d(resize_bilinear(x, (h2, w2)), w7, None, 2, 3)),
            flow_conv1_fold_ms=cs.median_ms(flow_fold),
            flow_conv1_resize_ms=cs.median_ms(flow_resize))
    print(json.dumps(dict(config="accel18_fast fold split", frames=cs.K, hw=list(hw),
                          dtype="bf16", **rows)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None, help="checkout to import accel_tpu_torch from")
    ap.add_argument("--repeat", type=int, default=2, help="turns per path")
    args = ap.parse_args()
    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("port_profile: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from accel_tpu_torch.config import load_config
    from accel_tpu_torch.core.serving import VideoSegmenter
    from accel_tpu_torch.core.trainer import init_train_state, make_optimizer, make_train_step
    from accel_tpu_torch.models.accel import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    K, hw = cs.K, (cs.H, cs.W)

    def models(nets, seed_clip, paths):
        """The models the row's paths serve, {key: (net, use_kernels)}: the
        first drawn from the seed with live flow heads, the others holding
        its weights."""
        clip = cs.moving_clip(3 * K, hw, seed_clip, "cuda")
        out = {}
        for key, (net, use_kernels) in nets.items():
            if key not in {model for model, _ in paths.values()}:
                continue
            m = build_model(net, device="cuda", use_kernels=use_kernels,
                            generator=torch.Generator().manual_seed(cs.SEED))
            if out:
                m.load_state_dict(next(iter(out.values())).state_dict())
            elif hasattr(m, "flownet"):
                cs.live_flow_heads(m, clip, cs.SEED + 7)
            out[key] = m
        return out, clip

    def push_group(seg, frames):
        seg.push_group(frames)

    def push_frames(seg, frames):
        for i in range(frames.shape[1]):
            seg.push_frame(frames[:, i])
            torch.cuda.synchronize()

    def profiled(run):
        """Host ms, device ms, the port's kernels' ms and the top events of
        one ``run()`` under the profiler."""
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t0) * 1e3
        events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        if not events:
            raise RuntimeError("the profiler recorded no device events")
        by_name: dict[str, float] = {}
        for e in events:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        by_kernel = {k: sum(ms for name, ms in by_name.items() if port_kernel(name) == k)
                     for k in KERNELS}
        # summed per 80-character prefix, the name as it is printed
        by_prefix: dict[str, float] = {}
        for name, ms in by_name.items():
            by_prefix[name[:80]] = by_prefix.get(name[:80], 0.0) + ms
        top = sorted(by_prefix.items(), key=lambda kv: -kv[1])[:8]
        return (host_ms, busy_ms(events), {k: v for k, v in by_kernel.items() if v}, dict(top),
                len(events))

    def turn(model, propagate, clip, serve):
        seg = VideoSegmenter(model, K, propagate=propagate)
        push = push_frames if serve == "frame" else push_group
        for g in range(2):  # warm-up; an incremental group then has a key
            push(seg, clip[:, g * K:(g + 1) * K])
        return profiled(lambda: push(seg, clip[:, 2 * K:]))

    def emit(**row):
        host_ms, device_ms = row["host_ms"], row["device_ms"]
        print(json.dumps(dict(tree=args.tree or ".", **row, idle_share=1 - device_ms / host_ms)),
              flush=True)

    # each row: its models, key -> (net, use_kernels), and its paths,
    # label -> (model, serving protocol)
    kernel_vs_plain = {"kernels": ("kernels", "group"), "plain": ("plain", "group")}

    def kernels_and_plain(net):
        return {"kernels": (net, True), "plain": (net, False)}

    configs = (("accel18", kernels_and_plain(cs.BENCH_NET), ("incremental", "direct"),
                kernel_vs_plain),
               ("dff", kernels_and_plain(cs.DFF_NET), ("incremental", "direct"), kernel_vs_plain),
               ("deeplab101 pallas", kernels_and_plain(dict(cs.DEEPLAB_NET, dilated_conv="pallas")),
                ("direct",), kernel_vs_plain),
               ("accel18 per frame", kernels_and_plain(cs.BENCH_NET), ("incremental", "direct"),
                {"push_frame": ("kernels", "frame"), "push_group": ("kernels", "group")}),
               )
    # a tree from before int8 and the folds has neither row
    if hasattr(cs, "INT8_NET"):
        configs += (
            ("accel18 int8 vs bf16", {"int8": (cs.INT8_NET, True), "bf16": (cs.BENCH_NET, True)},
             ("incremental", "direct"), {"int8": ("int8", "group"), "bf16": ("bf16", "group")}),
            ("accel18_fast conv7 fold vs resize",
             {"fold": (cs.FOLD_NET, True), "resize": (dict(cs.FAST_NET, stem="conv7"), True)},
             ("incremental", "direct"), {"fold": ("fold", "group"), "resize": ("resize", "group")}))
    for name, nets, propagates, paths in configs:
        built, clip = models(nets, cs.SEED + 6, paths)
        labels = list(paths)
        for propagate in propagates:
            for i in range(args.repeat):
                for path in (labels if i % 2 == 0 else labels[::-1]):
                    model, serve = paths[path]
                    host_ms, device_ms, by_kernel, top, n = turn(built[model], propagate, clip,
                                                                 serve)
                    emit(config=name, propagate=propagate, path=path, turn=i, host_ms=host_ms,
                         device_ms=device_ms, device_events=n, kernels_ms=by_kernel, top_ms=top)
        del built
        torch.cuda.empty_cache()

    # a tree from before the serving export has no such row
    if hasattr(cs, "e2e_export"):
        from accel_tpu_torch.core.export import export_serving, load_serving

        for name, net in (("accel18 exported", cs.BENCH_NET), ("dff exported", cs.DFF_NET)):
            built, clip = models({"kernels": (net, True)}, cs.SEED + 6,
                                 {"push_group": ("kernels", "group")})
            model, frames = built["kernels"], clip[:, 2 * K:]
            serve = load_serving(export_serving(model, None, hw, K, "direct", batch=1))
            seg = VideoSegmenter(model, K, propagate="direct")
            runs = {"loaded": lambda: serve(frames), "push_group": lambda: seg.push_group(frames)}
            for run in (*runs.values(), *runs.values()):  # warm-up
                run()
            for i in range(args.repeat):
                for path in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
                    host_ms, device_ms, by_kernel, top, n = profiled(runs[path])
                    emit(config=name, propagate="direct", path=path, turn=i, host_ms=host_ms,
                         device_ms=device_ms, device_events=n, kernels_ms=by_kernel, top_ms=top)
            del built, serve, seg, runs
            torch.cuda.empty_cache()

    if hasattr(cs, "INT8_NET"):
        int8_split(cs, hw)
        fold_split(cs, hw)

    # training: one step of each train cfg, kernel path against plain path
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for cfg_name in ("accel18_cityscapes", "accel18_cityscapes_pair"):
        cfg = load_config(os.path.join(os.path.dirname(os.path.abspath(__file__)), "experiments",
                                       "cfgs", f"{cfg_name}.yaml"))
        tr = cfg.TRAIN
        B, crop, k = int(tr.BATCH_IMAGES), tuple(tr.CROP_SIZE), int(tr.CLIP_LENGTH)
        clip = cs.moving_clip(k, crop, cs.SEED + 70, "cuda").expand(B, -1, -1, -1, -1)
        clip = clip.permute(0, 1, 4, 2, 3).contiguous()
        label = torch.full((B, k, *crop), 255, dtype=torch.int32, device="cuda")
        for b in range(B):
            label[b, b % k] = torch.randint(0, 19, crop, generator=g, device="cuda")
        if tr.objective == "clip":
            batch = {"clip": clip, "label": label}
        else:
            batch = {"data": clip[:, -1], "data_ref": clip[:, 0], "label": label[:, 0],
                     "eq_flag": torch.zeros(B, device="cuda")}
        states = {}
        for path in ("kernels", "plain"):
            m = build_model(cfg, device="cuda", use_kernels=path == "kernels",
                            generator=torch.Generator().manual_seed(cs.SEED))
            if path == "kernels":
                cs.live_flow_heads(m, clip.permute(0, 1, 3, 4, 2), cs.SEED + 71)
            else:
                m.load_state_dict(states["kernels"][0].model.state_dict())
            tx, _ = make_optimizer(cfg, 1, m)
            states[path] = (init_train_state(m, tx), make_train_step(
                tx, int(cfg.dataset.NUM_CLASSES), ohem_fraction=float(tr.ohem_fraction) or None,
                aux_weight=float(tr.aux_loss_weight), objective=str(tr.objective),
                propagate=str(cfg.network.propagate), remat=bool(tr.remat)))
        for i in range(args.repeat):
            for path in (("kernels", "plain") if i % 2 == 0 else ("plain", "kernels")):
                state, step = states[path]
                for _ in range(2):
                    step(state, batch)
                host_ms, device_ms, by_kernel, top, n = profiled(lambda: step(state, batch))
                emit(config=f"{cfg_name} train step", propagate=str(cfg.network.propagate),
                     path=path, turn=i, host_ms=host_ms, device_ms=device_ms,
                     device_events=n, kernels_ms=by_kernel, top_ms=top)
        del states
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
