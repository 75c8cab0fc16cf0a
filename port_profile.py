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
events by name (summed per name). The profiler's own host overhead is
inside host ms. The card's name and power limit come last.
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
    from accel_tpu_torch.core.serving import VideoSegmenter
    from accel_tpu_torch.models.accel import build_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    K, hw = cs.K, (cs.H, cs.W)

    def models(net, seed_clip, paths):
        clip = cs.moving_clip(3 * K, hw, seed_clip, "cuda")
        out = {}
        for path in ("kernels", "plain"):
            if path not in {model for model, _ in paths.values()}:
                continue
            m = build_model(net, device="cuda", use_kernels=path == "kernels",
                            generator=torch.Generator().manual_seed(cs.SEED))
            if hasattr(m, "flownet"):
                if path == "kernels":
                    cs.live_flow_heads(m, clip, cs.SEED + 7)
                else:
                    m.load_state_dict(out["kernels"].state_dict())
            out[path] = m
        return out, clip

    def push_group(seg, frames):
        seg.push_group(frames)

    def push_frames(seg, frames):
        for i in range(frames.shape[1]):
            seg.push_frame(frames[:, i])
            torch.cuda.synchronize()

    def turn(model, propagate, clip, serve):
        seg = VideoSegmenter(model, K, propagate=propagate)
        push = push_frames if serve == "frame" else push_group
        for g in range(2):  # warm-up; an incremental group then has a key
            push(seg, clip[:, g * K:(g + 1) * K])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            push(seg, clip[:, 2 * K:])
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
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        return (host_ms, busy_ms(events), {k: v for k, v in by_kernel.items() if v},
                {name[:80]: ms for name, ms in top})

    # each row: its paths, label -> (model, serving protocol)
    kernel_vs_plain = {"kernels": ("kernels", "group"), "plain": ("plain", "group")}
    configs = (("accel18", cs.BENCH_NET, ("incremental", "direct"), kernel_vs_plain),
               ("dff", cs.DFF_NET, ("incremental", "direct"), kernel_vs_plain),
               ("deeplab101 pallas", dict(cs.DEEPLAB_NET, dilated_conv="pallas"), ("direct",),
                kernel_vs_plain),
               ("accel18 per frame", cs.BENCH_NET, ("incremental", "direct"),
                {"push_frame": ("kernels", "frame"), "push_group": ("kernels", "group")}))
    for name, net, propagates, paths in configs:
        built, clip = models(net, cs.SEED + 6, paths)
        labels = list(paths)
        for propagate in propagates:
            for i in range(args.repeat):
                for path in (labels if i % 2 == 0 else labels[::-1]):
                    model, serve = paths[path]
                    host_ms, device_ms, by_kernel, top = turn(built[model], propagate, clip, serve)
                    print(json.dumps(dict(tree=args.tree or ".", config=name, propagate=propagate,
                                          path=path, turn=i, host_ms=host_ms, device_ms=device_ms,
                                          idle_share=1 - device_ms / host_ms,
                                          kernels_ms=by_kernel, top_ms=top)), flush=True)
        del built
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
