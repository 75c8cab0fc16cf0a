#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``accel_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. build: compile the CUDA kernels from ``accel_tpu_torch/kernels/*.cu``.
2. kernel: first the launch floor (a 1-element ``fill_``); then each
   kernel against its plain PyTorch version on the card, at the shapes the
   main path launches it with, with the max error (or the class-map
   agreement and the logit margins at disagreements), the times of the
   kernel, its plain version and the one PyTorch call that computes the
   same function where there is one (``library_*``, a yardstick the port
   never calls), and the least time the card could take for the row
   (``bound_ms``: bytes at the HBM rate or operations at the peak rate).
   ``ms`` is a median CUDA-event time of one call that includes the
   wrapper's host work; ``device_ms`` the device's time per call in a run
   of back-to-back calls queued behind a spin kernel, and ``host_ms`` the
   host's time to enqueue one (``device_ms``). A launch-sized kernel is
   read by ``device_ms`` against the launch floor.
3. small_reference: a tiny f32 Accel model on the card (kernels) against
   the same model on the CPU (plain versions): logits and class maps.
4. e2e: Accel-18 (R101 keyframe branch, R18 update branch, FlowNet-S at
   full width, frozenbn + fused7 stem, bf16) at 1024x2048, B=1, k=5,
   through ``VideoSegmenter.push_group``: three incremental + 'last'
   groups and one direct group, with every kernel launch counted; then the
   same groups with every kernel replaced by its plain version, and the
   two compared as two bf16 paths are (``compare_paths``: logits, and class
   maps overall and off bf16 near-ties); then the plain path with only the
   stem through its kernel, whose class maps the kernel path must match on
   >= 0.999 of the pixels.
5. e2e_flagship: one incremental + 'last' group with the flagship cfg's
   groupnorm + conv7 stem + scale_field_norm mean1.
6. e2e_dff: the bench's DFF row (R101 keyframe fc6 features warped by the
   one-hot warp with the scale field fused in, D=4, native dtype, FlowNet
   at 1/4 input and half width) at 1024x2048, B=1, k=5: two direct groups
   and one incremental + 'last' group, kernels and plain versions, held as
   in phase 4; the one-hot warp launches exactly once per direct group and
   k-1 times per incremental group.
7. e2e_dff_fc6: one direct group of that model with fc6 through the
   dilated kernel (``dilated_conv: pallas_fc6``) against cuDNN's fc6.
8. e2e_deeplab: the per-frame DeepLab-101 baseline on 5 frames with every
   dilated conv through the dilated kernel (``pallas``) against cuDNN
   (``auto``), in bf16 and, for the class-map check, in f32.
9. e2e_stream, e2e_dff_stream: per-frame serving of Accel-18 and of the
   DFF row through ``VideoSegmenter.push_frame``, one direct and one
   incremental + 'last' group each, with the exact launches (Accel: both
   stems on the key frame, the update stem and a warp on each other frame,
   a tail on every frame; DFF: one stem, one one-hot warp per non-key
   frame, a tail per frame), their class maps held against ``push_group``
   on the same frames, of the kernel model and of the plain model
   (``compare_class_maps``), then both protocols timed on the host clock
   in alternating turns.
10. e2e_fast, e2e_os8mixed: one direct group of the bench's accel18_fast
    and accel18_os8mixed models through ``clip_predictions``, kernels
    against plain as in phase 4, with the exact launches.
11. e2e_composed, e2e_dff_composed: one ``propagate: composed`` group of
    Accel-18 and of the DFF row, held the same way (the flow fields warped
    at D, the features once at D*(k-1)).

12. e2e_eval, e2e_eval_dff: video eval from a cfg file. A Cityscapes-layout
    tree at 1024x2048 is written to a temporary directory (2 annotated
    snippets, frames ANNOTATED_FRAME-4 .. ANNOTATED_FRAME of a panning
    scene, labelIds PNGs, by this script's own PNG writer); the flagship
    cfg (``experiments/cfgs/accel18_cityscapes.yaml``: groupnorm, conv7,
    mean1, incremental + last) and the DFF cfg (``dff_cityscapes.yaml``,
    whose ``serving_network`` picks the one-hot warp, native, D=4) are
    overlaid with the tree's paths and run through the port's eval entry
    point, ``accel_tpu_torch.experiments.test.main(... --random-weights
    --max-items 2)``, with the exact launches per clip (flagship: 4 warps
    and 1 tail; DFF: 1 one-hot warp and 1 tail). Then the kernel model and
    the plain model of the same cfg and seed, with live flow heads, through
    ``pred_eval_clips`` on the same batches: mIoU within 1 point and
    confusion matrices within an L1 of 2*(1-0.99) of the valid pixels
    (0.98 for DFF), the overall class-map limits of ``compare_paths``.

13. grad_warp, grad_dilated_conv, grad_fused_stem, grad_warp_onehot: each
    kernel's ``torch.autograd.Function`` on the card, at the training
    path's shapes, its gradients against autograd through the plain
    version (max error and cosine per input; the warp's flow up to 2 D, so
    the clamp is active). #5's dx, on the kernel with the rotated weights,
    at every shape of the training path (``TRAIN_DILATED``), is also timed
    as the kernel rows are (``dilated_conv_dx``), against
    ``torch.nn.grad.conv2d_input`` (cuDNN).
14. e2e_train, e2e_train_pair, e2e_train_dilated: training from a cfg
    file. A Cityscapes-layout train split at 1024x2048 (TRAIN_SNIPPETS
    annotated snippets, frames ANNOTATED_FRAME-4 .. +4) and a val split are
    written; the flagship cfg (clip objective, R101 + R18, groupnorm,
    conv7, bf16, B=2 x 5 frames, 768x768 crops, remat, aux 0.5), the pair
    cfg (B=4, direct) and the flagship cfg with ``--set-network
    dilated_conv=pallas`` train one epoch through the port's train entry
    point, with the exact launches per step (flagship: 4 warps and the 4
    recomputed under remat; pair: 1 warp; pallas: also 38 forward and 29
    recomputed dilated convs and 38 dx convs) and finite losses; the
    checkpoint is evaluated by the eval entry point (``--max-items 1``);
    then from the checkpoint's weights, with live flow heads, one step's
    loss and gradients with the kernels and with the plain versions on
    one batch, in f32 and in the cfg's bf16: the loss within 1e-3
    relative and every parameter's gradient at cosine >= 0.999; for
    ``pallas`` in bf16, every gradient at ``BF16_DILATED_COSINE``, both
    the kernel step's and those of the plain step with its convs exactly
    rounded (the bf16 rounding floor), and the dx launches at shapes
    ``grad_dilated_conv`` held. Then the bf16 median step times of the
    kernel and plain steps, alternating (CUDA events, first step out),
    and the kernel step's peak memory with one model alive.
15. e2e_quant: bench.py's --quantize Accel-18 (both branches' block convs
    and fc6 through the int8 conv: an int8 im2col and cuBLAS's int8 GEMM;
    the fused7 stem stays float) at 1024x2048 through ``VideoSegmenter``:
    an incremental and a direct group at B=1, a direct group at B=4 and an
    incremental group through ``push_frame``, with the exact launches of
    #1-#3 (no #5: int8 takes precedence) and the exact number of int8
    GEMMs; its class maps against the plain model's (plain kernels and the
    exact float64 int8 product), overall and off near-ties, within
    ``QUANT_OVERALL``/``QUANT_CLEAR``, and against the plain model with
    the stem kernel's output on >= 0.999; the int8 and bf16 models'
    agreement and host times printed.
16. e2e_fold_direct, e2e_fold_incremental: accel18_fast with
    ``fold_update_downscale`` and ``fold_flow_downscale`` (conv7 stem),
    held as in phase 10, with the exact launches (no stem kernel).
17. e2e_train_bn: a full ResNet-101 ``.params`` with the reference's
    Caffe names and random values is written, and the pair cfg with
    ``norm: batchnorm`` trains from it through the train entry point (2
    steps, 1 warp each; every backbone tensor merged; the running
    statistics moved); then one pair step from the checkpoint with the
    kernels and with the plain versions: the loss within 1e-3, every
    gradient at cosine >= 0.999, every running statistic within 1e-3.

Then the ``{"kernels": [...]}`` line (each kernel's first row, with its
launches on one path it serves and per group there, and its launches on
every path above; #5 also its dx launches on the training paths), the card's name and
power limit from nvidia-smi, and, last, ``{"ok": true, "device": {...}}``.
Any failed check raises, so the script exits non-zero and prints no result
line. Without a CUDA device it exits with code 2. Weights are random, drawn
from a seed; the flow heads are re-drawn so the flow moves content (at init
it is 0).
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import math
import re
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import torch
import torch.nn.functional as F

from accel_tpu_torch import kernels
from accel_tpu_torch.config import load_config
from accel_tpu_torch.core.checkpoint import load_checkpoint
from accel_tpu_torch.core.pipeline import (
    clip_logits,
    clip_loss_and_stats,
    clip_predictions,
    pair_loss_and_stats,
)
from accel_tpu_torch.core.predictor import pred_eval_clips
from accel_tpu_torch.core.pretrained import apply_pretrained_cfg, caffe_resnet_table
from accel_tpu_torch.core.serving import VideoSegmenter
from accel_tpu_torch.core.trainer import init_train_state, make_optimizer, make_train_step
from accel_tpu_torch.data.cityscapes import ANNOTATED_FRAME, Cityscape
from accel_tpu_torch.data.image import transform
from accel_tpu_torch.data.loader import TestClipLoader, TrainClipLoader, TrainPairLoader
from accel_tpu_torch.data.prefetch import to_device
from accel_tpu_torch.experiments import test as eval_entry
from accel_tpu_torch.experiments import train as train_entry
from accel_tpu_torch.models.accel import build_model
from accel_tpu_torch.models.resnet import BatchNorm, DilatedResNet
from accel_tpu_torch.ops import dilated_cuda as dilated_ops
from accel_tpu_torch.ops import fused_stem as stem_ops
from accel_tpu_torch.ops import quant as quant_ops
from accel_tpu_torch.ops import upsample_argmax as ua_ops
from accel_tpu_torch.ops import warp_cuda as warp_ops
from accel_tpu_torch.ops import warp_onehot as onehot_ops

SEED = 0
H, W = 1024, 2048
K = 5
BENCH_NET = dict(ref_depth=101, update_depth=18, feat_stride=16, head_channels=1024,
                 head_dilation=6, norm="frozenbn", stem="fused7", dtype="bfloat16",
                 use_pallas_warp=True, warp_max_disp=8, warp_dtype="f32",
                 warp_gather="taps", scale_field_norm="none", scale_cascade="last",
                 flow_width_mult=1.0)
FLAGSHIP_NET = dict(BENCH_NET, norm="groupnorm", stem="conv7", scale_field_norm="mean1")
# bench.py's accel18_fast row (:493-501): the update branch on half-resolution
# frames with a 256-wide fc6, FlowNet at 1/4 input and half width
FAST_NET = dict(BENCH_NET, update_head_channels=256, update_input_downscale=2,
                flow_input_downscale=4, flow_width_mult=0.5)
# bench.py's --quantize Accel-18 (:74-98): both branches' block convs and fc6 in
# int8, the fused7 stem kept float
INT8_NET = dict(BENCH_NET, quantize_ref=True, quantize_update=True)
# accel18_fast with both downscales folded into the first convs; the fold
# needs the conv7 stem (one knob for both branches, so no stem kernel here)
FOLD_NET = dict(FAST_NET, stem="conv7", fold_update_downscale=True, fold_flow_downscale=True)
# bench.py's accel18_os8mixed row (:518-525): the reference branch at stride 8,
# the update branch at stride 16
OS8MIXED_NET = dict(BENCH_NET, feat_stride=8, update_feat_stride=16)
# bench.py's dff row: R101 keyframe branch, fc6 features warped forward
DFF_NET = dict(name="dff", ref_depth=101, feat_stride=16, head_channels=1024, head_dilation=6,
               norm="frozenbn", stem="fused7", dtype="bfloat16", use_pallas_warp=True,
               warp_max_disp=4, warp_dtype="native", warp_gather="onehot",
               flow_input_downscale=4, flow_width_mult=0.5)
# bench.py's baseline row: per-frame DeepLab-101
DEEPLAB_NET = dict(name="deeplab", ref_depth=101, feat_stride=16, head_channels=1024,
                   head_dilation=6, norm="frozenbn", stem="fused7", dtype="bfloat16")
LAUNCHERS = {
    "warp": warp_ops.warp_cuda,
    "upsample_argmax": ua_ops.upsample_argmax_cuda,
    "fused_stem": stem_ops.fused_stem_cuda,
    "warp_onehot": onehot_ops.warp_onehot_cuda,
    "dilated_conv": dilated_ops.conv3x3_dilated_cuda,
}
REPLACES = {
    "warp": "accel_tpu/ops/warp_pallas.py:84",
    "upsample_argmax": "accel_tpu/ops/upsample_argmax.py:48",
    "fused_stem": "accel_tpu/ops/fused_stem.py:84",
    "warp_onehot": "accel_tpu/ops/warp_onehot.py:117",
    "dilated_conv": "accel_tpu/ops/dilated_pallas.py:96",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def median_ms(fn, iters: int = 10) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` calls, after 2
    warm-ups. The first event is recorded on an idle stream, so the time
    includes the host's work in ``fn`` up to the launch (for a kernel, its
    Python wrapper)."""
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


@functools.cache
def spin_cycles_per_ms() -> float:
    """Clock cycles per ms of ``torch.cuda._sleep``'s spin kernel."""
    torch.cuda._sleep(1000)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10_000_000)
    b.record()
    b.synchronize()
    return 10_000_000 / a.elapsed_time(b)


def device_ms(fn, launches: int = 50, turns: int = 3) -> dict:
    """Device and host time per call of ``fn``, the median of ``turns``
    runs of ``launches`` back-to-back calls. Before each run a spin kernel
    keeps the card busy for twice the host's enqueue time of the previous
    run, so every call is queued before the first event starts the clock:
    ``device_ms`` is the device's time per call with the host's work kept
    out (back to back, so a launch-sized kernel reads as the launch
    interval), ``host_ms`` the host's time to enqueue one call."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    dev, host = [], []
    spin_ms = 2e3 * host_s + 1.0
    while len(dev) < turns:
        torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        host_s = time.perf_counter() - t0
        b.record()
        b.synchronize()
        if host_s * 1e3 >= spin_ms:
            # the host stalled (its CPU is shared) and the card ran dry
            # before every call was queued: that run does not count
            check(spin_ms < 1e3, f"enqueue of {launches} calls took {host_s * 1e3} ms")
            spin_ms = 2e3 * host_s + 1.0
            continue
        dev.append(a.elapsed_time(b) / launches)
        host.append(host_s * 1e3 / launches)
    return dict(device_ms=statistics.median(dev), host_ms=statistics.median(host))


def launch_floor() -> dict:
    """The floor a launch-sized kernel is read against: a 1-element
    ``fill_``, timed as ``device_ms`` times a kernel."""
    z = torch.empty(1, device="cuda")
    row = dict(phase="launch_floor", op="torch.empty(1).fill_(0)",
               ms=median_ms(lambda: z.fill_(0)), **device_ms(lambda: z.fill_(0)))
    emit(row)
    return row


def timed(fn, library=None) -> dict:
    """A kernel row's times: ``ms`` (host-inclusive, ``median_ms``),
    ``device_ms`` and ``host_ms`` (``device_ms``); with ``library``, the
    same for the library call."""
    out = dict(ms=median_ms(fn), **device_ms(fn))
    if library is not None:
        lib = device_ms(library)
        out.update(library_ms=median_ms(library), library_device_ms=lib["device_ms"],
                   library_host_ms=lib["host_ms"])
    return out


# the card's peaks (H100 SXM data sheet, dense): HBM bytes and operations per ms
HBM_BYTES_PER_MS = 3.35e9
PEAK_OPS_PER_MS = {"bf16": 989e9, "f32": 67e9}


def bound(n_bytes: float, ops: float, kind: str) -> dict:
    """The least time the card could take: each input byte read once and
    each output byte written once at the HBM rate, or ``ops`` at the peak
    rate of ``kind`` ('bf16' tensor cores, 'f32' CUDA cores), whichever is
    longer."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_MS, ops / PEAK_OPS_PER_MS[kind]
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=n_bytes, bound_ops=ops, bound_ops_kind=kind)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def sample_grid(flow: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``F.grid_sample``'s grid (align_corners=True) for pixel flow
    (N,2,h,w) = (dx, dy): the library yardstick of the warps."""
    _, _, h, w = flow.shape
    ys = torch.arange(h, device=flow.device, dtype=torch.float32).view(1, h, 1)
    xs = torch.arange(w, device=flow.device, dtype=torch.float32).view(1, 1, w)
    gx = 2 * (xs + flow[:, 0].float()) / (w - 1) - 1
    gy = 2 * (ys + flow[:, 1].float()) / (h - 1) - 1
    return torch.stack([gx, gy], dim=-1).to(dtype)


def reset_counts() -> None:
    for fn in LAUNCHERS.values():
        fn.launches = 0
    dilated_ops.conv3x3_dilated_cuda.backward_launches = 0


def counts() -> dict[str, int]:
    """Each kernel's launches, and #5's dx launches in the backward
    (``dilated_conv_dx``)."""
    out = {name: fn.launches for name, fn in LAUNCHERS.items()}
    out["dilated_conv_dx"] = dilated_ops.conv3x3_dilated_cuda.backward_launches
    return out


# ---- phase 2: each kernel against its plain version ------------------------


def _gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cuda").manual_seed(seed)


def kernel_warp(results: dict) -> None:
    """Accel-18's score-map warp at the shapes it launches: (1,19,64,128)
    f32 four times per incremental + 'last' group (one frame a step) and
    once per non-key frame of ``push_frame``, (4,19,64,128) once per direct
    group (k-1 frames at once), that shape in bf16 (``warp_dtype:
    native``), CamVid's ragged stride-16 map, os8-mixed's stride-8 map
    ((1,19,128,256) per frame, (4,...) per direct group), and composed
    propagation's final warp at D=8*(k-1)=32 and its 2-channel flow fields
    at D=8. |flow| up to 1.5 D, uniform per pixel."""
    rows = []
    for shape, dtype, d in (((1, 19, 64, 128), torch.float32, 8),
                            ((4, 19, 64, 128), torch.float32, 8),
                            ((4, 19, 64, 128), torch.bfloat16, 8),
                            ((1, 19, 45, 60), torch.float32, 8),
                            ((1, 19, 128, 256), torch.float32, 8),
                            ((4, 19, 128, 256), torch.float32, 8),
                            ((4, 19, 64, 128), torch.float32, 8 * (K - 1)),
                            ((1, 2, 64, 128), torch.float32, 8)):
        g = _gen(SEED + 1)
        N, _, h, w = shape
        max_flow = 1.5 * d
        feat = torch.randn(shape, generator=g, device="cuda").to(dtype)
        flow = (torch.rand((N, 2, h, w), generator=g, device="cuda") * 2 - 1) * max_flow
        got = warp_ops.warp_cuda(feat, flow, d)
        ref = warp_ops.warp_plain(feat, flow, d)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = 1e-5 if dtype == torch.float32 else 1e-2 * ref.float().abs().max().item()
        check(got.dtype == dtype and got.shape == ref.shape and err <= tol,
              f"warp {shape} {dtype} D={d}: max err {err} > {tol}")
        grid = sample_grid(flow.clamp(-d, d), dtype)
        # four taps (4 multiplies, 3 adds) per output element, in f32
        row = dict(kernel="warp", dtype=str(dtype), shape=list(shape), max_abs_flow=max_flow,
                   max_disp=d, max_abs_err=err, tol=tol,
                   **timed(lambda: warp_ops.warp_cuda(feat, flow, d),
                           lambda: F.grid_sample(feat, grid, align_corners=True,
                                                 padding_mode="zeros")),
                   plain_ms=median_ms(lambda: warp_ops.warp_plain(feat, flow, d)),
                   library_call="F.grid_sample(bilinear, zeros, align_corners=True) on the "
                                "clamped flow's grid",
                   **bound(nbytes(feat, flow, got), 7 * got.numel(), "f32"))
        emit(dict(phase="kernel", **row))
        rows.append(row)
    results["warp"] = rows[0]


def upsample_argmax_ops(shape: tuple, out_hw: tuple) -> int:
    """The operations a separable bilinear resize + argmax needs: per class,
    a row pass (one lerp, an FMA = 2 operations, per input row and output
    column), a column pass (one lerp per output pixel) and a compare per
    output pixel."""
    N, C, h, _ = shape
    return N * C * (2 * h * out_hw[1] + 3 * out_hw[0] * out_hw[1])


def kernel_upsample_argmax(results: dict) -> None:
    """The serving tail at the shapes it launches: one group's 5 frames at
    B=1 (once per group), the bench's B=4 group of 20, one frame (once per
    ``push_frame``), os8-mixed's stride-8 group, CamVid's 45x60 ->
    720x960, and a non-integer ratio whose bands change inside a thread's
    run of rows. Each row's class map agrees with the plain version's on
    >= 0.9999 of the pixels, every disagreement at a near-tie."""
    rows = []
    for shape, out_hw in (((5, 19, 64, 128), (H, W)), ((20, 19, 64, 128), (H, W)),
                          ((1, 19, 64, 128), (H, W)), ((5, 19, 128, 256), (H, W)),
                          ((2, 19, 45, 60), (720, 960)), ((3, 11, 12, 20), (128, 256))):
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
                   **timed(lambda: ua_ops.upsample_argmax_cuda(logits, out_hw)),
                   plain_ms=median_ms(lambda: ua_ops.upsample_argmax_plain(logits, out_hw)),
                   library_call=None, library_ms=None, library_device_ms=None,
                   **bound(nbytes(logits, got), upsample_argmax_ops(shape, out_hw), "f32"))
        del up, gap
        emit(dict(phase="kernel", **row))
        rows.append(row)
    results["upsample_argmax"] = rows[0]


def kernel_fused_stem(results: dict) -> None:
    """bf16 (the tensor-core kernel; f32 weights, rounded to bf16 by both
    sides; (1,3,30,34) takes its unaligned loads and stores) and f32 (the
    CUDA-core kernel): within 2e-2 * max|ref| (bf16) or 1e-4 * max|ref|
    (f32) of the plain version, and in bf16 at most 0.1% of the outputs
    other than the plain version's. ``ms`` times
    the kernel on weights packed beforehand (as the model keeps them),
    ``pack_ms`` the packing. The library yardstick is cuDNN's conv with inv
    folded into the weights and shift as the bias, without the relu. The
    bf16 rows: the bench's B=4 keyframes, one frame (every keyframe at B=1
    and every ``push_frame``), the fast row's update branch on a group's 5
    half-resolution frames, CamVid's frame and an unaligned one."""
    rows = []
    for shape, dtype in (((4, 3, H, W), torch.bfloat16), ((1, 3, H, W), torch.bfloat16),
                         ((5, 3, H // 2, W // 2), torch.bfloat16),
                         ((1, 3, 720, 960), torch.bfloat16),
                         ((1, 3, 30, 34), torch.bfloat16), ((1, 3, H, W), torch.float32)):
        g = _gen(SEED + 3)
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        w = torch.randn((64, 3, 7, 7), generator=g, device="cuda") * 0.1
        inv = torch.rand((64,), generator=g, device="cuda") + 0.5
        shift = torch.randn((64,), generator=g, device="cuda") * 0.1
        packed = stem_ops.stem_kernel_weight(w, dtype)
        got = stem_ops.fused_stem_cuda(x, w, inv, shift, packed)
        ref = stem_ops.fused_stem_plain(x, w, inv, shift)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = (2e-2 if dtype == torch.bfloat16 else 1e-4) * ref.float().abs().max().item()
        differ = (got != ref).float().mean().item()
        check(got.dtype == dtype and got.shape == ref.shape and err <= tol,
              f"fused_stem {shape} {dtype}: max err {err} > {tol}")
        # the sums differ from the plain version's only in their f32 order: a
        # bf16 output rounds otherwise only where it lies next to a midpoint
        check(dtype != torch.bfloat16 or differ <= 1e-3,
              f"fused_stem {shape} {dtype}: {differ} of outputs differ")
        w_lib = (w * inv.view(-1, 1, 1, 1)).to(dtype)
        b_lib = shift.to(dtype)
        row = dict(kernel="fused_stem", dtype=str(dtype), shape=list(shape), max_abs_err=err,
                   tol=tol, differ_share=differ,
                   **timed(lambda: stem_ops.fused_stem_cuda(x, w, inv, shift, packed),
                           lambda: F.conv2d(x, w_lib, b_lib, stride=2, padding=3)),
                   pack_ms=median_ms(lambda: stem_ops.stem_kernel_weight(w, dtype)),
                   plain_ms=median_ms(lambda: stem_ops.fused_stem_plain(x, w, inv, shift)),
                   library_call="F.conv2d(stride 2, pad 3) with inv folded into the weights, "
                                "shift as bias; no relu",
                   **bound(nbytes(x, got) + 64 * 147 * x.element_size(),
                           2 * 147 * got.numel(), "bf16" if dtype == torch.bfloat16 else "f32"))
        emit(dict(phase="kernel", **row))
        rows.append(row)
    results["fused_stem"] = rows[0]


def kernel_warp_onehot(results: dict) -> None:
    """DFF's feature warp at the shapes it launches: (4,1024,64,128) bf16
    with the scale fused, once per direct group (k-1 frames at once),
    (1,1024,64,128) bf16 without a scale, four times per incremental +
    'last' group, and with the scale, once per non-key frame of a direct
    ``push_frame`` stream; then f32 features, a gain, and CamVid's 45x60
    map (staged without TMA); then composed propagation's final feature
    warp at D=4*(k-1)=16 and the f32 fields it composes at D=4 (the
    2-channel flow, and the 1024-channel scale product of the mean1/clamp
    cascades). |flow_y| up to 1.5 D (clamped), |flow_x| up to 3 D (not
    clamped), uniform per pixel; the bf16 DFF rows also time a smooth flow
    of that range (``smooth_flow_device_ms``). At most 1e-5 * max|ref| for
    f32 outputs, one bf16 ulp at max|ref| for bf16 outputs."""
    rows = []
    for shape, dtype, with_scale, with_gain, d in (
            ((4, 1024, 64, 128), torch.bfloat16, True, False, 4),
            ((1, 1024, 64, 128), torch.bfloat16, False, False, 4),
            ((1, 1024, 64, 128), torch.bfloat16, True, False, 4),
            ((4, 1024, 64, 128), torch.float32, False, False, 4),
            ((4, 1024, 64, 128), torch.bfloat16, True, True, 4),
            ((2, 1024, 45, 60), torch.bfloat16, True, False, 4),
            ((4, 1024, 64, 128), torch.bfloat16, True, False, 4 * (K - 1)),
            ((1, 2, 64, 128), torch.float32, False, False, 4),
            ((1, 1024, 64, 128), torch.float32, False, False, 4)):
        g = _gen(SEED + 10)
        N, C, h, w = shape
        fx, fy = 3.0 * d, 1.5 * d
        feat = torch.randn(shape, generator=g, device="cuda").to(dtype)
        flow = torch.rand((N, 2, h, w), generator=g, device="cuda") * 2 - 1
        flow[:, 0] *= fx
        flow[:, 1] *= fy
        scale = (torch.rand(shape, generator=g, device="cuda") + 0.5).to(dtype) if with_scale else None
        gain = torch.rand((N,), generator=g, device="cuda") + 0.5 if with_gain else None
        args = (feat, flow, scale, d, gain)
        got = onehot_ops.warp_onehot_cuda(*args)
        ref = onehot_ops.warp_onehot_plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        peak = ref.float().abs().max().item()
        tol = 1e-5 * peak if dtype == torch.float32 else 2.0 ** (math.floor(math.log2(peak)) - 7)
        check(got.dtype == dtype and got.shape == ref.shape and err <= tol,
              f"warp_onehot {shape} {dtype} D={d}: max err {err} > {tol}")
        clamped = torch.stack([flow[:, 0], flow[:, 1].clamp(-d, d)], dim=1)
        grid = sample_grid(clamped, dtype)
        # four taps per output element, plus the scale and gain multiplies
        ops = (7 + int(with_scale) + int(with_gain)) * got.numel()
        p = onehot_ops.plan(N, C, h, w, float(d), feat.element_size(), True,
                            torch.cuda.get_device_properties(0).multi_processor_count)
        row = dict(kernel="warp_onehot", dtype=str(dtype), shape=list(shape), max_disp=d,
                   staging="tma" if p.tma else "cp.async", band_rows=p.rows, chunk=p.chunk,
                   stages=p.stages, grid=list(p.grid),
                   max_abs_flow_x=fx, max_abs_flow_y=fy, scale=with_scale, gain=with_gain,
                   max_abs_err=err, tol=tol,
                   **timed(lambda: onehot_ops.warp_onehot_cuda(*args),
                           lambda: F.grid_sample(feat, grid, align_corners=True,
                                                 padding_mode="zeros")),
                   plain_ms=median_ms(lambda: onehot_ops.warp_onehot_plain(*args)),
                   library_call="F.grid_sample(bilinear, zeros, align_corners=True) on the "
                                "clamped flow's grid; no scale or gain multiply",
                   **bound(nbytes(feat, flow, scale, gain, got), ops, "f32"))
        if shape[1:] == (1024, 64, 128) and dtype == torch.bfloat16:
            # the same call on a smooth flow of the same range (neighbouring
            # pixels move alike, as FlowNet's do): the taps of a warp then
            # fall on neighbouring window columns, not scattered ones
            coarse = torch.rand((N, 2, h // 16, w // 16), generator=g, device="cuda") * 2 - 1
            smooth = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
            smooth = smooth / smooth.abs().amax(dim=(2, 3), keepdim=True)
            smooth = smooth * torch.tensor([fx, fy], device="cuda").view(1, 2, 1, 1)
            s_args = (feat, smooth, scale, d, gain)
            s_err = (onehot_ops.warp_onehot_cuda(*s_args).float()
                     - onehot_ops.warp_onehot_plain(*s_args).float()).abs().max().item()
            check(s_err <= tol, f"warp_onehot {shape} D={d} smooth flow: max err {s_err} > {tol}")
            row.update(smooth_flow_max_abs_err=s_err, smooth_flow_device_ms=device_ms(
                lambda: onehot_ops.warp_onehot_cuda(*s_args))["device_ms"])
        emit(dict(phase="kernel", **row))
        rows.append(row)
    results["warp_onehot"] = rows[0]


def valid_taps(h: int, w: int, d: int) -> int:
    """Sum over output pixels of the taps that land inside the image: the
    products a 'same'-padded dilated 3x3 conv needs (the rest multiply
    padding zeros)."""
    return (sum(max(0, h - abs(i * d)) for i in (-1, 0, 1))
            * sum(max(0, w - abs(j * d)) for j in (-1, 0, 1)))


def kernel_dilated_conv(results: dict) -> None:
    """Dilated 3x3 conv against F.conv2d (cuDNN, TF32 off): 1e-4 relative
    for f32, 2e-2 * max|ref| for bf16. ``ms`` times the kernel with weights
    packed beforehand (as ``DilatedConv3x3`` keeps them) on an NCHW x, so
    it includes the bf16 path's channels-last copy of x; ``pack_ms`` is the
    packing alone, ``channels_last_ms`` the kernel on an x that is already
    channels-last. The plain version is the library call."""
    rows = []
    for shape, cout, d, dtype in (((1, 2048, 64, 128), 1024, 6, torch.bfloat16),  # fc6
                                  ((1, 512, 64, 128), 512, 2, torch.bfloat16),    # layer4 conv2
                                  ((1, 2048, 45, 60), 1024, 6, torch.bfloat16),   # not TPU-tileable
                                  ((1, 128, 16, 32), 128, 8, torch.float32)):
        g = _gen(SEED + 11)
        x = torch.randn(shape, generator=g, device="cuda").to(dtype)
        w = (torch.randn((cout, shape[1], 3, 3), generator=g, device="cuda")
             / math.sqrt(9 * shape[1])).to(dtype)
        packed = dilated_ops.pack_dilated_weight(w)
        got = dilated_ops.conv3x3_dilated_cuda(x, w, d, packed)
        ref = dilated_ops.conv3x3_dilated_plain(x, w, d)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        tol = (1e-4 if dtype == torch.float32 else 2e-2) * ref.float().abs().max().item()
        check(got.dtype == dtype and got.shape == ref.shape and err <= tol,
              f"dilated_conv {shape}->{cout} d={d} {dtype}: max err {err} > {tol}")
        x_cl = x.contiguous(memory_format=torch.channels_last)
        ops = 2 * shape[0] * shape[1] * cout * valid_taps(shape[2], shape[3], d)
        row = dict(kernel="dilated_conv", dtype=str(dtype), shape=list(shape), cout=cout,
                   dilation=d, max_abs_err=err, tol=tol,
                   **timed(lambda: dilated_ops.conv3x3_dilated_cuda(x, w, d, packed),
                           lambda: F.conv2d(x, w, padding=d, dilation=d)),
                   channels_last_ms=median_ms(
                       lambda: dilated_ops.conv3x3_dilated_cuda(x_cl, w, d, packed)),
                   pack_ms=median_ms(lambda: dilated_ops.pack_dilated_weight(w)),
                   plain_ms=median_ms(lambda: dilated_ops.conv3x3_dilated_plain(x, w, d)),
                   library_call="F.conv2d(padding=d, dilation=d) (cuDNN)",
                   nominal_ops=2 * shape[0] * shape[1] * cout * 9 * shape[2] * shape[3],
                   **bound(nbytes(x, w, got), ops, "bf16" if dtype == torch.bfloat16 else "f32"))
        row["tflops"] = ops / row["ms"] / 1e9
        emit(dict(phase="kernel", **row))
        rows.append(row)
    results["dilated_conv"] = rows[0]


# ---- phase 13: each kernel's gradients --------------------------------------------


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    """Cosine of two tensors in f64; 1.0 where both are zero."""
    a, b = a.double().flatten(), b.double().flatten()
    na, nb = a.norm().item(), b.norm().item()
    if na == 0.0 and nb == 0.0:
        return 1.0
    return (a @ b).item() / max(na * nb, 1e-300)


def grads_of(fn, inputs: tuple, grad_out: torch.Tensor, needs: tuple) -> list:
    """Gradients of ``fn(*inputs)`` for ``grad_out``, for each input whose
    ``needs`` is set (None for the others)."""
    leaves = [t.detach().clone().requires_grad_(n) for t, n in zip(inputs, needs)]
    fn(*leaves).backward(grad_out)
    return [t.grad if n else None for t, n in zip(leaves, needs)]


def compare_grads(phase: str, names: tuple, got: list, want: list, rel: float,
                  min_cos: float) -> dict:
    """Per input: max abs error against ``want``, its bound ``rel`` *
    max|want| and the cosine; raises if either is out of bounds."""
    out = {}
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        err = (g.float() - w.float()).abs().max().item()
        tol = rel * w.float().abs().max().item()
        cos = cosine(g, w)
        out[name] = dict(max_abs_err=err, tol=tol, cosine=cos)
        check(g.dtype == w.dtype and g.shape == w.shape and err <= tol and cos >= min_cos,
              f"{phase} d{name}: max err {err} (tol {tol}), cosine {cos}")
    return out


def grad_warp() -> None:
    """``WarpFunction`` at the training shapes: the flagship clip's
    (2,19,48,48) step warp and the pair's (4,19,48,48), f32, D=8, |flow| up
    to 2 D. The backward is autograd through the plain version on the saved
    inputs, so the two differ only by the order of the gather's
    scatter-adds: 1e-5 * max|ref|, cosine >= 0.99999."""
    for shape, d in (((2, 19, 48, 48), 8), ((4, 19, 48, 48), 8)):
        g = _gen(SEED + 50)
        N, _, h, w = shape
        feat = torch.randn(shape, generator=g, device="cuda")
        flow = (torch.rand((N, 2, h, w), generator=g, device="cuda") * 2 - 1) * 2 * d
        go = torch.randn(shape, generator=g, device="cuda")
        reset_counts()
        got = grads_of(lambda f, fl: warp_ops.warp(f, fl, d), (feat, flow), go, (True, True))
        launched = counts()
        want = grads_of(lambda f, fl: warp_ops.warp_plain(f, fl, d), (feat, flow), go,
                        (True, True))
        torch.cuda.synchronize()
        check(launched == launches_of(warp=1), f"grad_warp launches {launched}")
        emit(dict(phase="grad_warp", shape=list(shape), max_disp=d, max_abs_flow=2 * d,
                  clamped_share=(flow.abs() > d).float().mean().item(),
                  grads=compare_grads("grad_warp", ("feat", "flow"), got, want, 1e-5, 0.99999)))


# the dilated convs of the flagship's clip train step under
# dilated_conv=pallas, as (forward input shape, Cout, dilation): R101's fc6,
# R18's fc6, the 512 -> 512 layer4 convs of both branches and R18's first
# layer4 conv, 256 -> 512. e2e_train_dilated checks that its dx launches
# take no other shape.
TRAIN_DILATED = (((2, 2048, 48, 48), 1024, 6), ((2, 512, 48, 48), 1024, 6),
                 ((2, 512, 48, 48), 512, 2), ((2, 256, 48, 48), 512, 2))


def grad_dilated_conv(results: dict) -> None:
    """``DilatedConvFunction`` at every bf16 shape of the training path
    (``TRAIN_DILATED``); the dx conv of a forward (N,Cin,H,W) -> Cout takes
    (N,Cout,H,W) -> Cin. dx runs on the kernel with the rotated weights (one
    backward launch), dw on ``conv2d_weight``; against autograd through
    ``F.conv2d`` (cuDNN) at the forward rows' bf16 bound, 2e-2 * max|ref|,
    and cosine >= 0.999. Each dx conv is timed as a kernel row
    (``dilated_conv_dx``, R101's fc6 the first): the library call is
    ``torch.nn.grad.conv2d_input`` (cuDNN), the plain version ``F.conv2d``
    on the rotated weights."""
    rows = []
    for shape, cout, d in TRAIN_DILATED:
        g = _gen(SEED + 51)
        N, cin, h, w = shape
        x = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
        wt = (torch.randn((cout, cin, 3, 3), generator=g, device="cuda")
              / math.sqrt(9 * cin)).to(torch.bfloat16)
        go = torch.randn((N, cout, h, w), generator=g, device="cuda").to(torch.bfloat16)
        packed = dilated_ops.pack_dilated_weight(wt)
        packed_dx = dilated_ops.pack_dilated_weight_dx(wt)
        reset_counts()
        got = grads_of(lambda a, b: dilated_ops.conv3x3_dilated(
            a, b, d, packed=packed, packed_dx=lambda: packed_dx), (x, wt), go, (True, True))
        launched = counts()
        want = grads_of(lambda a, b: F.conv2d(a, b, padding=d, dilation=d), (x, wt), go,
                        (True, True))
        torch.cuda.synchronize()
        check(launched == launches_of(dilated_conv=1, dilated_conv_dx=1),
              f"grad_dilated_conv launches {launched}")
        grads = compare_grads("grad_dilated_conv", ("x", "w"), got, want, 2e-2, 0.999)
        dx = got[0]
        ops = 2 * N * cin * cout * valid_taps(h, w, d)
        row = dict(kernel="dilated_conv_dx", dtype=str(x.dtype), shape=list(go.shape), cout=cin,
                   dilation=d, forward_shape=list(shape), forward_cout=cout, grads=grads,
                   max_abs_err=grads["x"]["max_abs_err"],
                   **timed(lambda: dilated_ops.conv3x3_dilated_dx_cuda(go, wt, d, packed_dx),
                           lambda: torch.nn.grad.conv2d_input(shape, wt, go, padding=d,
                                                               dilation=d)),
                   pack_ms=median_ms(lambda: dilated_ops.pack_dilated_weight_dx(wt)),
                   plain_ms=median_ms(lambda: dilated_ops.conv3x3_dilated_dx_plain(go, wt, d)),
                   library_call="torch.nn.grad.conv2d_input(padding=d, dilation=d) (cuDNN)",
                   **bound(nbytes(go, wt, dx), ops, "bf16"))
        emit(dict(phase="grad_dilated_conv", **row))
        rows.append(row)
    results["dilated_conv_dx"] = rows[0]


def grad_fused_stem() -> None:
    """``FusedStemFunction`` on the training crop, (2,3,768,768) bf16
    (``norm: frozenbn, stem: fused7``): the gradients of the bf16 weights
    and the f32 inv and shift (the image needs none) against autograd
    through the plain stem, which the backward runs on the saved inputs:
    they differ only where cuDNN's reductions take another order, 1e-2 *
    max|ref| and cosine >= 0.9999."""
    g = _gen(SEED + 52)
    x = torch.randn((2, 3, 768, 768), generator=g, device="cuda").to(torch.bfloat16)
    wt = (torch.randn((64, 3, 7, 7), generator=g, device="cuda") * 0.1).to(torch.bfloat16)
    inv = torch.rand((64,), generator=g, device="cuda") + 0.5
    shift = torch.randn((64,), generator=g, device="cuda") * 0.1
    go = torch.randn((2, 64, 384, 384), generator=g, device="cuda").to(torch.bfloat16)
    packed = stem_ops.stem_kernel_weight(wt, torch.bfloat16)
    needs = (False, True, True, True)
    reset_counts()
    got = grads_of(lambda *a: stem_ops.fused_stem(*a, packed=packed), (x, wt, inv, shift), go,
                   needs)
    launched = counts()
    want = grads_of(stem_ops.fused_stem_plain, (x, wt, inv, shift), go, needs)
    torch.cuda.synchronize()
    check(launched == launches_of(fused_stem=1), f"grad_fused_stem launches {launched}")
    emit(dict(phase="grad_fused_stem", shape=list(x.shape), dtype=str(x.dtype),
              grads=compare_grads("grad_fused_stem", ("x", "w", "inv", "shift"), got, want,
                                  1e-2, 0.9999)))


def grad_warp_onehot() -> None:
    """``WarpOnehotFunction`` at a DFF feature map of the training crop,
    (2,1024,48,48) bf16 with the scale field, D=4, |flow_y| up to 1.5 D
    (clamped), |flow_x| up to 3 D: the gradients of the features, the flow
    and the scale against autograd through the plain version (run by the
    backward on the saved inputs), 1e-2 * max|ref|, cosine >= 0.9999."""
    g = _gen(SEED + 53)
    shape, d = (2, 1024, 48, 48), 4
    feat = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    flow = torch.rand((2, 2, 48, 48), generator=g, device="cuda") * 2 - 1
    flow = flow * torch.tensor([3.0 * d, 1.5 * d], device="cuda").view(1, 2, 1, 1)
    scale = (torch.rand(shape, generator=g, device="cuda") + 0.5).to(torch.bfloat16)
    go = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    reset_counts()
    got = grads_of(lambda f, fl, sc: onehot_ops.warp_onehot(f, fl, sc, d), (feat, flow, scale),
                   go, (True, True, True))
    launched = counts()
    want = grads_of(lambda f, fl, sc: onehot_ops.warp_onehot_plain(f, fl, sc, d),
                    (feat, flow, scale), go, (True, True, True))
    torch.cuda.synchronize()
    check(launched == launches_of(warp_onehot=1), f"grad_warp_onehot launches {launched}")
    emit(dict(phase="grad_warp_onehot", shape=list(shape), dtype=str(feat.dtype), max_disp=d,
              grads=compare_grads("grad_warp_onehot", ("feat", "flow", "scale"), got, want,
                                  1e-2, 0.9999)))


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


@torch.inference_mode()
def compare_class_maps(pred: torch.Tensor, ref: torch.Tensor, ref_model, frames: torch.Tensor,
                       propagate: str, interval: int = K) -> tuple[dict, torch.Tensor]:
    """Agreement of two class maps ``pred`` and ``ref`` (1, F, H, W) of
    one group (``frames`` (1, F, H, W, 3), a key frame every
    ``interval``), overall and on the clear pixels: those whose top-2
    margin in ``ref_model``'s stride-level logits (upsampled as the tail
    does) exceeds 1e-2 * max|logits|. Returns the agreements and those logits.

    With random weights a bf16 model puts ~0.6% of its pixels at top-2
    margins within bf16 rounding noise. Two paths whose bf16 values differ
    anywhere by rounding (cuDNN against an exactly rounded conv, or the
    tensor-core stem against the f32 conv, which differ on ~0.004% of the
    stem's outputs) flip those pixels: agreement ~0.994 overall, >= 0.9999
    on the clear pixels."""
    ref_logits = clip_logits(ref_model, frames.permute(0, 1, 4, 2, 3), interval, propagate)[0]
    peak = ref_logits.abs().max().item()
    up = F.interpolate(ref_logits, size=pred.shape[-2:], mode="bilinear", align_corners=False)
    top2 = up.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-2 * peak
    eq = pred[0] == ref[0]
    return dict(agreement=eq.float().mean().item(), clear_share=clear.float().mean().item(),
                clear_agreement=eq[clear].float().mean().item(), logits_max_abs=peak), ref_logits


@torch.inference_mode()
def compare_paths(pred: torch.Tensor, ref: torch.Tensor, model, ref_model, frames: torch.Tensor,
                  propagate: str) -> dict:
    """Two bf16 paths on one group: their class maps ``pred`` and ``ref``
    (``compare_class_maps``) and their stride-level logits, as push_group
    makes them."""
    c, ref_logits = compare_class_maps(pred, ref, ref_model, frames, propagate)
    logits = clip_logits(model, frames.permute(0, 1, 4, 2, 3), K, propagate)[0]
    return dict(c, logits_max_abs_err=(logits - ref_logits).abs().max().item())


def check_class_maps(phase: str, c: dict, overall: float = 0.99, clear: float = 0.9999) -> None:
    """Two bf16 paths' class maps agree on ``clear`` of the clear pixels
    and on ``overall`` of all of them."""
    check(c["agreement"] >= overall and c["clear_agreement"] >= clear,
          f"{phase} class maps: {c['agreement']}, {c['clear_agreement']} off near-ties")


def check_bf16_paths(phase: str, c: dict, overall: float = 0.99) -> None:
    """Two bf16 paths agree: logits within 2e-2 * max|logits| and class
    maps as ``check_class_maps`` holds them."""
    check(c["logits_max_abs_err"] <= 2e-2 * c["logits_max_abs"],
          f"{phase} logits: {c['logits_max_abs_err']} of {c['logits_max_abs']}")
    check_class_maps(phase, c, overall)


def plain_with_kernel_stem(net: dict, state: dict):
    """The plain path with only the stem through its kernel: the kernel
    path's stem output, every other kernel's plain version. Against it the
    kernel path holds its other kernels to >= 0.999 of the class map, with
    the stem's one-ulp roundings out of the way."""
    model = build_model(net, device="cuda", generator=torch.Generator().manual_seed(SEED),
                        use_kernels=False)
    model.load_state_dict(state)
    for m in model.modules():
        if isinstance(m, DilatedResNet):
            m.use_kernels = True
    return model


def class_agreement(out: list, ref_out: list) -> list[float]:
    """Per group, the share of pixels where two runs' class maps agree."""
    return [(pred == ref).float().mean().item() for (pred, _), (ref, _) in zip(out, ref_out)]


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
        tol = 1e-3 * (1 + want.abs().max().item())
        seg_c, seg_g = (VideoSegmenter(m, K, propagate=propagate) for m in (cpu, gpu))
        agree = min((seg_g.push_group(clip[:, g:g + K].cuda()).cpu()
                     == seg_c.push_group(clip[:, g:g + K])).float().mean().item()
                    for g in (0, K))
        emit(dict(phase="small_reference", propagate=propagate, max_abs_flow=max_flow,
                  logits_max_abs_err=err, tol=tol, class_agreement=agree))
        check(err <= tol, f"small reference logits {propagate}: {err} > {tol}")
        check(agree >= 0.999, f"small reference class maps {propagate}: {agree}")


def e2e_bench() -> tuple[dict[str, int], int]:
    """Phase 4. Returns the launch counts of the main path's run and its
    number of groups."""
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
    for name in ("warp", "upsample_argmax", "fused_stem"):
        check(launched[name] > 0, f"kernel {name} was not launched on the main path")
    # a warp per non-key frame of an incremental group (one frame a step),
    # one batched warp per direct group; one tail per group
    check(launched["warp"] == 3 * (K - 1) + 1 and launched["upsample_argmax"] == len(groups),
          f"main path launches {launched}")

    plain = build_model(BENCH_NET, device="cuda", generator=torch.Generator().manual_seed(SEED),
                        use_kernels=False)
    plain.load_state_dict(model.state_dict())
    run(plain)  # warm-up
    plain_out = run(plain)
    check(counts() == launched, "the plain path launched a kernel")
    names = [f"{p}{i}" for i, (p, _) in enumerate(groups)]
    vs_plain = {name: compare_paths(pred, ref, model, plain, frames, p)
                for name, (p, frames), (pred, _), (ref, _) in zip(names, groups, out, plain_out)}
    del plain
    same_stem = plain_with_kernel_stem(BENCH_NET, model.state_dict())
    run(same_stem)  # warm-up
    vs_same_stem = dict(zip(names, class_agreement(out, run(same_stem))))
    emit(dict(phase="e2e_plain", group_ms=dict(zip(names, (ms for _, ms in plain_out))),
              kernels_vs_plain=vs_plain, class_agreement_vs_plain_same_stem=vs_same_stem))
    for key, c in vs_plain.items():
        check_bf16_paths(f"e2e kernel vs plain, group {key}", c)
    for key, agree in vs_same_stem.items():
        check(agree >= 0.999, f"e2e kernel vs plain with the kernel stem, group {key}: {agree}")
    return launched, len(groups)


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


def run_groups(model, groups) -> tuple[list[tuple[torch.Tensor, float]], dict[str, int]]:
    """Serve ``groups`` [(propagate, frames)] through fresh segmenters
    after one warm-up pass (cuDNN algorithm choice, allocator). Returns
    (prediction, ms) per group and the launch counts of the timed pass."""
    def run():
        segs = {p: VideoSegmenter(model, K, propagate=p) for p in ("incremental", "direct")}
        return [timed_group(segs[p], frames) for p, frames in groups]

    run()
    reset_counts()
    out = run()
    return out, counts()


def e2e_dff() -> tuple[dict[str, int], int, dict]:
    """Phase 6. Returns the launch counts of its kernel run, its number of
    groups and the model's weights (for phase 7)."""
    model = build_model(DFF_NET, device="cuda", generator=torch.Generator().manual_seed(SEED))
    clip = moving_clip(3 * K, (H, W), SEED + 12, "cuda")
    max_flow = live_flow_heads(model, clip, SEED + 13)
    check(max_flow > 0.5, f"flow {max_flow} too small to exercise the warp")
    groups = [("direct", clip[:, :K]), ("direct", clip[:, K:2 * K]),
              ("incremental", clip[:, 2 * K:])]
    names = [f"{p}{i}" for i, (p, _) in enumerate(groups)]
    out, launched = run_groups(model, groups)
    for pred, _ in out:
        check_pred(pred, (1, K, H, W))
    plain = build_model(DFF_NET, device="cuda", generator=torch.Generator().manual_seed(SEED),
                        use_kernels=False)
    plain.load_state_dict(model.state_dict())
    plain_out, plain_launched = run_groups(plain, groups)
    check(not any(plain_launched.values()), f"the plain dff path launched {plain_launched}")
    vs_plain = {name: compare_paths(pred, ref, model, plain, frames, p)
                for name, (p, frames), (pred, _), (ref, _) in zip(names, groups, out, plain_out)}
    del plain
    same_stem_out, _ = run_groups(plain_with_kernel_stem(DFF_NET, model.state_dict()), groups)
    vs_same_stem = dict(zip(names, class_agreement(out, same_stem_out)))
    emit(dict(phase="e2e_dff", config="dff101 frozenbn fused7 bf16 onehot native D=4",
              hw=[H, W], B=1, k=K, max_abs_flow=max_flow,
              group_ms=dict(zip(names, (ms for _, ms in out))),
              plain_group_ms=dict(zip(names, (ms for _, ms in plain_out))),
              kernels_vs_plain=vs_plain, class_agreement_vs_plain_same_stem=vs_same_stem,
              launches=launched))
    for name in ("warp_onehot", "upsample_argmax", "fused_stem"):
        check(launched[name] > 0, f"kernel {name} was not launched on the dff path")
    check(launched["warp"] == 0 and launched["dilated_conv"] == 0,
          "the dff path launched the score-map warp or the dilated conv")
    # one batched warp per direct group, one per non-key frame of an
    # incremental group
    check(launched["warp_onehot"] == 2 + (K - 1),
          f"dff warp_onehot launches {launched['warp_onehot']} != {2 + (K - 1)}")
    # DFF scores warped fc6 features: ~1% of its pixels sit at bf16 near-ties
    # (0.9897-0.9907 overall on an H100, >= 0.99997 on the clear pixels)
    for key, c in vs_plain.items():
        check_bf16_paths(f"e2e_dff kernel vs plain, group {key}", c, overall=0.98)
    for key, agree in vs_same_stem.items():
        check(agree >= 0.999, f"e2e_dff kernel vs plain with the kernel stem, group {key}: {agree}")
    return launched, len(groups), model.state_dict()


def e2e_dff_fc6(state: dict) -> None:
    """Phase 7: fc6 through the dilated kernel, against cuDNN's fc6."""
    clip = moving_clip(K, (H, W), SEED + 14, "cuda")
    out, launched = {}, {}
    for mode in ("auto", "pallas_fc6"):
        model = build_model(dict(DFF_NET, dilated_conv=mode), device="cuda",
                            generator=torch.Generator().manual_seed(SEED))
        model.load_state_dict(state)
        (out[mode],), launched[mode] = run_groups(model, [("direct", clip)])
        del model
    agree = (out["auto"][0] == out["pallas_fc6"][0]).float().mean().item()
    emit(dict(phase="e2e_dff_fc6", hw=[H, W], B=1, k=K, group_ms=out["pallas_fc6"][1],
              auto_group_ms=out["auto"][1], class_agreement_vs_auto=agree,
              launches=launched["pallas_fc6"]))
    check_pred(out["pallas_fc6"][0], (1, K, H, W))
    check(agree >= 0.999, f"e2e_dff_fc6 class maps vs auto: {agree}")
    # one fc6 per group: the keyframe's
    check(launched["pallas_fc6"]["dilated_conv"] == 1,
          f"pallas_fc6 fc6 launches {launched['pallas_fc6']['dilated_conv']} != 1")
    check(launched["auto"]["dilated_conv"] == 0, "auto launched the dilated conv")


def e2e_deeplab() -> dict[str, int]:
    """Phase 8. Returns the launch counts of the bf16 ``pallas`` run.

    bf16 ``pallas`` against ``auto`` (cuDNN) as ``compare_paths`` holds two
    bf16 paths (on an H100, cuDNN's bf16 convs and exactly rounded ones
    agree on 0.9938 of the class map), and the same model in f32, where
    rounding is no longer in the way, on >= 0.999 of all pixels."""
    clip = moving_clip(K, (H, W), SEED + 15, "cuda")
    out, launched, models = {}, {}, {}
    for mode in ("pallas", "auto"):
        # one seed, so both modes hold the same weights
        models[mode] = build_model(dict(DEEPLAB_NET, dilated_conv=mode), device="cuda",
                                   generator=torch.Generator().manual_seed(SEED))
        (out[mode],), launched[mode] = run_groups(models[mode], [("direct", clip)])
    vs_auto = compare_paths(out["pallas"][0], out["auto"][0], models["pallas"], models["auto"],
                            clip, "direct")
    del models

    f32_pred = {}
    for mode in ("pallas", "auto"):
        model = build_model(dict(DEEPLAB_NET, dilated_conv=mode, dtype="float32"),
                            device="cuda", generator=torch.Generator().manual_seed(SEED))
        f32_pred[mode] = VideoSegmenter(model, K).push_group(clip)
        del model
    agree_f32 = (f32_pred["pallas"] == f32_pred["auto"]).float().mean().item()
    emit(dict(phase="e2e_deeplab", config="deeplab101 frozenbn fused7 bf16", hw=[H, W], B=1,
              frames=K, pallas_ms=out["pallas"][1], auto_ms=out["auto"][1],
              pallas_fps=K / (out["pallas"][1] / 1e3), auto_fps=K / (out["auto"][1] / 1e3),
              pallas_vs_auto=vs_auto, f32_class_agreement_vs_auto=agree_f32,
              launches=launched["pallas"]))
    check_pred(out["pallas"][0], (1, K, H, W))
    check_bf16_paths("e2e_deeplab pallas vs auto", vs_auto)
    check(agree_f32 >= 0.999, f"e2e_deeplab f32 class maps pallas vs auto: {agree_f32}")
    # 3 layer4 conv2 + fc6 per frame
    check(launched["pallas"]["dilated_conv"] == 4 * K,
          f"deeplab dilated_conv launches {launched['pallas']['dilated_conv']} != {4 * K}")
    check(launched["auto"]["dilated_conv"] == 0, "auto launched the dilated conv")
    check(launched["pallas"]["fused_stem"] == K and launched["pallas"]["upsample_argmax"] > 0,
          "deeplab path skipped a kernel")
    return launched["pallas"]


def launches_of(**per_kernel) -> dict[str, int]:
    """Expected launch counts (``counts``' keys): every kernel 0 unless named."""
    return {name: per_kernel.get(name, 0) for name in (*LAUNCHERS, "dilated_conv_dx")}


def one_group(model, clip: torch.Tensor, propagate: str):
    """One group through ``clip_predictions`` after a warm-up call: the
    class maps, the host ms (ending in a synchronize) and the launches."""
    clip_predictions(model, clip, K, propagate)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = clip_predictions(model, clip, K, propagate)
    torch.cuda.synchronize()
    return pred, (time.perf_counter() - t0) * 1e3, counts()


def e2e_variant(phase: str, config: str, net: dict, propagate: str, seed: int,
                expected: dict, overall: float = 0.99) -> dict[str, int]:
    """One B=1 group of ``net`` at 1024x2048 through ``clip_predictions``:
    the kernel path with its exact launches, against the plain path
    (``compare_paths``) and, on >= 0.999 of the class map, against the
    plain path with the stem kernel's output. Returns the launches."""
    model = build_model(net, device="cuda", generator=torch.Generator().manual_seed(SEED))
    clip = moving_clip(K, (H, W), seed, "cuda")
    max_flow = live_flow_heads(model, clip, seed + 1)
    check(max_flow > 0.5, f"{phase}: flow {max_flow} too small to exercise the warp")
    pred, ms, launched = one_group(model, clip, propagate)
    check_pred(pred, (1, K, H, W))
    plain = build_model(net, device="cuda", generator=torch.Generator().manual_seed(SEED),
                        use_kernels=False)
    plain.load_state_dict(model.state_dict())
    ref, plain_ms, plain_launched = one_group(plain, clip, propagate)
    check(not any(plain_launched.values()), f"{phase}: the plain path launched {plain_launched}")
    vs_plain = compare_paths(pred, ref, model, plain, clip, propagate)
    del plain
    same_stem, _, _ = one_group(plain_with_kernel_stem(net, model.state_dict()), clip, propagate)
    vs_same_stem = (pred == same_stem).float().mean().item()
    emit(dict(phase=phase, config=config, propagate=propagate, hw=[H, W], B=1, k=K,
              max_abs_flow=max_flow, group_ms=ms, plain_group_ms=plain_ms,
              kernels_vs_plain=vs_plain, class_agreement_vs_plain_same_stem=vs_same_stem,
              launches=launched))
    check(launched == expected, f"{phase} launches {launched} != {expected}")
    check_bf16_paths(f"{phase} kernel vs plain", vs_plain, overall)
    check(vs_same_stem >= 0.999, f"{phase} kernel vs plain with the kernel stem: {vs_same_stem}")
    return launched


def stream_group(seg: VideoSegmenter, frames: torch.Tensor) -> tuple[torch.Tensor, list[float]]:
    """``push_frame`` on each frame of a group, each ending in a
    synchronize (the frame's class map is ready to send): the class maps
    (1, k, H, W) and the host ms of each frame."""
    preds, ms = [], []
    for i in range(frames.shape[1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds.append(seg.push_frame(frames[:, i]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return torch.stack(preds, dim=1), ms


def e2e_stream(phase: str, config: str, net: dict, seed: int, per_group: dict,
               overall: float, turns: int = 4) -> dict[str, int]:
    """Per-frame serving: a direct and an incremental + 'last' group of
    ``net`` at 1024x2048 through ``VideoSegmenter.push_frame``, with the
    exact launches of the two groups (``per_group`` each). Its class maps
    are held (``compare_class_maps``; push_frame returns no logits) against
    ``push_group`` on the same frames and weights, of the kernel model
    (``push_group`` batches the non-key frames, where cuDNN may choose
    other algorithms than at batch 1) and of the plain model. Then
    ``turns`` alternating turns of both protocols on the host clock.
    Returns the launches."""
    model = build_model(net, device="cuda", generator=torch.Generator().manual_seed(SEED))
    clip = moving_clip(2 * K, (H, W), seed, "cuda")
    max_flow = live_flow_heads(model, clip, seed + 1)
    check(max_flow > 0.5, f"{phase}: flow {max_flow} too small to exercise the warp")
    groups = [("direct", clip[:, :K]), ("incremental", clip[:, K:])]
    segs = {p: VideoSegmenter(model, K, propagate=p) for p, _ in groups}

    def streamed():
        out = {}
        for p, frames in groups:
            segs[p].reset()
            out[p] = stream_group(segs[p], frames)
        return out

    def grouped():
        out = {}
        for p, frames in groups:
            segs[p].reset()
            out[p] = timed_group(segs[p], frames)
        return out

    streamed()  # warm-up: cuDNN algorithm choice at batch 1, allocator
    grouped()
    reset_counts()
    stream_out = streamed()
    launched = counts()
    group_out = grouped()
    for p, _ in groups:
        check_pred(stream_out[p][0], (1, K, H, W))
    vs_group = {p: compare_class_maps(stream_out[p][0], group_out[p][0], model, frames, p)[0]
                for p, frames in groups}
    plain = build_model(net, device="cuda", generator=torch.Generator().manual_seed(SEED),
                        use_kernels=False)
    plain.load_state_dict(model.state_dict())
    reset_counts()
    vs_plain = {p: compare_class_maps(stream_out[p][0],
                                      VideoSegmenter(plain, K, propagate=p).push_group(frames),
                                      plain, frames, p)[0]
                for p, frames in groups}
    check(not any(counts().values()), f"{phase}: the plain path launched {counts()}")
    del plain
    frame_ms = {p: {"key": [], "non_key": []} for p, _ in groups}
    stream_ms = {p: [] for p, _ in groups}
    group_ms = {p: [] for p, _ in groups}
    for turn in range(turns):
        for protocol in (("stream", "group") if turn % 2 == 0 else ("group", "stream")):
            if protocol == "group":
                for p, (_, ms) in grouped().items():
                    group_ms[p].append(ms)
                continue
            for p, (_, ms) in streamed().items():
                frame_ms[p]["key"].append(ms[0])
                frame_ms[p]["non_key"].extend(ms[1:])
                stream_ms[p].append(sum(ms))
    med = statistics.median
    emit(dict(phase=phase, config=config, hw=[H, W], B=1, k=K, turns=turns, max_abs_flow=max_flow,
              push_frame_ms={p: {kind: med(v) for kind, v in d.items()}
                             for p, d in frame_ms.items()},
              push_frame_group_ms={p: med(v) for p, v in stream_ms.items()},
              push_group_ms={p: med(v) for p, v in group_ms.items()},
              push_frame_group_ms_all=stream_ms, push_group_ms_all=group_ms,
              push_frame_vs_push_group=vs_group, push_frame_vs_plain_push_group=vs_plain,
              launches=launched))
    expected = {name: len(groups) * n for name, n in per_group.items()}
    check(launched == expected, f"{phase} launches {launched} != {expected}")
    for p in vs_group:
        check_class_maps(f"{phase} push_frame vs push_group, {p}", vs_group[p], overall)
        check_class_maps(f"{phase} push_frame vs the plain push_group, {p}", vs_plain[p],
                         overall)
    return launched


# ---- phase 15: int8 serving ------------------------------------------------------

# the int8 kernel path's class maps against the plain int8 path's, overall
# and on the clear pixels. The two differ only in the stem (the kernel and
# the plain stem round apart on ~0.005% of its bf16 outputs; with the
# stem's output shared the maps agree on >= 0.9999999 of the pixels on an
# H100): a value moved across a quantization step moves a whole int8 step,
# and the flips compound through 104 quantized convs, so random weights
# flip far more pixels than between two bf16 paths. Measured on an H100
# (700 W): 0.966-0.973 overall, 0.995-0.998 clear, the same order as int8
# against bf16 (0.962).
QUANT_OVERALL, QUANT_CLEAR = 0.95, 0.99

# int8 convs (cuBLAS int8 GEMMs) of one pass: R101 33 blocks x 3 convs + 4
# downsamples + fc6, R18 8 blocks x 2 convs + 3 downsamples + fc6
INT8_CONVS = {101: 33 * 3 + 4 + 1, 18: 8 * 2 + 3 + 1}


def quant_groups(model, clip: torch.Tensor, clip4: torch.Tensor) -> dict:
    """The int8 phase's serving run: an incremental and a direct group at
    B=1 and a direct group at B=4 through ``push_group``, then an
    incremental group through ``push_frame``: {name: (class maps, host ms)}."""
    segs = {p: VideoSegmenter(model, K, propagate=p) for p in ("incremental", "direct")}
    out = {"incremental": timed_group(segs["incremental"], clip[:, :K]),
           "direct": timed_group(segs["direct"], clip[:, K:2 * K]),
           "direct_B4": timed_group(segs["direct"], clip4)}
    segs["incremental"].reset()
    preds, ms = stream_group(segs["incremental"], clip[:, 2 * K:])
    out["push_frame"] = (preds, sum(ms))
    return out


def e2e_quant() -> dict[str, int]:
    """Phase 15: int8 Accel-18 (``INT8_NET``) at 1024x2048 through
    ``VideoSegmenter``: the groups of ``quant_groups``, with the exact
    launches (both stems and one tail a group, 4 warps an incremental
    group, 1 a direct one; per frame through ``push_frame``), no dilated
    conv (int8 takes precedence), and the exact number of int8 GEMMs.
    Against the plain model (the kernels' plain versions and the exact
    float64 int8 product) on the same groups: the class maps overall and
    off near-ties (``compare_class_maps``), and, against the plain model
    with the stem kernel's output, >= 0.999 overall (the int8 product is
    exact on both sides, so only the warp and the tail round apart). The
    int8 class maps' agreement with the bf16 model's on the B=1 groups is
    printed, as are the host times of both. Returns the launches."""
    model = build_model(INT8_NET, device="cuda", generator=torch.Generator().manual_seed(SEED))
    clip = moving_clip(3 * K, (H, W), SEED + 80, "cuda")
    max_flow = live_flow_heads(model, clip, SEED + 81)
    check(max_flow > 0.5, f"e2e_quant: flow {max_flow} too small to exercise the warp")
    clip4 = torch.cat([moving_clip(K, (H, W), SEED + 82 + b, "cuda") for b in range(4)])
    groups = {"incremental": ("incremental", clip[:, :K]), "direct": ("direct", clip[:, K:2 * K]),
              "direct_B4": ("direct", clip4), "push_frame": ("incremental", clip[:, 2 * K:])}
    quant_groups(model, clip, clip4)  # warm-up
    reset_counts()
    mm0 = quant_ops.int_mm.launches
    out = quant_groups(model, clip, clip4)
    launched, int_mm = counts(), quant_ops.int_mm.launches - mm0
    for name, (pred, _) in out.items():
        check_pred(pred, (4 if name == "direct_B4" else 1, K, H, W))
    # push_frame: both stems on the key frame, the update stem on each other
    expected = launches_of(fused_stem=2 * 3 + 2 + (K - 1), warp=(K - 1) + 1 + 1 + (K - 1),
                           upsample_argmax=3 + K)
    passes = INT8_CONVS[101] + INT8_CONVS[18]
    # a group: the key frame's R101 and one R18 call over its B*k frames;
    # push_frame: the key's R101 and an R18 call per frame
    expected_mm = 3 * passes + INT8_CONVS[101] + K * INT8_CONVS[18]

    plain = build_model(INT8_NET, device="cuda", generator=torch.Generator().manual_seed(SEED),
                        use_kernels=False)
    plain.load_state_dict(model.state_dict())
    reset_counts()
    mm0 = quant_ops.int_mm.launches
    plain_out = quant_groups(plain, clip, clip4)
    check(not any(counts().values()) and quant_ops.int_mm.launches == mm0,
          f"e2e_quant: the plain path launched {counts()}, "
          f"{quant_ops.int_mm.launches - mm0} int8 GEMMs")
    vs_plain = {}
    for name, (propagate, frames) in groups.items():
        pred, ref = out[name][0], plain_out[name][0]
        vs_plain[name] = [compare_class_maps(pred[b:b + 1], ref[b:b + 1], plain,
                                             frames[b:b + 1], propagate)[0]
                          for b in range(pred.shape[0])]
    del plain
    same_stem = plain_with_kernel_stem(INT8_NET, model.state_dict())
    same_out = quant_groups(same_stem, clip, clip4)
    vs_same_stem = {name: (out[name][0] == same_out[name][0]).float().mean().item()
                    for name in groups}
    del same_stem, same_out
    bf16 = build_model(BENCH_NET, device="cuda", generator=torch.Generator().manual_seed(SEED))
    bf16.load_state_dict(model.state_dict())
    quant_groups(bf16, clip, clip4)  # warm-up
    bf16_out = quant_groups(bf16, clip, clip4)
    int8_vs_bf16 = {name: (out[name][0] == bf16_out[name][0]).float().mean().item()
                    for name in groups}
    bf16_ms = {name: ms for name, (_, ms) in bf16_out.items()}
    del bf16, bf16_out
    emit(dict(phase="e2e_quant", config="accel18 int8 (quantize_ref, quantize_update) frozenbn "
              "fused7 bf16", hw=[H, W], k=K, max_abs_flow=max_flow,
              group_ms={name: ms for name, (_, ms) in out.items()},
              plain_group_ms={name: ms for name, (_, ms) in plain_out.items()},
              bf16_group_ms=bf16_ms,
              kernels_vs_plain=vs_plain, class_agreement_vs_plain_same_stem=vs_same_stem,
              int8_vs_bf16_class_agreement=int8_vs_bf16, launches=launched,
              int8_gemms=int_mm, card=card()))
    check(launched == expected, f"e2e_quant launches {launched} != {expected}")
    check(int_mm == expected_mm, f"e2e_quant int8 GEMMs {int_mm} != {expected_mm}")
    for name, per_clip in vs_plain.items():
        for b, c in enumerate(per_clip):
            check_class_maps(f"e2e_quant kernel vs plain, {name} clip {b}", c, QUANT_OVERALL,
                             QUANT_CLEAR)
    for name, agree in vs_same_stem.items():
        check(agree >= 0.999, f"e2e_quant kernel vs plain with the kernel stem, {name}: {agree}")
    return launched


def e2e_fold() -> dict[str, int]:
    """Phase 16: the folded fast model (``FOLD_NET``), a direct and an
    incremental group as ``e2e_variant`` holds them. The conv7 stem runs
    through cuDNN, so only the warp and the tail kernels launch."""
    launched = {}
    for propagate, warps, seed in (("direct", 1, SEED + 90), ("incremental", K - 1, SEED + 92)):
        got = e2e_variant(f"e2e_fold_{propagate}", "accel18_fast conv7 fold_update_downscale "
                          "fold_flow_downscale bf16", FOLD_NET, propagate, seed,
                          launches_of(warp=warps, upsample_argmax=1))
        launched = {name: launched.get(name, 0) + n for name, n in got.items()}
    return launched


# ---- phase 12: video eval from a cfg file ---------------------------------------

REPO = Path(__file__).resolve().parent
EVAL_SNIPPETS = 2
# labelIds of the tree's annotation bands: sky, road, car (unlabelled corner)
EVAL_BANDS = (23, 7, 26)


def write_png(path: Path, arr: torch.Tensor) -> None:
    """An 8-bit PNG of a (H, W) gray or (H, W, 3) BGR uint8 tensor (the
    order cv2 writes), every row with filter 0."""
    a = arr.cpu().numpy()
    colour = 0 if a.ndim == 2 else 2
    if colour == 2:
        a = a[:, :, ::-1]  # BGR -> RGB
    h, w = a.shape[:2]
    rows = a.reshape(h, -1)
    raw = b"".join(b"\x00" + rows[r].tobytes() for r in range(h))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (len(body).to_bytes(4, "big") + kind + body
                + zlib.crc32(kind + body).to_bytes(4, "big"))

    header = w.to_bytes(4, "big") + h.to_bytes(4, "big") + bytes([8, colour, 0, 0, 0])
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                     + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_city_split(data: Path, split: str, snippets: int, first: int, last: int,
                     seed: int) -> None:
    """``snippets`` annotated snippets of a Cityscapes-layout ``split``
    at 1024x2048: frames ANNOTATED_FRAME+first .. ANNOTATED_FRAME+last of
    a scene panning 4 px a frame (``moving_clip``, as BGR uint8), and
    labelIds in three bands with an unlabelled 4x4 corner."""
    label = torch.empty((H, W), dtype=torch.uint8)
    for i, label_id in enumerate(EVAL_BANDS):
        label[i * H // 3:(i + 1) * H // 3 if i < 2 else H] = label_id
    label[:4, :4] = 0
    city = f"{split}city"
    for seq in range(snippets):
        clip = moving_clip(last - first + 1, (H, W), seed + seq, "cpu")[0]
        frames = (clip * 40 + 120).round().clamp(0, 255).to(torch.uint8)
        name = f"{city}_{seq:06d}"
        for i, f in enumerate(range(ANNOTATED_FRAME + first, ANNOTATED_FRAME + last + 1)):
            folder = (f"leftImg8bit/{split}" if f == ANNOTATED_FRAME
                      else f"leftImg8bit_sequence/{split}")
            write_png(data / folder / city / f"{name}_{f:06d}_leftImg8bit.png", frames[i])
        write_png(data / f"gtFine/{split}/{city}"
                  / f"{name}_{ANNOTATED_FRAME:06d}_gtFine_labelIds.png", label)


def write_eval_tree(root: Path) -> tuple[Path, int]:
    """A Cityscapes-layout val tree: EVAL_SNIPPETS annotated snippets,
    frames ANNOTATED_FRAME-K+1 .. ANNOTATED_FRAME. Returns the dataset
    path and the valid (labelled) pixels per annotation."""
    data = root / "cityscapes"
    write_city_split(data, "val", EVAL_SNIPPETS, 1 - K, 0, SEED + 30)
    return data, H * W - 16


def eval_cfg(name: str, root: Path, data: Path, stem: str | None = None, **values) -> Path:
    """``experiments/cfgs/<name>.yaml`` with its output and dataset paths
    pointed at ``root`` and ``data`` and each key of ``values`` (set once
    in the file) given its value; every other line as shipped. Written as
    ``root/<stem or name>.yaml``: the entry points name the run's output
    directory after the file."""
    text = (REPO / "experiments" / "cfgs" / f"{name}.yaml").read_text()
    for key, value in (("output_path", root / "out"), ("dataset_path", data),
                       ("root_path", root), *values.items()):
        text, n = re.subn(rf"(?m)^(\s*){key}:.*$", rf"\g<1>{key}: {value}", text)
        check(n == 1, f"{name}.yaml sets {key} {n} times")
    path = root / f"{stem or name}.yaml"
    path.write_text(text)
    return path


def median_host_ms(fn, turns: int = 3) -> float:
    """Median host-clock ms of ``fn`` over ``turns`` calls."""
    times = []
    for _ in range(turns):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def loader_breakdown(imdb, cfg) -> dict:
    """Host ms of the loader's steps on the tree's first annotated frame:
    the PNG read (``cv2.imread``), the normalize, and the annotation
    (read + label LUT)."""
    entry = imdb.segdb[0]
    im = imdb.load_image(entry["image"])
    means, stds = cfg.network.PIXEL_MEANS, cfg.network.PIXEL_STDS
    return dict(read=median_host_ms(lambda: imdb.load_image(entry["image"])),
                normalize=median_host_ms(lambda: transform(im, means, stds)),
                annotation=median_host_ms(lambda: imdb.load_annotation(entry)))


def e2e_eval(phase: str, cfg_name: str, root: Path, data: Path, valid_per_clip: int,
             per_clip: dict, overall: float) -> dict[str, int]:
    """Phase 12 for one cfg. Returns the launches of the entry point's run."""
    path = eval_cfg(cfg_name, root, data)
    reset_counts()
    t0 = time.perf_counter()
    (result,) = eval_entry.main(["--cfg", str(path), "--random-weights",
                                 "--max-items", str(EVAL_SNIPPETS)])
    wall_s = time.perf_counter() - t0
    launched = counts()
    stats = result["stats"]
    valid = EVAL_SNIPPETS * valid_per_clip
    check(float(stats["confusion"].sum()) == valid,
          f"{phase}: {stats['confusion'].sum()} pixels scored, expected {valid}")
    check(0.0 <= result["miou"] <= 1.0 and stats["frames"] == EVAL_SNIPPETS * K,
          f"{phase}: miou {result['miou']}, {stats['frames']} frames")
    expected = {name: EVAL_SNIPPETS * n for name, n in per_clip.items()}
    check(launched == expected, f"{phase} launches {launched} != {expected}")

    # kernels against plain: one cfg, one seed, live flow heads, the same batches
    cfg = load_config(str(path))
    eval_entry.apply_serving_network(cfg)
    imdb = Cityscape(cfg.dataset.test_image_set, str(root / "cache_kvp"), str(data))
    t0 = time.perf_counter()
    host_batches = list(TestClipLoader(imdb, cfg, max_items=EVAL_SNIPPETS))
    loader_ms_per_frame = (time.perf_counter() - t0) * 1e3 / (EVAL_SNIPPETS * K)
    loader_split_ms = loader_breakdown(imdb, cfg)
    batches = [to_device(b, "cuda") for b in host_batches]
    del host_batches
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    max_flow = live_flow_heads(model, batches[0]["clip"], SEED + 40)
    check(max_flow > 0.5, f"{phase}: flow {max_flow} too small to exercise the warp")
    plain = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED),
                        use_kernels=False)
    plain.load_state_dict(model.state_dict())
    quiet = logging.getLogger("chip_smoke.eval")
    propagate, interval = str(cfg.network.propagate), int(cfg.TEST.KEY_FRAME_INTERVAL)
    runs = {}
    for name, m in (("kernels", model), ("plain", plain)):
        preds = []
        reset_counts()
        miou, _, st = pred_eval_clips(m, batches, int(cfg.dataset.NUM_CLASSES), interval,
                                      propagate, quiet, on_preds=lambda _, p: preds.append(p))
        runs[name] = dict(miou=miou, stats=st, launches=counts(), preds=preds)
    check(runs["kernels"]["launches"] == expected,
          f"{phase} kernel model launches {runs['kernels']['launches']} != {expected}")
    check(not any(runs["plain"]["launches"].values()),
          f"{phase}: the plain model launched {runs['plain']['launches']}")
    cm_k, cm_p = runs["kernels"]["stats"]["confusion"], runs["plain"]["stats"]["confusion"]
    l1 = float(abs(cm_k - cm_p).sum())
    d_miou = abs(runs["kernels"]["miou"] - runs["plain"]["miou"])
    # the class maps pixel by pixel, each clip's frames overall and on the
    # pixels clear of near-ties in the plain model's logits
    class_maps = [
        compare_class_maps(pk[i:i + 1], pp[i:i + 1], plain, batch["clip"][i:i + 1], propagate,
                           interval)[0]
        for batch, pk, pp in zip(batches, runs["kernels"]["preds"], runs["plain"]["preds"],
                                 strict=True)
        for i in range(pk.shape[0])]
    check(len(class_maps) >= EVAL_SNIPPETS, f"{phase}: {len(class_maps)} clips compared")
    emit(dict(phase=phase, cfg=f"experiments/cfgs/{cfg_name}.yaml", hw=[H, W], k=K,
              clips=EVAL_SNIPPETS, propagate=propagate,
              entry_point=dict(miou=result["miou"], fps=stats["fps"],
                               net_ms_per_frame=1e3 / stats["fps"],
                               data_wait_ms_per_frame=stats["t_data"] * 1e3 / stats["frames"],
                               wall_s=wall_s, launches=launched),
              loader_ms_per_frame=loader_ms_per_frame, loader_split_ms=loader_split_ms,
              max_abs_flow=max_flow,
              kernels_miou=runs["kernels"]["miou"], plain_miou=runs["plain"]["miou"],
              kernels_fps=runs["kernels"]["stats"]["fps"],
              plain_fps=runs["plain"]["stats"]["fps"],
              predicted_classes=int((cm_k.sum(axis=0) > 0).sum()), confusion_l1=l1,
              valid_pixels=valid,
              confusion_l1_limit=2 * (1 - overall) * valid, class_maps=class_maps,
              card=card()))
    for i, c in enumerate(class_maps):
        check_class_maps(f"{phase} kernels vs plain, clip {i}", c, overall)
    check(d_miou <= 0.01, f"{phase}: kernel vs plain mIoU differ by {d_miou}")
    check(l1 <= 2 * (1 - overall) * valid,
          f"{phase}: kernel vs plain confusion L1 {l1} > {2 * (1 - overall) * valid}")
    return launched


# ---- phase 14: training from a cfg file ---------------------------------------

# annotated train snippets: 4 steps of the clip cfg (B=2), 2 of the pair cfg (B=4)
TRAIN_SNIPPETS = 8
TIMED_STEPS = 4


def write_train_tree(root: Path) -> Path:
    """A train split (TRAIN_SNIPPETS snippets, frames ANNOTATED_FRAME-4 ..
    +4: every frame a 5-frame clip or a pair at offset -4..0 reads) and a
    val split of one snippet. Returns the dataset path."""
    data = root / "cityscapes"
    write_city_split(data, "train", TRAIN_SNIPPETS, 1 - K, K - 1, SEED + 60)
    write_city_split(data, "val", 1, 1 - K, 0, SEED + 30)
    return data


def loss_and_grads(model, batch: dict, objective: str, cfg) -> tuple[float, dict, dict]:
    """One forward and backward of the cfg's objective: the loss, each
    parameter's gradient (f32) and the launches."""
    model.zero_grad(set_to_none=True)
    reset_counts()
    tr = cfg.TRAIN
    kw = dict(ohem_fraction=float(tr.ohem_fraction) or None,
              aux_weight=float(tr.aux_loss_weight))
    if objective == "clip":
        loss, _ = clip_loss_and_stats(model, batch, int(cfg.dataset.NUM_CLASSES),
                                      propagate=str(cfg.network.propagate),
                                      remat=bool(tr.remat), **kw)
    else:
        loss, _ = pair_loss_and_stats(model, batch, int(cfg.dataset.NUM_CLASSES),
                                      mutable_stats=model.norm == "batchnorm", **kw)
    loss.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.float() for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return loss.item(), grads, counts()


def grad_agreement(step: tuple, ref: tuple) -> dict:
    """Two ``loss_and_grads`` results: the loss's relative difference and
    the cosine of each parameter's gradients (min, median, the worst three,
    the number under 0.999)."""
    (loss, grads, _), (ref_loss, ref_grads, _) = step, ref
    check(grads.keys() == ref_grads.keys(), "the two steps reach other parameters")
    cos = sorted((cosine(grads[n], ref_grads[n]), n) for n in grads)
    return dict(loss=loss, ref_loss=ref_loss, loss_rel_diff=abs(loss - ref_loss) / abs(ref_loss),
                cosine_min=cos[0][0], cosine_median=cos[len(cos) // 2][0],
                under_0999=sum(c < 0.999 for c, _ in cos), params=len(cos),
                worst=[(n, c) for c, n in cos[:3]])


@contextlib.contextmanager
def exactly_rounded_dilated_plain():
    """The plain dilated conv computed in f32 and rounded once to its
    inputs' dtype, for the duration."""
    plain = dilated_ops.conv3x3_dilated_plain
    dilated_ops.conv3x3_dilated_plain = lambda x, w, d: plain(x.float(), w.float(), d).to(x.dtype)
    try:
        yield
    finally:
        dilated_ops.conv3x3_dilated_plain = plain


@contextlib.contextmanager
def dx_shapes_recorded():
    """The forward shapes (input shape, Cout, dilation) of every dx launch
    of the dilated conv kernel, for the duration."""
    launch, seen = dilated_ops.conv3x3_dilated_dx_cuda, set()

    def recorded(grad, weight, dilation, packed_dx=None):
        seen.add(((grad.shape[0], weight.shape[1], *grad.shape[2:]), weight.shape[0], dilation))
        return launch(grad, weight, dilation, packed_dx)

    dilated_ops.conv3x3_dilated_dx_cuda = recorded
    try:
        yield seen
    finally:
        dilated_ops.conv3x3_dilated_dx_cuda = launch


def step_times(models: dict, batch: dict, objective: str, cfg, steps: int) -> dict:
    """Median CUDA-event time of a train step (SGD on f32 master weights)
    of each model over ``steps`` steps, the models' steps alternating, the
    first of each left out."""
    tr = cfg.TRAIN
    runs = {}
    for path, model in models.items():
        tx, _ = make_optimizer(cfg, 1, model)
        runs[path] = [make_train_step(tx, int(cfg.dataset.NUM_CLASSES),
                                      ohem_fraction=float(tr.ohem_fraction) or None,
                                      aux_weight=float(tr.aux_loss_weight), objective=objective,
                                      propagate=str(cfg.network.propagate),
                                      remat=bool(tr.remat)),
                      init_train_state(model, tx)]
    times = {path: [] for path in runs}
    for _ in range(steps + 1):
        for path, run in runs.items():
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            run[1], metrics = run[0](run[1], batch)
            b.record()
            b.synchronize()
            check(math.isfinite(float(metrics["loss"])), f"a timed {path} step's loss")
            times[path].append(a.elapsed_time(b))
    return {path: statistics.median(t[1:]) for path, t in times.items()}


def step_peak_memory(model, batch: dict, objective: str, cfg) -> int:
    """Peak device memory of two train steps of ``model`` (its f32 master
    weights and momentum included) from an emptied cache."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step_times({"kernels": model}, batch, objective, cfg, 1)
    return torch.cuda.max_memory_allocated()


# the least per-tensor gradient cosine of a bf16 train step whose dilated
# convs run on the kernel, against cuDNN's step: the plain step with every
# routed conv exactly rounded (the kernel's arithmetic) reaches 0.9949-0.9951
# in R101's first layers, the kernel step 0.9949-0.9958 (PERF.md, H100 runs)
BF16_DILATED_COSINE = 0.98


def e2e_train(phase: str, cfg_name: str, root: Path, data: Path, per_step: dict,
              eval_per_clip: dict | None, set_network: tuple = ()) -> dict[str, int]:
    """Phase 14 for one cfg: the train entry point for one epoch, with the
    exact launches per step (``per_step``) and finite losses; the eval
    entry point on its checkpoint (``eval_per_clip`` launches; None: no
    eval); kernels against plain on one step from the checkpoint's
    weights, in bf16 and f32; the bf16 step times of the two, their steps
    alternating, and the kernel step's peak memory with one model alive.
    Returns the entry point's launches."""
    path = eval_cfg(cfg_name, root, data, stem=phase, end_epoch=1)
    flags = [a for kv in set_network for a in ("--set-network", kv)]
    cfg = load_config(str(path))
    eval_entry.apply_network_overrides(cfg, set_network)
    objective = str(cfg.TRAIN.objective)
    dilated = cfg.network.get("dilated_conv") == "pallas"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    state = train_entry.main(["--cfg", str(path), "--frequent", "1", *flags])
    wall_s = time.perf_counter() - t0
    launched, steps = counts(), state.step
    entry_peak = torch.cuda.max_memory_allocated()
    del state
    out_dir = root / "out" / phase / cfg.dataset.image_set
    prefix = out_dir / cfg.TRAIN.model_prefix
    rows = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows]
    expected = {name: steps * n for name, n in per_step.items()}
    check(launched == expected, f"{phase} launches {launched} != {expected} ({steps} steps)")
    check(steps > 1 and len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"{phase}: {steps} steps, losses {losses}")
    check((prefix / "0.pt").is_file(), f"{phase}: no checkpoint at {prefix}")

    result, eval_launched = None, None
    if eval_per_clip is not None:
        torch.cuda.empty_cache()
        reset_counts()
        (result,) = eval_entry.main(["--cfg", str(path), "--max-items", "1", *flags])
        eval_launched = counts()
        check(eval_launched == eval_per_clip,
              f"{phase} eval launches {eval_launched} != {eval_per_clip}")
        check(0.0 <= result["miou"] <= 1.0 and result["stats"]["frames"] == K,
              f"{phase} eval: miou {result['miou']}, {result['stats']['frames']} frames")

    # kernels against plain: the checkpoint's weights with live flow heads, one
    # batch, in the cfg's bf16 (then the step times) and in f32
    torch.cuda.empty_cache()
    imdb = Cityscape(cfg.dataset.image_set, str(root / f"cache_{phase}"), str(data))
    loader = (TrainClipLoader if objective == "clip" else TrainPairLoader)(imdb, cfg, seed=1)
    host = next(iter(loader))
    batch = to_device(host, "cuda", keys=tuple(host))
    if objective == "clip":
        frames = batch["clip"].permute(0, 1, 3, 4, 2)
    else:
        frames = torch.stack([batch["data_ref"], batch["data"]], dim=1).permute(0, 1, 3, 4, 2)

    def model_of(c, weights, use_kernels):
        m = build_model(c, device="cuda", generator=torch.Generator().manual_seed(SEED),
                        use_kernels=use_kernels)
        m.load_state_dict(weights)
        return m

    live = model_of(cfg, load_checkpoint(str(prefix), 0)["model"], True)
    max_flow = live_flow_heads(live, frames, SEED + 61)
    check(max_flow > 0.5, f"{phase}: flow {max_flow} too small to exercise the warp")
    weights = {name: t.cpu() for name, t in live.state_dict().items()}
    del live
    compared, times = {}, {}
    for dtype in ("bfloat16", "float32"):
        c = cfg.clone()
        c.network["dtype"] = dtype
        models = {path: model_of(c, weights, path == "kernels") for path in ("kernels", "plain")}
        with dx_shapes_recorded() as dx_shapes:
            runs = {path: loss_and_grads(m, batch, objective, c) for path, m in models.items()}
        if dtype == "bfloat16" and dilated:
            check(dx_shapes and dx_shapes <= set(TRAIN_DILATED),
                  f"{phase}: dx shapes {sorted(dx_shapes)} not all held by grad_dilated_conv")
            # the bf16 rounding floor: the plain step with every routed conv
            # exactly rounded (f32 products and sums, one rounding: the
            # kernel's own arithmetic) against cuDNN's bf16 plain step
            with exactly_rounded_dilated_plain():
                runs["exact"] = loss_and_grads(models["plain"], batch, objective, c)
        check(runs["kernels"][2] == per_step,
              f"{phase} {dtype} kernel step launches {runs['kernels'][2]}")
        check(not any(runs["plain"][2].values()),
              f"{phase}: the plain step launched {runs['plain'][2]}")
        compared[dtype] = {path: grad_agreement(run, runs["plain"])
                           for path, run in runs.items() if path != "plain"}
        del runs
        if dtype == "bfloat16":
            t = step_times(models, batch, objective, c, TIMED_STEPS)
            times.update(step_ms=t["kernels"], plain_step_ms=t["plain"])
            del models["plain"]
            times["peak_memory_bytes"] = step_peak_memory(models["kernels"], batch, objective, c)
            times["dx_shapes"] = sorted(dx_shapes)
        del models
        torch.cuda.empty_cache()
    emit(dict(phase=phase, cfg=f"experiments/cfgs/{cfg_name}.yaml", set_network=list(set_network),
              objective=objective, batch={k: list(v.shape) for k, v in batch.items()},
              remat=bool(cfg.TRAIN.remat), dtype=str(cfg.network.dtype),
              entry_point=dict(steps=steps, losses=losses, wall_s=wall_s, launches=launched,
                               launches_per_step={k: v / steps for k, v in launched.items()},
                               peak_memory_bytes=entry_peak),
              eval=None if result is None else dict(miou=result["miou"],
                                                    fps=result["stats"]["fps"],
                                                    launches=eval_launched),
              max_abs_flow=max_flow, kernels_vs_plain=compared, timed_steps=TIMED_STEPS,
              **times, card=card()))
    # the loss within 1e-3 and every parameter's gradient at cosine >= 0.999;
    # in bf16 with the dilated convs on the kernel, every gradient (and the
    # exactly rounded control's) at BF16_DILATED_COSINE
    for dtype, c in compared.items():
        for path, k in c.items():
            floor = BF16_DILATED_COSINE if dtype == "bfloat16" and dilated else 0.999
            check(k["loss_rel_diff"] <= 1e-3, f"{phase} {dtype} {path}: loss {k}")
            check(k["cosine_min"] >= floor, f"{phase} {dtype} {path}: gradient cosines {k}")
    del batch
    torch.cuda.empty_cache()
    return launched


def write_mxnet_params(path: Path, arrays: dict) -> None:
    """An MXNet NDArray-list ``.params`` file (the V2 dense f32 records
    ``utils/mxnet_io.py`` reads) of ``arrays`` {'arg:name' | 'aux:name':
    float32 array}."""
    with open(path, "wb") as f:
        f.write(struct.pack("<QQQ", 0x112, 0, len(arrays)))
        for a in arrays.values():
            f.write(struct.pack(f"<Iii{a.ndim}qiii", 0xF993FAC9, 0, a.ndim, *a.shape, 1, 0, 0))
            f.write(a.astype("<f4").tobytes())
        f.write(struct.pack("<Q", len(arrays)))
        for name in arrays:
            f.write(struct.pack("<Q", len(name)) + name.encode())


def write_caffe_resnet(path: Path, depth: int, seed: int) -> int:
    """A ResNet-``depth`` ``.params`` with the Caffe/MSRA names of the
    reference's pretrained files (``caffe_resnet_table``), every tensor of
    the port's backbone at its shape, random values from ``seed`` (convs
    at variance 1/fan_in, BN scales near 1, small biases and means,
    variances near 1), and ImageNet's ``fc1000`` classifier, which nothing
    takes. Returns the number of backbone tensors written."""
    shapes = {k: tuple(v.shape) for k, v in DilatedResNet(depth, device="meta").state_dict().items()}
    g = torch.Generator().manual_seed(seed)
    arrays = {}
    for name, key in caffe_resnet_table(depth).items():
        if key not in shapes:  # a block that keeps its shape has no branch1
            continue
        shape = shapes[key]
        if len(shape) == 4:
            t = torch.randn(shape, generator=g) / math.sqrt(shape[1] * shape[2] * shape[3])
        elif key.endswith(("weight", "running_var")):
            t = 0.5 + torch.rand(shape, generator=g)
        else:
            t = 0.1 * torch.randn(shape, generator=g)
        arrays[f"{'aux' if 'running' in key else 'arg'}:{name}"] = t.numpy()
    n = len(arrays)
    arrays["arg:fc1000_weight"] = torch.randn((1000, 2048), generator=g).numpy()
    write_mxnet_params(path, arrays)
    return n


def e2e_train_bn(root: Path, data: Path) -> dict[str, int]:
    """Phase 17: running-stat BatchNorm trained from pretrained weights. A
    full ResNet-101 ``.params`` with Caffe names and random values is
    written; the pair cfg with ``norm: batchnorm`` (conv7 stem) and
    ``pretrained`` naming that file trains one epoch (2 steps) through the
    train entry point, with 1 warp a step; every backbone tensor of the
    file lands in the reference branch (``apply_pretrained_cfg``'s report)
    and the checkpoint's running statistics moved from the file's and are
    finite. Then, from the checkpoint's weights with live flow heads, one
    pair step (batch statistics in the pair forward, running statistics in
    the aux passes, then the commit) with the kernels and with the plain
    versions on one batch, in the cfg's bf16: the loss within 1e-3
    relative, every gradient at cosine >= 0.999 and every running
    statistic within 1e-3 relative of the plain step's (the backbones
    hold no kernel on this path, so the statistics come out equal).
    Returns the entry point's launches."""
    phase = "e2e_train_bn"
    flags = ["--set-network", "norm=batchnorm", "--set-network", "stem=conv7",
             "--set-network", f"pretrained={root / 'resnet'}"]
    path = eval_cfg("accel18_cityscapes_pair", root, data, stem=phase, end_epoch=1)
    cfg = load_config(str(path))
    eval_entry.apply_network_overrides(cfg, flags[1::2])
    depth = int(cfg.network.ref_depth)
    n_file = write_caffe_resnet(root / "resnet-0000.params", depth, SEED + 100)
    backbone = DilatedResNet(depth, norm="batchnorm").state_dict()
    merged, reports = apply_pretrained_cfg(cfg, {f"ref_net.backbone.{k}": v
                                                 for k, v in backbone.items()})
    check(reports["ref"]["matched"] == n_file and reports["ref"]["unmatched"] == ["fc1000_weight"],
          f"{phase}: pretrained merge {reports['ref']['matched']} of {n_file}, "
          f"unmatched {reports['ref']['unmatched']}")
    reset_counts()
    t0 = time.perf_counter()
    state = train_entry.main(["--cfg", str(path), "--frequent", "1", *flags])
    wall_s = time.perf_counter() - t0
    launched, steps = counts(), state.step
    del state
    out_dir = root / "out" / phase / cfg.dataset.image_set
    rows = [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows]
    check(launched == launches_of(warp=steps), f"{phase} launches {launched} ({steps} steps)")
    check(steps == 2 and all(math.isfinite(x) for x in losses), f"{phase}: losses {losses}")
    ckpt = load_checkpoint(str(out_dir / cfg.TRAIN.model_prefix), 0)["model"]
    stat_keys = [k for k in ckpt if k.endswith(("running_mean", "running_var"))]
    check(all(torch.isfinite(ckpt[k]).all() for k in stat_keys), f"{phase}: running stats")
    file_stats = [k for k in merged if k.endswith(("running_mean", "running_var"))]
    trained_moved = sum(not torch.equal(ckpt[k], merged[k]) for k in file_stats)
    check(trained_moved == len(file_stats),
          f"{phase}: {trained_moved} of the file's {len(file_stats)} statistics moved")

    imdb = Cityscape(cfg.dataset.image_set, str(root / f"cache_{phase}"), str(data))
    host = next(iter(TrainPairLoader(imdb, cfg, seed=1)))
    batch = to_device(host, "cuda", keys=tuple(host))
    frames = torch.stack([batch["data_ref"], batch["data"]], dim=1).permute(0, 1, 3, 4, 2)
    models = {}
    for path_name in ("kernels", "plain"):
        m = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED),
                        use_kernels=path_name == "kernels")
        m.load_state_dict(ckpt if path_name == "kernels" else models["kernels"].state_dict())
        if path_name == "kernels":
            max_flow = live_flow_heads(m, frames, SEED + 101)
            check(max_flow > 0.5, f"{phase}: flow {max_flow} too small to exercise the warp")
        models[path_name] = m
    runs = {p: loss_and_grads(m, batch, "pair", cfg) for p, m in models.items()}
    check(runs["kernels"][2] == launches_of(warp=1), f"{phase}: step launches {runs['kernels'][2]}")
    check(not any(runs["plain"][2].values()), f"{phase}: the plain step launched")
    agreement = grad_agreement(runs["kernels"], runs["plain"])
    stats = {p: {k: v for k, v in m.state_dict().items() if k in stat_keys}
             for p, m in models.items()}
    stat_err = max(((stats["kernels"][k] - stats["plain"][k]).abs().max()
                    / stats["plain"][k].abs().max().clamp_min(1e-12)).item() for k in stat_keys)
    stat_moved = sum(not torch.equal(stats["kernels"][k], ckpt[k].cuda()) for k in stat_keys)
    emit(dict(phase=phase, cfg="experiments/cfgs/accel18_cityscapes_pair.yaml",
              set_network=flags[1::2], pretrained_tensors=n_file,
              entry_point=dict(steps=steps, losses=losses, wall_s=wall_s, launches=launched,
                               file_statistics_moved=trained_moved),
              batchnorms=sum(isinstance(x, BatchNorm) for x in models["kernels"].modules()),
              max_abs_flow=max_flow, kernels_vs_plain=agreement,
              running_stats_max_rel_err=stat_err, running_stats=len(stat_keys),
              running_stats_moved_by_the_step=stat_moved, card=card()))
    check(agreement["loss_rel_diff"] <= 1e-3, f"{phase}: loss {agreement}")
    check(agreement["cosine_min"] >= 0.999, f"{phase}: gradient cosines {agreement}")
    check(stat_err <= 1e-3, f"{phase}: running statistics differ by {stat_err}")
    check(stat_moved == len(stat_keys), f"{phase}: {stat_moved} of {len(stat_keys)} moved")
    del models, batch
    torch.cuda.empty_cache()
    return launched


@functools.cache
def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


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
    floor = launch_floor()
    kernel_warp(results)
    kernel_upsample_argmax(results)
    kernel_fused_stem(results)
    kernel_warp_onehot(results)
    kernel_dilated_conv(results)
    grad_warp()
    grad_dilated_conv(results)
    grad_fused_stem()
    grad_warp_onehot()
    torch.cuda.empty_cache()
    small_reference()
    accel_launched, accel_groups = e2e_bench()
    torch.cuda.empty_cache()
    e2e_flagship()
    torch.cuda.empty_cache()
    dff_launched, dff_groups, dff_state = e2e_dff()
    torch.cuda.empty_cache()
    e2e_dff_fc6(dff_state)
    del dff_state
    torch.cuda.empty_cache()
    deeplab_launched = e2e_deeplab()
    torch.cuda.empty_cache()
    # per-frame serving: a key frame runs both stems, a non-key frame the
    # update branch's stem and one warp; every frame one tail
    stream_launched = e2e_stream(
        "e2e_stream", "accel18 frozenbn fused7 bf16 push_frame", BENCH_NET, SEED + 16,
        launches_of(fused_stem=2 + (K - 1), warp=K - 1, upsample_argmax=K), overall=0.99)
    torch.cuda.empty_cache()
    dff_stream_launched = e2e_stream(
        "e2e_dff_stream", "dff101 frozenbn fused7 bf16 onehot native D=4 push_frame", DFF_NET,
        SEED + 18, launches_of(fused_stem=1, warp_onehot=K - 1, upsample_argmax=K),
        overall=0.98)
    torch.cuda.empty_cache()
    # a direct group: both stems, one batched warp, one tail
    direct_group = launches_of(fused_stem=2, warp=1, upsample_argmax=1)
    fast_launched = e2e_variant("e2e_fast", "accel18_fast bf16", FAST_NET, "direct",
                                SEED + 20, direct_group)
    torch.cuda.empty_cache()
    os8_launched = e2e_variant("e2e_os8mixed", "accel18_os8mixed bf16", OS8MIXED_NET, "direct",
                               SEED + 22, direct_group)
    torch.cuda.empty_cache()
    # composed: k-2 flow-field warps and one feature warp (scale_cascade
    # 'last' warps no scale field)
    composed_launched = e2e_variant(
        "e2e_composed", "accel18 frozenbn fused7 bf16 composed", BENCH_NET, "composed",
        SEED + 24, launches_of(fused_stem=2, warp=(K - 2) + 1, upsample_argmax=1))
    torch.cuda.empty_cache()
    dff_composed_launched = e2e_variant(
        "e2e_dff_composed", "dff101 frozenbn fused7 bf16 onehot native composed", DFF_NET,
        "composed", SEED + 26, launches_of(fused_stem=1, warp_onehot=(K - 2) + 1,
                                           upsample_argmax=1), overall=0.98)
    torch.cuda.empty_cache()
    quant_launched = e2e_quant()
    torch.cuda.empty_cache()
    fold_launched = e2e_fold()
    torch.cuda.empty_cache()
    # eval from the cfg files: the flagship's 4 step warps and one tail per
    # clip (groupnorm + conv7, no stem kernel); DFF's one batched one-hot
    # warp and one tail
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        root = Path(tmp)
        data, valid_per_clip = write_eval_tree(root)
        eval_launched = e2e_eval("e2e_eval", "accel18_cityscapes", root, data, valid_per_clip,
                                 launches_of(warp=K - 1, upsample_argmax=1), overall=0.99)
        torch.cuda.empty_cache()
        dff_eval_launched = e2e_eval("e2e_eval_dff", "dff_cityscapes", root, data,
                                     valid_per_clip, launches_of(warp_onehot=1, upsample_argmax=1),
                                     overall=0.98)
    # training from the cfg files, one epoch each. The flagship's clip step
    # (remat): 4 step warps, and the same 4 again when the backward recomputes
    # each checkpointed step. With every dilated conv on the kernel: a R101
    # pass has 4 (3 layer4 conv2 + fc6), a R18 pass 5 (4 layer4 convs + fc6);
    # the key forward (1 R101) and the 5 frame outputs (5 R18) run again under
    # remat, the aux loss (1 R101 + 1 R18) does not: 4 + 25 + 9 = 38 forward,
    # 4 + 25 = 29 recomputed, 38 dx. The pair step: 1 warp. Eval of a
    # checkpoint: the flagship's 4 step warps and 1 tail, the pair cfg's one
    # direct warp and 1 tail.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = Path(tmp)
        data = write_train_tree(root)
        train_launched = e2e_train("e2e_train", "accel18_cityscapes", root, data,
                                   launches_of(warp=2 * (K - 1)),
                                   launches_of(warp=K - 1, upsample_argmax=1))
        pair_launched = e2e_train("e2e_train_pair", "accel18_cityscapes_pair", root, data,
                                  launches_of(warp=1), launches_of(warp=1, upsample_argmax=1))
        dilated_launched = e2e_train(
            "e2e_train_dilated", "accel18_cityscapes", root, data,
            launches_of(warp=2 * (K - 1), dilated_conv=38 + 29, dilated_conv_dx=38), None,
            set_network=("dilated_conv=pallas",))
        bn_launched = e2e_train_bn(root, data)
    # each kernel with the launches of one path it serves: (path, launches, groups)
    paths = {name: ("accel18", accel_launched[name], accel_groups)
             for name in ("warp", "upsample_argmax", "fused_stem")}
    paths["warp_onehot"] = ("dff", dff_launched["warp_onehot"], dff_groups)
    paths["dilated_conv"] = ("deeplab101 pallas", deeplab_launched["dilated_conv"], 1)
    by_path = {"accel18": accel_launched, "dff": dff_launched,
               "deeplab101 pallas": deeplab_launched, "accel18 push_frame": stream_launched,
               "dff push_frame": dff_stream_launched, "accel18_fast": fast_launched,
               "accel18_os8mixed": os8_launched, "accel18 composed": composed_launched,
               "dff composed": dff_composed_launched, "accel18 cfg eval": eval_launched,
               "dff cfg eval": dff_eval_launched, "accel18 clip train": train_launched,
               "accel18 pair train": pair_launched,
               "accel18 clip train dilated_conv=pallas": dilated_launched,
               "accel18 int8": quant_launched, "accel18_fast fold": fold_launched,
               "accel18 pair train batchnorm pretrained": bn_launched}

    keys = ("max_abs_err", "shape", "ms", "device_ms", "host_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms", "library_call")
    emit({"kernels": [
        dict(name=name, route="cuda", source=f"accel_tpu_torch/kernels/{name}.cu",
             replaces=REPLACES[name], path=paths[name][0], launches=paths[name][1],
             launches_per_group=paths[name][1] / paths[name][2],
             launches_by_path={path: n[name] for path, n in by_path.items()},
             launch_floor_device_ms=floor["device_ms"],
             **{k: results[name][k] for k in keys},
             **({} if name != "dilated_conv" else dict(
                 dx_launches_by_path={path: n["dilated_conv_dx"] for path, n in by_path.items()},
                 dx={k: results["dilated_conv_dx"][k] for k in keys})))
        for name in LAUNCHERS]})
    print(card(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
