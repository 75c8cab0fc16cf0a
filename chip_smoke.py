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
   read by ``device_ms`` against the launch floor. The 2x upsample (#6,
   ``kernel_upsample2x``) at FlowNet-S's resize shapes, N=1 and 4, bf16 and
   f32: the elements that differ from its plain version, ``F.interpolate``
   (none), and the library's NCHW and channels-last times beside the
   kernel's. Every path that runs FlowNet-S launches #6
   ``FLOW_RESIZES`` (8) times a FlowNet pass: its four feature resizes and
   its four flow resizes.
3. small_reference: a tiny f32 Accel model on the card (kernels) against
   the same model on the CPU (plain versions): logits and class maps.
4. e2e: Accel-18 (R101 keyframe branch, R18 update branch, FlowNet-S at
   full width, frozenbn + fused7 stem, bf16) at 1024x2048, B=1, k=5,
   through ``VideoSegmenter.push_group``: three incremental + 'last'
   groups and one direct group, with every kernel launch counted (the
   third incremental group replays a CUDA graph: no launch wrapper runs,
   see phase 26); then the
   same groups with every kernel replaced by its plain version, and the
   two compared as two bf16 paths are (``compare_paths``: logits, and class
   maps overall and off bf16 near-ties); then the plain path with only the
   stem through its kernel, whose class maps the kernel path must match on
   >= 0.999 of the pixels.
5. e2e_flagship: one incremental + 'last' group with the flagship cfg's
   groupnorm + conv7 stem + scale_field_norm mean1 (the launches counted
   at the CUDA graph's capture, the ms of a replay).
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
   frame, a tail per frame) counted call by call on the main path's own
   run (``frame_launches``: each step's eager and capturing calls launch
   them, every later call replays and launches none), its maps bit-equal
   at every frame to the key/cur predictors' eager ones
   (``eager_push_frame``), which are held against ``push_group`` on the
   same frames, of the kernel model and of the plain model
   (``compare_class_maps``); then both protocols timed on the host clock
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
    The loader's ms per frame through its C++ host ops (``native/``) and
    through the numpy ops, whose batches must be equal, and each op's ms
    both ways (``loader_breakdown``).

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
    incremental group through ``push_frame`` (its steps' eager and
    capturing calls launch, the later frames replay), with the exact
    launches of #1-#3 (no #5: int8 takes precedence) and the exact number of int8
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
18. e2e_export: the Accel-18 bench row, direct, exported through
    ``core/export.py`` (``torch.export``; the five kernels as
    ``torch.ops.accel_tpu_torch`` ops) with a symbolic batch and the weights
    embedded, written, loaded and run at B=1 and B=4, with the exact
    launches per group, its class maps against ``push_group`` of the same
    model (identical, or printed and held to ``compare_class_maps``'
    limits), the export and load seconds, the artifact's MB and the loaded
    group's ms against ``push_group``'s (CUDA events, alternating turns).
19. e2e_export_args: the same row with the weights as an argument (B=1):
    called with the state dict, then again after the key stem's weight is
    doubled with ``copy_``: the class maps follow the write, equal to
    ``push_group``'s after it (the kernels' packings are traced).
20. e2e_export_dff: the DFF row, direct, exported and loaded (B=1): one
    #4 with the scale fused, one #3, one #2; class maps against
    ``push_group``. e2e_export_deeplab_pallas: per-frame DeepLab-101 with
    ``dilated_conv: pallas`` exported and served frame by frame: #5
    through its op, 4 launches a frame; class maps against ``push_group``.
21. e2e_noscale: ``use_scale_field: false``: Accel-18 incremental through
    ``push_group`` and ``push_frame`` and DFF direct (#4 with no scale),
    against the plain path, with the exact launches.
22. e2e_quant_small: the int8 row at B=1 on 64x64 frames (GEMMs of 16
    rows) and with ``head_channels`` 1020 (k and n not multiples of 8),
    against the plain int8 path within ``QUANT_OVERALL``/``QUANT_CLEAR``.
23. e2e_dp_nccl, e2e_dp_train, e2e_dp_train_bn, e2e_dp_eval: data
    parallelism (``parallel/mesh.py``) on the training tree: the flagship
    step under an NCCL group of one (bit-equal to no group), then two gloo
    ranks on the one card (processes of this script, ``--dp-rank``)
    against one process: the flagship step (f32 at section 2's train
    limits; bf16 as shipped), the batchnorm pair step, and the flagship
    cfg's eval through the eval entry point (the confusion matrix
    exactly), and again with ``--quantize`` (``e2e_dp_eval_int8``: every
    int8 call's activation scale maxed over the ranks, equal on both, in
    f32 with FrozenBN equal to one process's, the confusion against one
    process's quantized eval on the same global batches within
    ``DP_INT8_RUNS``' limits, and a control with each rank's own scales
    held outside them); the ranks' masters
    bit-equal, their launches exact, their step and all-reduce ms
    (``e2e_dp``).
24. e2e_spatial, e2e_spatial_eval: the spatial axis (``parallel/spatial.py``):
    two gloo ranks on the one card (``--dp-rank``), ``tpu.mesh.spatial:
    2``, each on its 512 rows of every 1024x2048 frame, against one
    process: a B=1 group of the Accel-18 bench row (incremental; #1-#3),
    of it with the flagship norm in bf16 and in f32, the DFF row (direct;
    #4), one DeepLab-101 frame with ``dilated_conv: pallas`` (#5), the
    int8 bench row in bf16 and in f32 (#1-#3; each int8 call's activation
    scale equal on the ranks, in f32 within ``SPATIAL_SCALE_REL`` of one
    process's), the folded fast model (direct; #1, #2) and the bench row
    with the s2d stem (#1, #2); every
    kernel launch of a rank held against its plain version on the
    halo-extended shard it was given; each rank's class-map rows held to
    the one-process rows by ``check_class_maps`` over the shard and over
    its band at the shard boundary (the bf16 flagship through the same
    weights in f32), its launches exactly, its halo exchanges and bytes,
    peak memory and ms a group printed beside one process's; then the
    flagship cfg's eval through the eval entry point with
    ``tpu.mesh.spatial: 2`` against the one-process entry point
    (``e2e_spatial``).
25. e2e_spatial_train: training under the spatial axis, two gloo ranks on
    the one card, ``tpu.mesh.spatial: 2``, each on its 384 rows of the
    flagship's 768x768 crops, against one process on the whole batch, two
    steps a case: the flagship clip step in f32 (section 2's train limits)
    and in bf16 (as ``e2e_dp_train`` holds bf16), the flagship with
    ``dilated_conv: pallas`` (every #1 and #5 launch of a rank, forward,
    recomputed and dx, held against its plain version on the inputs it was
    given), the batchnorm pair step in f32 (B=4; the running statistics),
    the flagship step in f32 with ``stem: s2d`` and ``fold_flow_downscale``,
    and the train entry point under ``torchrun``'s variables (its losses
    and checkpoint against the one-process entry point's); the masters
    bit-equal across the ranks, each rank's exact launches, its exchanges
    and all-reduces in forward, recompute and backward, halo bytes, step
    ms and peak memory beside one process's (``e2e_spatial_train``).

26. e2e_graphs: ``push_group`` from CUDA graphs (``core/graphs.py``): for
    Accel-18 as the benchmark serves it and direct and composed, the DFF
    row as the benchmark serves it and DeepLab-101, at B=1 and B=4, a
    segmenter's eager, capturing and replaying calls, each bit-equal to
    ``clip_predictions`` on its own frames, then a replay on the first
    frames again; the capturing call's exact launches equal to the eager
    call's, a replay's none; a returned map unchanged by later calls; a
    profiled replay one launch call (``cudaGraphLaunch``) with every
    kernel of the eager call in its device trace; the group's CUDA-event
    ms, eager against replayed, in alternating turns. The folded fast model
    (a host copy inside the call) fails its capture and is served eagerly.
    Then ``push_frame`` from CUDA graphs, for Accel-18 incremental, the DFF
    row direct and DeepLab-101: three segmenters of one model interleaved
    over two keyframe groups each, every class map bit-equal to the key/cur
    predictors' eager maps; the key and cur graphs shared by the three (one
    capture each), each step's capturing call launching what its eager
    call launched, every later call a replay with no Python launch
    wrapper; the returned maps and carried tensors unchanged by the later
    calls; a profiled replayed key and cur frame one launch call
    (``cudaGraphLaunch``) each, with every kernel of the step's eager call
    in its device trace, as many times, and its copies in and out counted
    and timed on the device; the untraced host ms of the weights' version stamp; key
    and cur ms eager against replayed, in alternating turns.

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
import hashlib
import json
import logging
import math
import os
import re
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import warnings
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from accel_tpu_torch import kernels, native
from accel_tpu_torch.config import load_config
from accel_tpu_torch.core.checkpoint import load_checkpoint
from accel_tpu_torch.core.export import export_serving, load_serving
from accel_tpu_torch.core.graphs import CallGraphs
from accel_tpu_torch.core import trainer as trainer_module
from accel_tpu_torch.core.pipeline import (
    clip_logits,
    clip_loss_and_stats,
    clip_predictions,
    pair_loss_and_stats,
    running_stats,
)
from accel_tpu_torch.core.predictor import DataBatch, make_key_cur_predictors, pred_eval_clips
from accel_tpu_torch.core.pretrained import apply_pretrained_cfg, caffe_resnet_table
from accel_tpu_torch.core.serving import VideoSegmenter
from accel_tpu_torch.core.trainer import init_train_state, make_optimizer, make_train_step
from accel_tpu_torch.data.cityscapes import ANNOTATED_FRAME, Cityscape
from accel_tpu_torch.data import image as image_module
from accel_tpu_torch.data import png
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
from accel_tpu_torch.ops import upsample as upsample_ops
from accel_tpu_torch.ops import upsample_argmax as ua_ops
from accel_tpu_torch.ops import warp as warp_module
from accel_tpu_torch.ops import warp_cuda as warp_ops
from accel_tpu_torch.ops import warp_onehot as onehot_ops
from accel_tpu_torch.parallel import spatial
from accel_tpu_torch.parallel.mesh import mesh_from_cfg, replicated, shard_batch

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
    "upsample2x": upsample_ops.upsample2x_cuda,
}
REPLACES = {
    "warp": "accel_tpu/ops/warp_pallas.py:84",
    "upsample_argmax": "accel_tpu/ops/upsample_argmax.py:48",
    "fused_stem": "accel_tpu/ops/fused_stem.py:84",
    "warp_onehot": "accel_tpu/ops/warp_onehot.py:117",
    "dilated_conv": "accel_tpu/ops/dilated_pallas.py:96",
    "upsample2x": "no TPU kernel: XLA's resize in accel_tpu/ops/upsample.py",
}
# #6's launches a FlowNet-S pass: its decoder's four 2x feature resizes (bf16)
# and four 2x flow resizes (f32)
FLOW_RESIZES = 8


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
    propagation's final warp at D=8*(k-1)=32, its 2-channel flow fields
    at D=8, and a spatial rank's halo-extended shard of the score map
    (``e2e_spatial``: 32 rows and 9 beyond, a frame at a time and the
    folded model's direct group at once; ``e2e_spatial_train``: two
    clips' 24 rows of a 768x768 crop and 9 beyond). |flow| up to 1.5 D,
    uniform per pixel."""
    rows = []
    for shape, dtype, d in (((1, 19, 64, 128), torch.float32, 8),
                            ((4, 19, 64, 128), torch.float32, 8),
                            ((4, 19, 64, 128), torch.bfloat16, 8),
                            ((1, 19, 45, 60), torch.float32, 8),
                            ((1, 19, 128, 256), torch.float32, 8),
                            ((4, 19, 128, 256), torch.float32, 8),
                            ((4, 19, 64, 128), torch.float32, 8 * (K - 1)),
                            ((1, 2, 64, 128), torch.float32, 8),
                            ((1, 19, 41, 128), torch.float32, 8),
                            ((4, 19, 41, 128), torch.float32, 8),
                            ((2, 19, 33, 48), torch.float32, 8)):
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
    720x960, a non-integer ratio whose bands change inside a thread's
    run of rows, and a spatial rank's extended shard of a group (33 rows
    to 528, cropped to 512 by ``e2e_spatial``). Each row's class map agrees with the plain version's on
    >= 0.9999 of the pixels, every disagreement at a near-tie."""
    rows = []
    for shape, out_hw in (((5, 19, 64, 128), (H, W)), ((20, 19, 64, 128), (H, W)),
                          ((1, 19, 64, 128), (H, W)), ((5, 19, 128, 256), (H, W)),
                          ((2, 19, 45, 60), (720, 960)), ((3, 11, 12, 20), (128, 256)),
                          ((5, 19, 33, 128), (528, W))):
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
    half-resolution frames, CamVid's frame, an unaligned one and a spatial
    rank's extended shard of a frame (512 rows and 8 beyond, stem and max
    pool on one shard), that shard in f32 too (the int8 row in f32)."""
    rows = []
    for shape, dtype in (((4, 3, H, W), torch.bfloat16), ((1, 3, H, W), torch.bfloat16),
                         ((5, 3, H // 2, W // 2), torch.bfloat16),
                         ((1, 3, 720, 960), torch.bfloat16),
                         ((1, 3, 30, 34), torch.bfloat16), ((1, 3, H, W), torch.float32),
                         ((1, 3, H // 2 + 8, W), torch.bfloat16),
                         ((1, 3, H // 2 + 8, W), torch.float32)):
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
    cascades), and a spatial rank's extended shard of the DFF direct warp
    (32 rows and 5 beyond: a band that is not a multiple of the kernel's
    band rows, on the TMA path). |flow_y| up to 1.5 D (clamped), |flow_x| up to 3 D (not
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
            ((1, 1024, 64, 128), torch.float32, False, False, 4),
            ((4, 1024, 37, 128), torch.bfloat16, True, False, 4)):
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
    channels-last. The plain version is the library call. The last rows
    are a spatial rank's extended shards: fc6 in eval (32 rows and 6
    beyond), and R101's fc6 and layer4 conv2 in training (two clips' 24
    rows of a 768x768 crop, and 6 or 2 beyond)."""
    rows = []
    for shape, cout, d, dtype in (((1, 2048, 64, 128), 1024, 6, torch.bfloat16),  # fc6
                                  ((1, 512, 64, 128), 512, 2, torch.bfloat16),    # layer4 conv2
                                  ((1, 2048, 45, 60), 1024, 6, torch.bfloat16),   # not TPU-tileable
                                  ((1, 128, 16, 32), 128, 8, torch.float32),
                                  ((1, 2048, 38, 128), 1024, 6, torch.bfloat16),  # fc6 shard
                                  ((2, 2048, 30, 48), 1024, 6, torch.bfloat16),   # train shards
                                  ((2, 512, 26, 48), 512, 2, torch.bfloat16)):
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


# FlowNet-S's 2x resizes at its 512x1024 input: the decoder's features (C, h, w)
# in bf16 and the flow (2, h, w) in f32
FLOWNET_RESIZES = ((386, 64, 128), (770, 32, 64), (1026, 16, 32), (1024, 8, 16))
FLOW_UPFLOWS = ((2, 64, 128), (2, 32, 64), (2, 16, 32), (2, 8, 16))


def kernel_upsample2x(results: dict) -> None:
    """The 2x upsample at FlowNet-S's resize shapes, N=4 (a group's four
    pairs) and N=1 (a ``push_frame`` pair): the four feature shapes in bf16
    and in f32, the four flow shapes in f32; then a ragged width, h = w = 1
    and a tensor one element off a 16-byte boundary (the scalar path).
    Every output equal to the plain version's, ``F.interpolate``'s
    (elements that differ: 0). Timed against the library's NCHW kernel and
    its channels-last one; bound: the input read and the output written
    once. Then the gradient through ``Upsample2xFunction`` against
    autograd through ``F.interpolate``. Per N the summed device ms of a
    pass's eight resizes as the path runs them (``per_pass``) and the
    library's."""
    rows, per_pass = [], {}
    cases = [((n, *s), dt) for n in (4, 1) for s in FLOWNET_RESIZES
             for dt in (torch.bfloat16, torch.float32)]
    cases += [((n, *s), torch.float32) for n in (4, 1) for s in FLOW_UPFLOWS]
    for shape, dtype in cases:
        x = torch.randn(shape, generator=_gen(SEED + 17), device="cuda").to(dtype)
        got = upsample_ops.upsample2x_cuda(x)
        plain = upsample_ops.upsample2x_plain(x)
        x_cl = x.contiguous(memory_format=torch.channels_last)
        differ = int((got != plain).sum().item())
        row = dict(kernel="upsample2x", dtype=str(dtype), shape=list(shape), numel=got.numel(),
                   max_abs_err=(got.float() - plain.float()).abs().max().item(),
                   differ_vs_plain=differ,
                   **timed(lambda: upsample_ops.upsample2x_cuda(x),
                           lambda: upsample_ops.upsample2x_plain(x)),
                   library_channels_last_device_ms=device_ms(
                       lambda: upsample_ops.upsample2x_plain(x_cl))["device_ms"],
                   plain_ms=median_ms(lambda: upsample_ops.upsample2x_plain(x)),
                   library_call="F.interpolate(size=(2h, 2w), bilinear): the plain version",
                   **bound(nbytes(x, got), 0, "f32"))
        emit(dict(phase="kernel", **row))
        check(got.dtype == dtype and got.shape == plain.shape and differ == 0,
              f"upsample2x {shape} {dtype}: {differ} elements differ from the plain version")
        if dtype == torch.bfloat16 or shape[1] == 2:  # as the path runs them
            side = per_pass.setdefault(shape[0], dict(device_ms=0.0, library_device_ms=0.0,
                                                      bound_ms=0.0))
            for k in side:
                side[k] += row[k]
        rows.append(row)
        del x, x_cl, got, plain
    flat = torch.randn(2 * 5 * 7 * 16 + 1, generator=_gen(SEED + 18), device="cuda")
    for name, x in (("ragged", torch.randn((2, 5, 7, 13), generator=_gen(SEED + 18),
                                           device="cuda").to(torch.bfloat16)),
                    ("one_by_one", torch.randn((3, 4, 1, 1), generator=_gen(SEED + 18),
                                               device="cuda")),
                    ("misaligned", flat[1:].view(2, 5, 7, 16))):
        differ = int((upsample_ops.upsample2x_cuda(x) != upsample_ops.upsample2x_plain(x)).sum())
        emit(dict(phase="kernel", kernel="upsample2x", case=name, shape=list(x.shape),
                  dtype=str(x.dtype), differ_vs_plain=differ))
        check(differ == 0, f"upsample2x {name}: {differ} elements differ from the plain version")
    x = torch.randn((4, 386, 64, 128), generator=_gen(SEED + 19), device="cuda")
    g = torch.randn((4, 386, 128, 256), generator=_gen(SEED + 20), device="cuda")
    grads = []
    for fn in (upsample_ops.upsample2x, upsample_ops.upsample2x_plain):
        leaf = x.detach().requires_grad_()
        grads.append(torch.autograd.grad(fn(leaf), leaf, g)[0])
    got, want = grads
    err, tol = (got - want).abs().max().item(), 1e-5 * want.abs().max().item()
    emit(dict(phase="grad_upsample2x", shape=list(x.shape), max_abs_err=err, tol=tol,
              per_pass=per_pass))
    check(err <= tol, f"upsample2x gradient: max err {err} > {tol}")
    results["upsample2x"] = rows[0]


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
# take no other shape. Then the same four on a spatial rank's extended shard
# of the crop (e2e_spatial_train: 24 rows and the halo, 6 or 2 beyond).
TRAIN_DILATED = (((2, 2048, 48, 48), 1024, 6), ((2, 512, 48, 48), 1024, 6),
                 ((2, 512, 48, 48), 512, 2), ((2, 256, 48, 48), 512, 2),
                 ((2, 2048, 30, 48), 1024, 6), ((2, 512, 30, 48), 1024, 6),
                 ((2, 512, 26, 48), 512, 2), ((2, 256, 26, 48), 512, 2))


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
    """Re-draw the zero-initialised flow head and the scale field (where
    the model has one) from a seed; the flow head is then scaled (the flow is linear in it) so the
    largest displacement between the first two frames is ``target``
    feature pixels. Returns that displacement."""
    g = torch.Generator().manual_seed(seed)
    fn = model.flownet
    heads = [(fn.predict_flow2, 1.0)] + ([(fn.scale_field, 0.05)] if fn.use_scale_field else [])
    for conv, sigma in heads:
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
    clear, peak, ref_logits = clear_pixels(ref_model, frames, propagate, interval)
    return dict(class_map_agreement(pred[0], ref[0], clear), logits_max_abs=peak), ref_logits


@torch.inference_mode()
def clear_pixels(ref_model, frames: torch.Tensor, propagate: str,
                 interval: int = K) -> tuple[torch.Tensor, float, torch.Tensor]:
    """The pixels of ``frames`` (1, F, H, W, 3) whose top-2 margin in
    ``ref_model``'s stride-level logits, upsampled as the tail does,
    exceeds 1e-2 * max|logits| (F, H, W); that max; the logits."""
    ref_logits = clip_logits(ref_model, frames.permute(0, 1, 4, 2, 3), interval, propagate)[0]
    peak = ref_logits.abs().max().item()
    up = F.interpolate(ref_logits, size=frames.shape[2:4], mode="bilinear", align_corners=False)
    top2 = up.topk(2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) > 1e-2 * peak, peak, ref_logits


def class_map_agreement(pred: torch.Tensor, ref: torch.Tensor, clear: torch.Tensor) -> dict:
    """Two class maps' agreement overall and on the ``clear`` pixels."""
    eq = pred == ref
    return dict(agreement=eq.float().mean().item(), clear_share=clear.float().mean().item(),
                clear_agreement=eq[clear].float().mean().item())


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
    number of groups that ran the launch wrappers: the incremental
    segmenter's third group replays the CUDA graph its second captured
    (``core/graphs.py``), which runs no Python launch wrapper."""
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
    # one batched warp per direct group; one tail per group; of the three
    # incremental groups the first runs eagerly, the second is captured
    # (its launches counted as they are captured) and the third replayed
    wrapped = len(groups) - 1
    check(launched["warp"] == 2 * (K - 1) + 1 and launched["upsample_argmax"] == wrapped
          and launched["upsample2x"] == FLOW_RESIZES * wrapped,
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
    return launched, wrapped


def e2e_flagship() -> None:
    model = build_model(FLAGSHIP_NET, device="cuda",
                        generator=torch.Generator().manual_seed(SEED))
    clip = moving_clip(K, (H, W), SEED + 8, "cuda")
    live_flow_heads(model, clip, SEED + 9)
    seg = VideoSegmenter(model, K, propagate="incremental")
    seg.push_group(clip)  # warm-up
    reset_counts()
    seg.push_group(clip)  # the CUDA graph's capture: the eager call's launches
    launched = counts()
    pred, ms = timed_group(seg, clip)  # a replay
    check_pred(pred, (1, K, H, W))
    emit(dict(phase="e2e_flagship", config="accel18 groupnorm conv7 mean1 bf16", hw=[H, W], B=1,
              k=K, group_ms=ms, fps=K / (ms / 1e3), launches=launched))
    check(launched["warp"] > 0 and launched["upsample_argmax"] > 0,
          "flagship path skipped a kernel")
    check(launched["upsample2x"] == FLOW_RESIZES,
          f"flagship FlowNet resizes {launched['upsample2x']} != {FLOW_RESIZES}")


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
    # a FlowNet pass a group: the direct groups' eager and capturing calls
    # and the incremental group's eager call
    check(launched["upsample2x"] == FLOW_RESIZES * len(groups),
          f"dff FlowNet resizes {launched['upsample2x']} != {FLOW_RESIZES * len(groups)}")
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


# an Accel push_frame's launches: a key frame runs both stems and a tail, a
# non-key frame the update branch's stem, a FlowNet pass, a warp and a tail
ACCEL_FRAME_LAUNCHES = dict(key=launches_of(fused_stem=2, upsample_argmax=1),
                            cur=launches_of(fused_stem=1, warp=1, upsample_argmax=1,
                                            upsample2x=FLOW_RESIZES))


def eager_push_frame(model, propagate: str, frames: torch.Tensor) -> torch.Tensor:
    """The class maps (1, n, H, W) of ``push_frame`` on the frames (1, n,
    H, W, 3) of one stream, as the key/cur predictors that its steps call
    (``make_key_cur_predictors``) make them eagerly: a keyframe every K
    frames (every frame for DeepLab), the prop and anchor carried."""
    key_p, cur_p = make_key_cur_predictors(model, propagate=propagate)
    preds = []
    for i in range(frames.shape[1]):
        if i % K == 0 or model.family == "deeplab":
            out = key_p.predict(DataBatch([frames[:, i]]))[0]
        else:
            out = cur_p.predict(DataBatch([frames[:, i], out["anchor_small"], out["prop"]]))[0]
        preds.append(out["pred"])
    return torch.stack(preds, dim=1)


def frame_launches(calls: list, per_frame: dict) -> tuple[dict[str, int], dict, bool]:
    """The main path's ``push_frame`` launches ``calls`` [(step, launches)]
    (``stream_group``) of segmenters whose steps (``core/graphs.py``)
    started fresh: summed, each call's total by step, and whether each
    step's first call (eager) and second (its capture), where it had one,
    launched ``per_frame[step]`` and every later call (a replay) ran no
    Python launch wrapper."""
    by_step: dict[str, list] = {}
    for step, launched in calls:
        by_step.setdefault(step, []).append(launched)
    ok = by_step.keys() == per_frame.keys() and all(
        got[:2] == [per_frame[step]] * len(got[:2])
        and not any(any(c.values()) for c in got[2:])
        for step, got in by_step.items())
    total = {name: sum(c[name] for _, c in calls) for name in calls[0][1]}
    return total, {step: [sum(c.values()) for c in got] for step, got in by_step.items()}, ok


def stream_group(seg: VideoSegmenter, frames: torch.Tensor) -> tuple[torch.Tensor, list, list]:
    """``push_frame`` on each frame of a group, each ending in a
    synchronize (the frame's class map is ready to send): the class maps
    (1, k, H, W), the host ms of each frame and each frame's step ('key'
    or 'cur') and launches (``counts()``' keys)."""
    preds, ms, calls = [], [], []
    for i in range(frames.shape[1]):
        step = "key" if seg.is_keyframe_next or seg.model.family == "deeplab" else "cur"
        before = counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds.append(seg.push_frame(frames[:, i]))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        calls.append((step, {name: n - before[name] for name, n in counts().items()}))
    return torch.stack(preds, dim=1), ms, calls


def e2e_stream(phase: str, config: str, net: dict, seed: int, per_frame: dict,
               overall: float, turns: int = 4) -> dict[str, int]:
    """Per-frame serving: a direct and an incremental + 'last' group of
    ``net`` at 1024x2048 through ``VideoSegmenter.push_frame``, three
    passes of each on fresh steps (``core/graphs.py``): the first runs
    the key and cur steps eagerly and captures the cur step, the second
    captures the key step, the third replays every frame. The exact
    launches, call by call (``frame_launches``; ``per_frame`` a key and a
    cur step launch), and every pass's maps bit-equal to the key/cur
    predictors' eager maps (``eager_push_frame``). Those are held
    (``compare_class_maps``; push_frame returns no logits) against
    ``push_group`` on the same frames and weights, of the kernel model
    (``push_group`` batches the non-key frames, where cuDNN may choose
    other algorithms than at batch 1) and of the plain model. Then
    ``turns`` alternating turns of both protocols on the host clock.
    Returns the launches of the three passes."""
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

    eager = {p: eager_push_frame(model, p, frames) for p, frames in groups}
    passes = [streamed() for _ in range(3)]
    launched, by_call, as_expected = {}, {}, {}
    for p, _ in groups:
        got, by_call[p], as_expected[p] = frame_launches(
            [c for out in passes for c in out[p][2]], per_frame)
        launched = {name: launched.get(name, 0) + n for name, n in got.items()}
    graph_equal = {p: [torch.equal(out[p][0], eager[p]) for out in passes] for p, _ in groups}
    grouped()  # warm-up: cuDNN algorithm choice, allocator
    group_out = grouped()
    for p, _ in groups:
        check_pred(eager[p], (1, K, H, W))
    vs_group = {p: compare_class_maps(eager[p], group_out[p][0], model, frames, p)[0]
                for p, frames in groups}
    plain = build_model(net, device="cuda", generator=torch.Generator().manual_seed(SEED),
                        use_kernels=False)
    plain.load_state_dict(model.state_dict())
    reset_counts()
    vs_plain = {p: compare_class_maps(eager[p],
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
            for p, (_, ms, _) in streamed().items():
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
              passes_bit_equal_to_eager=graph_equal, launches_by_call=by_call,
              launches=launched))
    check(all(as_expected.values()), f"{phase} launches by call {by_call}, a key and a cur "
          f"step's eager and capturing calls each {per_frame}")
    check(all(all(e) for e in graph_equal.values()),
          f"{phase}: push_frame differs from the eager predictors: {graph_equal}")
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


def quant_groups(model, clip: torch.Tensor, clip4: torch.Tensor) -> tuple[dict, list]:
    """The int8 phase's serving run on fresh segmenters: an incremental
    and a direct group at B=1 and a direct group at B=4 through
    ``push_group``, then an incremental group through ``push_frame`` (the
    key and cur steps' first calls eager, the cur step's second captured,
    the later frames replayed): {name: (class maps, host ms)} and the
    ``push_frame`` calls' steps and launches (``stream_group``)."""
    segs = {p: VideoSegmenter(model, K, propagate=p) for p in ("incremental", "direct")}
    out = {"incremental": timed_group(segs["incremental"], clip[:, :K]),
           "direct": timed_group(segs["direct"], clip[:, K:2 * K]),
           "direct_B4": timed_group(segs["direct"], clip4)}
    segs["incremental"].reset()
    preds, ms, calls = stream_group(segs["incremental"], clip[:, 2 * K:])
    out["push_frame"] = (preds, sum(ms))
    return out, calls


def e2e_quant() -> dict[str, int]:
    """Phase 15: int8 Accel-18 (``INT8_NET``) at 1024x2048 through
    ``VideoSegmenter``: the groups of ``quant_groups``, with the exact
    launches (both stems and one tail a group, 4 warps an incremental
    group, 1 a direct one; through ``push_frame`` call by call,
    ``frame_launches``), no dilated
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
    out, frame_calls = quant_groups(model, clip, clip4)
    launched, int_mm = counts(), quant_ops.int_mm.launches - mm0
    for name, (pred, _) in out.items():
        check_pred(pred, (4 if name == "direct_B4" else 1, K, H, W))
    _, frames_by_call, frames_as_expected = frame_launches(frame_calls, ACCEL_FRAME_LAUNCHES)
    # push_frame (ACCEL_FRAME_LAUNCHES): the key step's eager call and the
    # cur step's eager and capturing calls launch, the later frames replay;
    # a FlowNet pass in each group and at each launching cur call
    expected = launches_of(fused_stem=2 * 3 + 2 + 2, warp=(K - 1) + 1 + 1 + 2,
                           upsample_argmax=3 + 3, upsample2x=FLOW_RESIZES * (3 + 2))
    passes = INT8_CONVS[101] + INT8_CONVS[18]
    # a group: the key frame's R101 and one R18 call over its B*k frames;
    # push_frame: the key's R101 and R18, and an R18 at each of the cur
    # step's eager and capturing calls
    expected_mm = 3 * passes + INT8_CONVS[101] + 3 * INT8_CONVS[18]

    plain = build_model(INT8_NET, device="cuda", generator=torch.Generator().manual_seed(SEED),
                        use_kernels=False)
    plain.load_state_dict(model.state_dict())
    reset_counts()
    mm0 = quant_ops.int_mm.launches
    plain_out, _ = quant_groups(plain, clip, clip4)
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
    same_out, _ = quant_groups(same_stem, clip, clip4)
    vs_same_stem = {name: (out[name][0] == same_out[name][0]).float().mean().item()
                    for name in groups}
    del same_stem, same_out
    bf16 = build_model(BENCH_NET, device="cuda", generator=torch.Generator().manual_seed(SEED))
    bf16.load_state_dict(model.state_dict())
    quant_groups(bf16, clip, clip4)  # warm-up
    bf16_out, _ = quant_groups(bf16, clip, clip4)
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
              push_frame_launches_by_call=frames_by_call, int8_gemms=int_mm, card=card()))
    check(launched == expected, f"e2e_quant launches {launched} != {expected}")
    check(frames_as_expected, f"e2e_quant push_frame launches by call {frames_by_call}")
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
    through cuDNN, so only the warp, the tail and the 2x upsample launch:
    a FlowNet pass, and the update branch's scores (stride 32 of the frame,
    its input downscale folded in) resized up by 2 to the feature grid."""
    launched = {}
    for propagate, warps, seed in (("direct", 1, SEED + 90), ("incremental", K - 1, SEED + 92)):
        got = e2e_variant(f"e2e_fold_{propagate}", "accel18_fast conv7 fold_update_downscale "
                          "fold_flow_downscale bf16", FOLD_NET, propagate, seed,
                          launches_of(warp=warps, upsample_argmax=1,
                                      upsample2x=FLOW_RESIZES + 1))
        launched = {name: launched.get(name, 0) + n for name, n in got.items()}
    return launched


# ---- phases 18-22: serving export, use_scale_field: false, small int8 GEMMs -------


def cuda_ms(fn) -> tuple[object, float]:
    """``fn()`` bracketed by CUDA events on an idle stream: its result and
    the ms from before its host work to the end of its device work."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def held_to_push_group(phase: str, got: torch.Tensor, want: torch.Tensor, model,
                       frames: torch.Tensor, propagate: str) -> dict:
    """A loaded program's class maps against ``push_group``'s on the same
    frames: identical, or else (printed) within ``compare_class_maps``'
    limits, 0.99 overall and 0.9999 off near-ties, clip by clip."""
    check_pred(got, tuple(want.shape))
    out = dict(identical=torch.equal(got, want))
    if not out["identical"]:
        out["per_clip"] = [compare_class_maps(got[b:b + 1], want[b:b + 1], model,
                                              frames[b:b + 1], propagate)[0]
                           for b in range(got.shape[0])]
        for b, c in enumerate(out["per_clip"]):
            check_class_maps(f"{phase} loaded program vs push_group, clip {b}", c)
    return out


def export_and_load(model, path: Path, batch, embed_params: bool = True,
                    propagate: str = "direct") -> tuple[object, dict]:
    """Export ``model``'s group program at 1024x2048, k=K, write it to
    ``path`` and load it: (the loaded program, its export and load seconds
    and MB)."""
    t0 = time.perf_counter()
    blob = export_serving(model, None, (H, W), K, propagate=propagate, batch=batch,
                          embed_params=embed_params, path=str(path))
    t1 = time.perf_counter()
    serve = load_serving(str(path))
    t2 = time.perf_counter()
    return serve, dict(export_s=t1 - t0, load_s=t2 - t1, artifact_mb=len(blob) / 1e6)


def e2e_export(tmp: Path) -> tuple[dict[str, int], dict[str, int]]:
    """Phase 18: the Accel-18 bench row (``BENCH_NET``), direct, k=K,
    exported by ``core/export.py`` with a symbolic batch and its weights
    embedded, saved, loaded and run at B=1 and at B=4: each group's exact
    launches (at B=1 both stems, one warp, one tail; at B=4 the same four
    launches, at N=4 and 20 frames, N=16 and 20 frames), and its class maps
    against ``push_group`` of the same model on the same frames
    (``held_to_push_group``). Then the loaded program's and ``push_group``'s
    ms per B=1 group (CUDA events), in alternating turns. Returns the
    launches of the B=1 and the B=4 group."""
    model = build_model(BENCH_NET, device="cuda", generator=torch.Generator().manual_seed(SEED))
    clip = moving_clip(K, (H, W), SEED + 100, "cuda")
    max_flow = live_flow_heads(model, clip, SEED + 101)
    check(max_flow > 0.5, f"e2e_export: flow {max_flow} too small to exercise the warp")
    clip4 = torch.cat([moving_clip(K, (H, W), SEED + 102 + b, "cuda") for b in range(4)])
    serve, sizes = export_and_load(model, tmp / "accel18.pt2", "b")
    ops = sorted({str(n.target) for n in serve.exported.graph.nodes
                  if str(n.target).startswith("accel_tpu_torch.")})
    seg = VideoSegmenter(model, K, propagate="direct")
    serve(clip), seg.push_group(clip)  # warm-up: cuDNN algorithm choice, allocator
    launched = {}
    for name, frames in (("B1", clip), ("B4", clip4)):
        reset_counts()
        got = serve(frames)
        torch.cuda.synchronize()
        launched[name] = counts()
        want = seg.push_group(frames)
        check(launched[name] == launches_of(fused_stem=2, warp=1, upsample_argmax=1,
                                            upsample2x=FLOW_RESIZES),
              f"e2e_export {name} launches {launched[name]}")
        launched[name + "_vs_push_group"] = held_to_push_group(
            f"e2e_export {name}", got, want, model, frames, "direct")
    turns = {"loaded": [], "push_group": []}
    for turn in range(4):
        order = ("loaded", "push_group") if turn % 2 == 0 else ("push_group", "loaded")
        for name in order:
            fn = (lambda: serve(clip)) if name == "loaded" else (lambda: seg.push_group(clip))
            turns[name].append(cuda_ms(fn)[1])
    emit(dict(phase="e2e_export", config="accel18 frozenbn fused7 bf16 direct, batch-polymorphic,"
              " weights embedded", hw=[H, W], k=K, max_abs_flow=max_flow, **sizes, ops=ops,
              launches_B1=launched["B1"], launches_B4=launched["B4"],
              B1_vs_push_group=launched["B1_vs_push_group"],
              B4_vs_push_group=launched["B4_vs_push_group"],
              group_ms_B1=turns, card=card()))
    return launched["B1"], launched["B4"]


def e2e_export_args(tmp: Path) -> dict[str, int]:
    """Phase 19: the same row exported with ``embed_params=False`` at a
    static B=1, called with the model's state dict; then the key branch's
    stem weight (``conv1``, which #3 packs) is doubled with ``copy_`` and
    the program called again: its class maps follow the new weights, equal
    to ``push_group`` after the same write (the packing is traced, not baked
    into the artifact). Returns the launches of the first call."""
    model = build_model(BENCH_NET, device="cuda", generator=torch.Generator().manual_seed(SEED))
    clip = moving_clip(K, (H, W), SEED + 110, "cuda")
    live_flow_heads(model, clip, SEED + 111)
    serve, sizes = export_and_load(model, tmp / "accel18_args.pt2", 1, embed_params=False)
    seg = VideoSegmenter(model, K, propagate="direct")
    serve(model.state_dict(), clip)  # warm-up
    reset_counts()
    before = serve(model.state_dict(), clip)
    torch.cuda.synchronize()
    launched = counts()
    held = {"before": held_to_push_group("e2e_export_args", before, seg.push_group(clip), model,
                                         clip, "direct")}
    with torch.no_grad():
        w = model.ref_net.backbone.conv1.weight
        w.copy_(w * 2)
    after = serve(model.state_dict(), clip)
    held["after"] = held_to_push_group("e2e_export_args after the write", after,
                                       seg.push_group(clip), model, clip, "direct")
    moved = (after != before).float().mean().item()
    emit(dict(phase="e2e_export_args", config="accel18 frozenbn fused7 bf16 direct, B=1, "
              "weights as an argument", hw=[H, W], k=K, **sizes, launches=launched,
              vs_push_group=held, class_maps_moved_by_the_write=moved))
    check(launched == launches_of(fused_stem=2, warp=1, upsample_argmax=1,
                                  upsample2x=FLOW_RESIZES),
          f"e2e_export_args launches {launched}")
    check(sizes["artifact_mb"] < 10, f"e2e_export_args: the weights are in the artifact "
          f"({sizes['artifact_mb']} MB)")
    check(moved > 0, "e2e_export_args: doubling the stem weight moved no class")
    return launched


def e2e_export_dff(tmp: Path) -> dict[str, int]:
    """Phase 20: the DFF row (``DFF_NET``: one-hot native D=4), direct,
    exported (symbolic batch, weights embedded) and run at B=1: one #4
    (N=4, the scale fused), one #3, one #2, and class maps against
    ``push_group``. Returns the launches."""
    model = build_model(DFF_NET, device="cuda", generator=torch.Generator().manual_seed(SEED))
    clip = moving_clip(K, (H, W), SEED + 120, "cuda")
    max_flow = live_flow_heads(model, clip, SEED + 121)
    serve, sizes = export_and_load(model, tmp / "dff.pt2", "b")
    seg = VideoSegmenter(model, K, propagate="direct")
    serve(clip), seg.push_group(clip)  # warm-up
    reset_counts()
    got = serve(clip)
    torch.cuda.synchronize()
    launched = counts()
    held = held_to_push_group("e2e_export_dff", got, seg.push_group(clip), model, clip, "direct")
    (_, loaded_ms), (_, group_ms) = cuda_ms(lambda: serve(clip)), cuda_ms(
        lambda: seg.push_group(clip))
    emit(dict(phase="e2e_export_dff", config="dff101 frozenbn fused7 bf16 onehot native D=4 "
              "direct", hw=[H, W], k=K, max_abs_flow=max_flow, **sizes, launches=launched,
              vs_push_group=held, loaded_ms=loaded_ms, push_group_ms=group_ms))
    check(launched == launches_of(fused_stem=1, warp_onehot=1, upsample_argmax=1,
                                  upsample2x=FLOW_RESIZES),
          f"e2e_export_dff launches {launched}")
    return launched


def e2e_export_deeplab_pallas(tmp: Path) -> dict[str, int]:
    """Phase 20b: per-frame DeepLab-101 with every dilated conv on #5
    (``DEEPLAB_NET``, ``dilated_conv: pallas``) exported (symbolic batch,
    weights embedded), loaded and served frame by frame on a 5-frame clip,
    each frame a call at the shapes ``push_group`` runs it: #5 runs through
    ``torch.ops.accel_tpu_torch.conv3x3_dilated``, 4 launches a frame (3
    layer4 conv2 + fc6, ``e2e_deeplab``'s count), 1 #3 and 1 #2 a frame
    (``push_group`` runs one #2 for the clip's 5 frames); the class maps
    against ``push_group``'s (``held_to_push_group``). Returns the launches
    of the clip."""
    model = build_model(dict(DEEPLAB_NET, dilated_conv="pallas"), device="cuda",
                        generator=torch.Generator().manual_seed(SEED))
    clip = moving_clip(K, (H, W), SEED + 130, "cuda")
    serve, sizes = export_and_load(model, tmp / "deeplab101_pallas.pt2", "b")
    ops = sorted({str(n.target) for n in serve.exported.graph.nodes
                  if str(n.target).startswith("accel_tpu_torch.")})
    seg = VideoSegmenter(model, K, propagate="direct")

    def frame_by_frame():
        return torch.cat([serve(clip[:, f:f + 1]) for f in range(K)], dim=1)

    frame_by_frame(), seg.push_group(clip)  # warm-up
    reset_counts()
    got = frame_by_frame()
    torch.cuda.synchronize()
    launched = counts()
    reset_counts()
    want = seg.push_group(clip)
    torch.cuda.synchronize()
    eager = counts()
    held = held_to_push_group("e2e_export_deeplab_pallas", got, want, model, clip, "direct")
    (_, loaded_ms), (_, group_ms) = cuda_ms(frame_by_frame), cuda_ms(lambda: seg.push_group(clip))
    emit(dict(phase="e2e_export_deeplab_pallas", config="deeplab101 frozenbn fused7 bf16 "
              "dilated_conv=pallas, frame by frame", hw=[H, W], frames=K, **sizes, ops=ops,
              launches=launched, push_group_launches=eager, vs_push_group=held,
              loaded_ms=loaded_ms, push_group_ms=group_ms, card=card()))
    check("accel_tpu_torch.conv3x3_dilated.default" in ops,
          f"e2e_export_deeplab_pallas: #5 is not an op of the program: {ops}")
    expected = launches_of(dilated_conv=4 * K, fused_stem=K, upsample_argmax=K)
    check(launched == expected, f"e2e_export_deeplab_pallas launches {launched} != {expected}")
    check(eager == dict(expected, upsample_argmax=1),
          f"e2e_export_deeplab_pallas push_group launches {eager}")
    return launched


@contextlib.contextmanager
def unmodulated_onehot_warps():
    """Record, for each one-hot warp that ``bilinear_warp`` dispatches in
    the scope (the unmodulated warp; the modulated one is
    ``AccelNet.warp``'s own call), whether it took no scale."""
    dispatch, seen = warp_module.warp_onehot, []

    def recording(feat, flow, scale=None, *args, **kwargs):
        seen.append(scale is None)
        return dispatch(feat, flow, scale, *args, **kwargs)

    warp_module.warp_onehot = recording
    try:
        yield seen
    finally:
        warp_module.warp_onehot = dispatch


def e2e_noscale() -> dict[str, int]:
    """Phase 21: ``use_scale_field: false``. The Accel-18 bench row without
    the scale field, incremental (the product cascade) through
    ``push_group`` (exact launches: both stems, a warp per non-key frame,
    one tail) and ``push_frame`` over two groups (``ACCEL_FRAME_LAUNCHES``
    at each step's eager and capturing calls, none at a replay; the second
    group's maps equal to the first's), against the plain path
    (``check_bf16_paths`` and ``compare_class_maps``). Then the DFF row
    without it, direct: one #4 that takes no scale, one #3, one #2; its
    class maps against the plain path (0.98 overall), its logits and class
    maps (0.999 overall, 0.9999 off near-ties) against the plain path with
    the stem kernel's output.
    Returns the launches of all three."""
    net = dict(BENCH_NET, use_scale_field=False)
    model = build_model(net, device="cuda", generator=torch.Generator().manual_seed(SEED))
    plain = build_model(net, device="cuda", generator=torch.Generator().manual_seed(SEED),
                        use_kernels=False)
    clip = moving_clip(2 * K, (H, W), SEED + 130, "cuda")
    max_flow = live_flow_heads(model, clip, SEED + 131)
    plain.load_state_dict(model.state_dict())
    check(not hasattr(model.flownet, "scale_field"), "e2e_noscale: a scale-field head")
    groups = [("incremental", clip[:, :K])]
    out, launched = run_groups(model, groups)
    plain_out, _ = run_groups(plain, groups)
    vs_plain = compare_paths(out[0][0], plain_out[0][0], model, plain, clip[:, :K], "incremental")
    seg = VideoSegmenter(model, K, propagate="incremental")
    # fresh steps: the first group runs the key and cur steps eagerly and
    # captures the cur step, the second captures the key step
    streamed, _, calls = stream_group(seg, clip[:, K:])
    seg.reset()
    again, _, more = stream_group(seg, clip[:, K:])
    stream_launched, stream_by_call, stream_as_expected = frame_launches(
        calls + more, ACCEL_FRAME_LAUNCHES)
    plain_streamed = VideoSegmenter(plain, K, propagate="incremental").push_clip(clip[:, K:])
    stream_vs_plain = compare_class_maps(streamed, plain_streamed, plain, clip[:, K:],
                                         "incremental")[0]
    del model, plain
    torch.cuda.empty_cache()

    dff_net = dict(DFF_NET, use_scale_field=False)
    dff = build_model(dff_net, device="cuda", generator=torch.Generator().manual_seed(SEED))
    dff_plain = build_model(dff_net, device="cuda", generator=torch.Generator().manual_seed(SEED),
                            use_kernels=False)
    dff_clip = moving_clip(K, (H, W), SEED + 132, "cuda")
    dff_flow = live_flow_heads(dff, dff_clip, SEED + 133)
    dff_plain.load_state_dict(dff.state_dict())
    with unmodulated_onehot_warps() as unscaled:
        dff_out, dff_launched = run_groups(dff, [("direct", dff_clip)])
    dff_plain_out, _ = run_groups(dff_plain, [("direct", dff_clip)])
    dff_vs_plain = compare_paths(dff_out[0][0], dff_plain_out[0][0], dff, dff_plain, dff_clip,
                                 "direct")
    del dff_plain
    same_stem = plain_with_kernel_stem(dff_net, dff.state_dict())
    same_out, _ = run_groups(same_stem, [("direct", dff_clip)])
    dff_vs_same_stem = compare_paths(dff_out[0][0], same_out[0][0], dff, same_stem, dff_clip,
                                     "direct")
    emit(dict(phase="e2e_noscale", config="use_scale_field: false; accel18 frozenbn fused7 bf16 "
              "incremental, dff101 onehot native D=4 direct", hw=[H, W], k=K,
              max_abs_flow=max_flow, dff_max_abs_flow=dff_flow, push_group_launches=launched,
              push_frame_launches=stream_launched, push_frame_launches_by_call=stream_by_call,
              push_frame_replays_equal=torch.equal(again, streamed), dff_launches=dff_launched,
              dff_onehot_without_scale=unscaled, kernels_vs_plain=vs_plain,
              push_frame_vs_plain=stream_vs_plain, dff_kernels_vs_plain=dff_vs_plain,
              dff_kernels_vs_plain_same_stem=dff_vs_same_stem))
    check(launched == launches_of(fused_stem=2, warp=K - 1, upsample_argmax=1,
                                  upsample2x=FLOW_RESIZES),
          f"e2e_noscale push_group launches {launched}")
    check(stream_as_expected, f"e2e_noscale push_frame launches by call {stream_by_call}")
    check(torch.equal(again, streamed), "e2e_noscale: a replayed push_frame group differs")
    check(dff_launched == launches_of(fused_stem=1, warp_onehot=1, upsample_argmax=1,
                                      upsample2x=FLOW_RESIZES),
          f"e2e_noscale dff launches {dff_launched}")
    # two groups ran under the recorder (run_groups' warm-up and its timed
    # pass), each with its one #4 launch through bilinear_warp, unscaled
    check(unscaled == [True, True], f"e2e_noscale: #4 took a scale ({unscaled})")
    check_bf16_paths("e2e_noscale kernel vs plain", vs_plain)
    check_class_maps("e2e_noscale push_frame vs plain", stream_vs_plain)
    # without the modulation DFF's logits are smaller, and the stem kernel's
    # bf16 roundings put them 2.5% of max|logits| off the plain path's (the
    # bench row sits at 1.5-1.8%), which flips pixels of margins past the 1%
    # that compare_class_maps counts as clear (0.99985 of them agreed on an
    # H100): against the plain path the class maps are held overall, and #4
    # and #2 against the plain path that shares the stem's output
    check(dff_vs_plain["agreement"] >= 0.98,
          f"e2e_noscale dff kernel vs plain class maps: {dff_vs_plain['agreement']}")
    check_bf16_paths("e2e_noscale dff kernel vs plain with the kernel stem", dff_vs_same_stem,
                     0.999)
    return {name: launched[name] + stream_launched[name] + dff_launched[name]
            for name in launched}


def e2e_quant_small() -> dict[str, int]:
    """Phase 22: int8 GEMMs that CUDA's int8 GEMM refuses unpadded. The
    int8 bench row (``INT8_NET``) at B=1 on 64x64 frames (FlowNet at full
    input, since 64x64 halved does not divide by 64): the key frame's layer4
    and fc6 run GEMMs of 4x4 = 16 rows; and the row with ``head_channels``
    1020 (fc6's Cout and the score conv's k not multiples of 8) on 128x256
    frames. One direct group each through ``push_group``, with the exact
    launches, against the plain int8 path (the exact float64 product)
    within ``QUANT_OVERALL``/``QUANT_CLEAR``. Returns the launches."""
    launched, rows = {}, {}
    for name, net, hw in (("m16", dict(INT8_NET, flow_input_downscale=1), (64, 64)),
                          ("head1020", dict(INT8_NET, head_channels=1020), (128, 256))):
        model = build_model(net, device="cuda", generator=torch.Generator().manual_seed(SEED))
        plain = build_model(net, device="cuda", generator=torch.Generator().manual_seed(SEED),
                            use_kernels=False)
        clip = moving_clip(K, hw, SEED + 140, "cuda")
        live_flow_heads(model, clip, SEED + 141)
        plain.load_state_dict(model.state_dict())
        mm0 = quant_ops.int_mm.launches
        out, got = run_groups(model, [("direct", clip)])
        gemms = quant_ops.int_mm.launches - mm0
        plain_out, _ = run_groups(plain, [("direct", clip)])
        check_pred(out[0][0], (1, K, *hw))
        c = compare_class_maps(out[0][0], plain_out[0][0], plain, clip, "direct")[0]
        rows[name] = dict(hw=list(hw), launches=got, int8_gemms_two_groups=gemms,
                          kernels_vs_plain=c)
        check(got == launches_of(fused_stem=2, warp=1, upsample_argmax=1,
                                 upsample2x=FLOW_RESIZES),
              f"e2e_quant_small {name} launches {got}")
        check(gemms > 0, f"e2e_quant_small {name}: no int8 GEMM ran")
        check_class_maps(f"e2e_quant_small {name} kernel vs plain", c, QUANT_OVERALL, QUANT_CLEAR)
        launched = {k: launched.get(k, 0) + n for k, n in got.items()}
        del model, plain
    emit(dict(phase="e2e_quant_small", config="accel18 int8 frozenbn fused7 bf16 direct B=1",
              k=K, **rows))
    return launched


# ---- phase 26: push_group from CUDA graphs ---------------------------------------

def bench_network(config: str) -> dict:
    """The network of a benchmark configuration (``benchmark/configs/``)."""
    path = Path(__file__).resolve().parent / "benchmark" / "configs" / f"{config}.json"
    return json.loads(path.read_text())["network"]


def device_kernel(event_name: str) -> str | None:
    """Which of the port's kernels a device event is: ``benchmark/devtrace.py``'s
    names, and #6's (``upsample2x_kernel``)."""
    from benchmark.devtrace import port_kernel

    if "upsample2x_kernel" in event_name or "_upsample2x_cu_" in event_name:
        return "upsample2x"
    return port_kernel(event_name)


def profiled_launches(fn) -> tuple[object, dict[str, int], dict[str, int], dict]:
    """``fn()`` under ``torch.profiler``: its result, the launch calls on
    the host by name (those the benchmark counts: a graph launch is one),
    the port's kernels among the device events (``device_kernel``), each by
    count, and the device's copies beside its other events
    ({'n', 'ms'} each: the memcpy events and the rest, with their summed
    device ms). A warm-up step on the card comes first and is not kept:
    the device trace of a profile's first step can miss its first kernels
    (a replayed B=4 DFF group's stem kernel was missing once on an H100)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    from benchmark.spans import LAUNCHES

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        out = fn()
        torch.cuda.synchronize()
        prof.step()
    calls: dict[str, int] = {}
    seen: dict[str, int] = {}
    device = {"copies": dict(n=0, ms=0.0), "other": dict(n=0, ms=0.0)}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            kernel = device_kernel(name)
            if kernel is not None:
                seen[kernel] = seen.get(kernel, 0) + 1
            side = device["copies" if name.startswith("Memcpy") else "other"]
            side["n"] += 1
            side["ms"] += e.duration_ns() / 1e6
        elif name.startswith(LAUNCHES):
            calls[name] = calls.get(name, 0) + 1
    return out, calls, seen, device


def graph_case(name: str, model, propagate: str, clips: list, turns: int = 4,
               capture_fails: bool = False) -> dict:
    """``push_group`` of one segmenter (composed: the ``CallGraphs`` of its
    group step) over ``clips`` (three of one shape):
    the first call eager, the second captured, the third replayed, then the
    first clip again (a replay on new frames gives the new frames' maps).
    Each call's class maps bit-equal to ``clip_predictions``' on its clip;
    the tensor returned by the capturing call unchanged after the later
    calls; the capturing call's Python-side launches the eager call's and a
    replay's none; under the profiler a replay makes one launch call,
    ``cudaGraphLaunch``, and its device trace holds every kernel the eager
    call launched, as many times. Then ``turns`` alternating turns of the
    eager call and the replay, CUDA-event ms. With ``capture_fails`` the
    capture must fail (a host copy inside the call) and every call serve
    the eager maps."""
    want = [clip_predictions(model, c, K, propagate) for c in clips]
    if propagate == "composed":
        # push_group serves direct and incremental; the helper takes the
        # composed group step as push_group takes the others
        graphs = CallGraphs(functools.partial(clip_predictions, model, interval=K,
                                              propagate=propagate),
                            watched=[*model.parameters(), *model.buffers()])
        serve = graphs
    else:
        seg = VideoSegmenter(model, K, propagate=propagate)
        graphs, serve = seg._steps.group, seg.push_group
    launched, got = [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for c in (*clips, clips[0]):
            reset_counts()
            got.append(serve(c))
            torch.cuda.synchronize()
            launched.append(counts())
            if len(got) == 2:
                captured = got[1].clone()
    row = dict(phase="e2e_graphs", case=name, propagate=propagate, B=clips[0].shape[0],
               captures=graphs.captures, capture_failures=graphs.capture_failures,
               warnings=[str(w.message)[:300] for w in caught])
    equal = [torch.equal(g, w) for g, w in zip(got, want + want[:1], strict=True)]
    row.update(bit_equal_to_eager=equal, launches_eager=launched[0],
               launches_capture=launched[1], launches_replays=launched[2:])
    if not all(equal):
        row["class_agreement"] = [(g == w).float().mean().item()
                                  for g, w in zip(got, want + want[:1], strict=True)]
        row["eager_again_equal"] = torch.equal(
            clip_predictions(model, clips[0], K, propagate), want[0])
    if capture_fails:
        emit(row)
        check(all(equal), f"e2e_graphs {name}: an eager fallback's maps differ")
        check(graphs.captures == 0 and graphs.capture_failures == 1,
              f"e2e_graphs {name}: the capture did not fail once")
        return row
    _, calls, seen, _ = profiled_launches(lambda: serve(clips[1]))
    eager_kernels = {k: n for k, n in launched[0].items() if n and k != "dilated_conv_dx"}
    ms = {"eager": [], "graph": []}
    for turn in range(turns):
        for side in (("eager", "graph") if turn % 2 == 0 else ("graph", "eager")):
            fn = ((lambda: clip_predictions(model, clips[0], K, propagate)) if side == "eager"
                  else (lambda: serve(clips[0])))
            ms[side].append(cuda_ms(fn)[1])
    med = statistics.median
    row.update(replay_launch_calls=calls, replay_port_kernels=seen,
               eager_port_kernels=eager_kernels, unchanged_after_later_calls=torch.equal(
                   got[1], captured), group_ms_eager=med(ms["eager"]),
               group_ms_graph=med(ms["graph"]), group_ms_all=ms, card=card())
    emit(row)
    check(all(equal), f"e2e_graphs {name}: graph maps differ from the eager call's")
    check(row["unchanged_after_later_calls"], f"e2e_graphs {name}: a returned map was overwritten")
    check(graphs.captures == 1 and graphs.capture_failures == 0,
          f"e2e_graphs {name}: {graphs.captures} captures, {graphs.capture_failures} failed")
    check(launched[1] == launched[0], f"e2e_graphs {name}: the capture's launches "
          f"{launched[1]} != the eager call's {launched[0]}")
    check(not any(any(c.values()) for c in launched[2:]),
          f"e2e_graphs {name}: a replay ran a Python launch wrapper: {launched[2:]}")
    check(sum(calls.values()) == 1 and next(iter(calls)).startswith("cudaGraphLaunch"),
          f"e2e_graphs {name}: a replay made the launch calls {calls}")
    check(seen == eager_kernels, f"e2e_graphs {name}: the replay's device trace holds {seen}, "
          f"the eager call launched {eager_kernels}")
    return row


STREAMS = 3


def frame_case(name: str, model, propagate: str, clips: list, turns: int = 4) -> dict:
    """``push_frame`` of ``len(clips)`` segmenters of one model, stream s
    starting s frames after stream 0, interleaved frame by frame over its
    clip ((1, 2K, H, W, 3): two keyframe groups). Every class map
    bit-equal to the key/cur predictors' eager maps on its stream
    (``eager_push_frame``); the segmenters share one key and one cur
    ``CallGraphs`` (DeepLab runs the key step alone), each captured once;
    each step's first call (eager) and second (the capture) make the same
    Python-side launches, every later one none (a replay); every returned
    map and carried tensor unchanged after the later calls. Then a
    replayed key and cur frame under the profiler: one launch call,
    ``cudaGraphLaunch``, each, every port kernel of the step's eager call
    in its device trace, as many times, and the device's copies in and out
    beside the graph's other events; the weights' version stamp's
    untraced host ms; ``turns`` alternating turns of each step eager and
    replayed, CUDA-event ms."""
    n = clips[0].shape[1]
    want = [eager_push_frame(model, propagate, c) for c in clips]
    segs = [VideoSegmenter(model, K, propagate=propagate) for _ in clips]
    steps = segs[0]._steps
    kinds = ("key",) if model.family == "deeplab" else ("key", "cur")
    got = [[] for _ in clips]
    kept, launched = [], {kind: [] for kind in kinds}
    for tick in range(n + len(clips) - 1):
        for s, seg in enumerate(segs):
            if not 0 <= tick - s < n:
                continue
            kind = "key" if seg.is_keyframe_next or model.family == "deeplab" else "cur"
            reset_counts()
            pred = seg.push_frame(clips[s][:, tick - s])
            torch.cuda.synchronize()
            launched[kind].append(counts())
            got[s].append(pred)
            held = (pred, seg._prop, seg._anchor_small)
            kept.append((held, tuple(t.clone() for t in held)))
    equal = [[torch.equal(g, ws[:, i]) for i, g in enumerate(gs)]
             for gs, ws in zip(got, want, strict=True)]
    unchanged = all(torch.equal(t, c) for held, copies in kept for t, c in zip(held, copies))
    row = dict(phase="e2e_graphs", case=name, propagate=propagate, streams=len(clips),
               frames_a_stream=n, shared=all(seg._steps is steps for seg in segs),
               captures={k: getattr(steps, k).captures for k in kinds},
               capture_failures={k: getattr(steps, k).capture_failures for k in kinds},
               launches_by_call={k: [sum(c.values()) for c in v] for k, v in launched.items()},
               bit_equal_to_eager=equal, unchanged_after_later_calls=unchanged)
    # the first stream is at a group boundary: a key frame, then a cur frame
    seg, frames = segs[0], clips[0]
    profiled = {}
    for kind, i in (("key", 0), ("cur", 1))[:len(kinds)]:
        pred, calls, seen, device = profiled_launches(lambda i=i: seg.push_frame(frames[:, i]))
        eager_kernels = {k: c for k, c in launched[kind][0].items()
                         if c and k != "dilated_conv_dx"}
        profiled[kind] = dict(launch_calls=calls, port_kernels=seen,
                              eager_port_kernels=eager_kernels, device=device,
                              bit_equal_to_eager=torch.equal(pred, want[0][:, i]))
    watched = len(steps.key._watched)
    t0 = time.perf_counter()
    for _ in range(200):
        steps.key.stamp()
    stamp_ms = (time.perf_counter() - t0) * 1e3 / 200
    key_in = (frames[:, 0],)
    fresh = steps.key(*key_in)
    step_in = {"key": key_in, "cur": (frames[:, 1], fresh["anchor_small"], fresh["prop"])}
    ms = {f"{kind}_{side}": [] for kind in kinds for side in ("eager", "graph")}
    for turn in range(turns):
        for side in (("eager", "graph") if turn % 2 == 0 else ("graph", "eager")):
            for kind in kinds:
                step = getattr(steps, kind)
                fn = step.fn if side == "eager" else step
                ms[f"{kind}_{side}"].append(cuda_ms(lambda: fn(*step_in[kind]))[1])
    med = statistics.median
    row.update(replayed=profiled, stamp_host_ms=stamp_ms, watched_tensors=watched,
               step_ms={k: med(v) for k, v in ms.items()}, step_ms_all=ms, card=card())
    emit(row)
    check(row["shared"], f"e2e_graphs {name}: the segmenters do not share their steps")
    check(all(all(e) for e in equal), f"e2e_graphs {name}: push_frame from graphs differs "
          "from the eager predictors")
    check(unchanged, f"e2e_graphs {name}: a returned map or carried tensor was overwritten")
    for kind in kinds:
        step, calls = getattr(steps, kind), launched[kind]
        check(step.captures == 1 and step.capture_failures == 0,
              f"e2e_graphs {name} {kind}: {step.captures} captures, {step.capture_failures} failed")
        check(any(calls[0].values()) and calls[1] == calls[0]
              and not any(any(c.values()) for c in calls[2:]),
              f"e2e_graphs {name} {kind}: Python-side launches by call {row['launches_by_call']}")
        p = profiled[kind]
        check(p["bit_equal_to_eager"], f"e2e_graphs {name}: the profiled {kind} frame differs")
        check(sum(p["launch_calls"].values()) == 1
              and next(iter(p["launch_calls"])).startswith("cudaGraphLaunch"),
              f"e2e_graphs {name}: a replayed {kind} frame made the launch calls "
              f"{p['launch_calls']}")
        check(p["port_kernels"] == p["eager_port_kernels"],
              f"e2e_graphs {name}: a replayed {kind} frame's device trace holds "
              f"{p['port_kernels']}, its step's eager call launched {p['eager_port_kernels']}")
    return row


def e2e_graphs() -> dict:
    """Phase 26: ``push_group`` from CUDA graphs (``core/graphs.py``), case
    by case as ``graph_case`` holds it, at B=1 and B=4: Accel-18 as the
    benchmark serves it (incremental + 'last') and direct and composed, the
    DFF row as the benchmark serves it (direct), DeepLab-101; then
    ``push_frame`` from CUDA graphs as ``frame_case`` holds it, for each
    model as the benchmark serves it (DeepLab-101 direct); then the
    folded fast model, whose call copies from the host and cannot be
    captured, served eagerly. Returns the rows by case."""
    rows = {}
    accel_net, dff_net = bench_network("accel18-cityscapes"), bench_network("dff-r101-cityscapes")
    cases = (("accel18", accel_net, ("incremental", "direct", "composed"), SEED + 150),
             ("dff", dff_net, ("direct",), SEED + 160),
             ("deeplab101", DEEPLAB_NET, ("direct",), SEED + 170))
    for config, net, propagates, seed in cases:
        model = build_model(net, device="cuda", generator=torch.Generator().manual_seed(SEED))
        one = moving_clip(3 * K, (H, W), seed, "cuda")
        if config != "deeplab101":
            live_flow_heads(model, one, seed + 1)
        for B in (1, 4):
            clips = ([one[:, i * K:(i + 1) * K] for i in range(3)] if B == 1 else
                     [torch.cat([moving_clip(K, (H, W), seed + 10 * i + b, "cuda")
                                 for b in range(B)]) for i in range(1, 4)])
            for propagate in propagates:
                name = f"{config}_{propagate}_B{B}"
                rows[name] = graph_case(name, model, propagate, clips)
                torch.cuda.empty_cache()
            del clips
        streams = [moving_clip(2 * K, (H, W), seed + 5 + s, "cuda") for s in range(STREAMS)]
        name = f"{config}_{propagates[0]}_frames"
        rows[name] = frame_case(name, model, propagates[0], streams)
        del model, one, streams
        torch.cuda.empty_cache()
    model = build_model(FOLD_NET, device="cuda", generator=torch.Generator().manual_seed(SEED))
    one = moving_clip(3 * K, (H, W), SEED + 180, "cuda")
    live_flow_heads(model, one, SEED + 181)
    rows["fold_direct_B1"] = graph_case("fold_direct_B1", model, "direct",
                                        [one[:, i * K:(i + 1) * K] for i in range(3)],
                                        capture_fails=True)
    del model, one
    torch.cuda.empty_cache()
    return rows


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
    the PNG read (``cv2.imread``), the normalize, the annotation (read +
    label LUT), and the normalize, the LUT and a bilinear resize to half
    size alone, each through the C++ ops the loader runs
    (``native.native_ops``) and through the numpy ops (``numpy_ops``)."""
    entry = imdb.segdb[0]
    im = imdb.load_image(entry["image"])
    label = png.imread(entry["annotation"], png.IMREAD_UNCHANGED)
    means = np.asarray(cfg.network.PIXEL_MEANS, np.float32)
    stds = np.asarray(cfg.network.PIXEL_STDS, np.float32)
    out = dict(read=median_host_ms(lambda: imdb.load_image(entry["image"])),
               normalize=median_host_ms(lambda: transform(im, means, stds)),
               annotation=median_host_ms(lambda: imdb.load_annotation(entry)))
    h, w = im.shape[0] // 2, im.shape[1] // 2
    for name, ops in (("native", native.native_ops), ("numpy", native.numpy_ops)):
        out[name] = dict(normalize=median_host_ms(lambda: ops.normalize(im, means, stds)),
                         label_lut=median_host_ms(lambda: ops.map_labels(label, imdb.lut)),
                         resize_half=median_host_ms(lambda: ops.resize_bilinear(im, h, w)))
    return out


@contextlib.contextmanager
def numpy_host_ops():
    """The data path's resize, normalize and LUT through the numpy ops for
    the duration (the loader's C++ ops replaced)."""
    ops = image_module.native_ops
    image_module.native_ops = native.numpy_ops
    try:
        yield
    finally:
        image_module.native_ops = ops


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
    with numpy_host_ops():
        t0 = time.perf_counter()
        numpy_batches = list(TestClipLoader(imdb, cfg, max_items=EVAL_SNIPPETS))
        loader_ms_per_frame_numpy = (time.perf_counter() - t0) * 1e3 / (EVAL_SNIPPETS * K)
    check(all(np.array_equal(a["clip"], b["clip"]) and np.array_equal(a["label"], b["label"])
              for a, b in zip(host_batches, numpy_batches, strict=True)),
          f"{phase}: the C++ and numpy loaders' batches differ (unit stds, no resize)")
    del numpy_batches
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
              loader_ms_per_frame=loader_ms_per_frame,
              loader_ms_per_frame_numpy_ops=loader_ms_per_frame_numpy,
              loader_split_ms=loader_split_ms,
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
    check(launched == launches_of(warp=steps, upsample2x=FLOW_RESIZES * steps),
          f"{phase} launches {launched} ({steps} steps)")
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
    check(runs["kernels"][2] == launches_of(warp=1, upsample2x=FLOW_RESIZES),
          f"{phase}: step launches {runs['kernels'][2]}")
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


# ---- phase 23: data parallelism over two ranks on the one card ------------------

DP_RANKS = 2
# val clips of the data-parallel eval: two batches of one clip a rank, so
# that each rank times one (the first batch is left out of fps)
DP_EVAL_CLIPS = 4
# the least per-tensor gradient cosine of the f32 batchnorm pair step on two
# ranks against one process: a BatchNorm bias or scale followed by a conv and
# another BatchNorm gets a gradient that nearly cancels (the next BatchNorm
# removes per-channel shifts), so f32 summation order alone moves it; on an
# NVIDIA H100 80GB HBM3 (700 W) the worst was 0.9982-0.9987 (35-37 of 422
# tensors under 0.999) with the loss within 2.2e-7 and the statistics
# within 5.2e-6 (PERF.md). The all-parameter cosine is held at 0.999.
DP_BN_TENSOR_COSINE = 0.99


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def all_reduces_recorded():
    """The trainer's gradient all-reduce with, for each call, the ms it
    took (synchronized on both sides) and, for the first call, copies of
    the tensors it was given, for the duration."""
    reduce, seen = trainer_module.all_reduce_, []

    def recorded(tensors, group):
        before = None if seen else [t.clone() for t in tensors]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reduce(tensors, group)
        torch.cuda.synchronize()
        seen.append(dict(ms=(time.perf_counter() - t0) * 1e3, before=before,
                         numel=sum(t.numel() for t in tensors)))

    trainer_module.all_reduce_ = recorded
    try:
        yield seen
    finally:
        trainer_module.all_reduce_ = reduce


def dp_train_state(case: dict, device):
    """The model of ``case``'s cfg (with its ``set_network``) holding the
    case's weights on ``device``, its optimizer and train state."""
    cfg = load_config(case["cfg"])
    eval_entry.apply_network_overrides(cfg, case["set_network"])
    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(SEED))
    model.load_state_dict(torch.load(case["weights"], map_location=device))
    tx, _ = make_optimizer(cfg, 1, model)
    return cfg, tx, init_train_state(model, tx)


def dp_step(case: dict, mesh, steps: int = 2, around_first=contextlib.nullcontext) -> dict:
    """``steps`` train steps of ``case`` on this rank's rows of its global
    batch (with a spatial axis, its rows of every frame, as the train entry
    point cuts them): the first step's loss (the global batch's), launches,
    gradients (the summed f32 ones the update takes) and running
    statistics, the last step's ms and all-reduce ms (CUDA synchronized),
    the peak memory of the steps (the weights, masters and momentum
    included), and whether the masters equal rank 0's bit for bit after the
    steps. ``around_first``: a context the first step runs in."""
    cfg, tx, state = dp_train_state(case, mesh.device if mesh else "cuda")
    replicated(mesh, state.model, state)
    tr = cfg.TRAIN
    grads, update = [], tx.update

    def recording(g, opt_state, params):
        grads.append(g)
        update(g, opt_state, params)

    tx.update = recording
    step = make_train_step(tx, int(cfg.dataset.NUM_CLASSES),
                           ohem_fraction=float(tr.ohem_fraction) or None,
                           aux_weight=float(tr.aux_loss_weight), objective=str(tr.objective),
                           propagate=str(cfg.network.propagate), remat=bool(tr.remat), mesh=mesh)
    host = (case["batch"] if mesh is None
            else train_entry.frame_rows(mesh, shard_batch(mesh, case["batch"])))
    batch = to_device(host, "cuda" if mesh is None else mesh.device, keys=tuple(host))
    out = dict(rows=int(batch["label"].shape[0]), frame_rows=int(batch["label"].shape[-2]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with all_reduces_recorded() as reduces:
        for i in range(steps):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with around_first() if i == 0 else contextlib.nullcontext():
                state, metrics = step(state, batch)
            torch.cuda.synchronize()
            out["step_ms"] = (time.perf_counter() - t0) * 1e3
            if i == 0:
                out.update(loss=float(metrics["loss"]), launches=counts(), grads=grads[0],
                           first_step_ms=out["step_ms"],
                           stats={k: v.cpu() for k, v in running_stats(state.model).items()})
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    out["all_reduce_ms"] = reduces[-1]["ms"] if reduces else None
    out["all_reduce_numel"] = reduces[-1]["numel"] if reduces else None
    out["reduces"] = reduces[:1]
    flat = torch.cat([p.reshape(-1) for p in state.master.values()])
    out["masters_equal_rank0"] = True
    if mesh is not None and mesh.data * mesh.spatial > 1:
        rank0 = flat.clone()
        dist.broadcast(rank0, src=0, group=mesh.group)
        out["masters_equal_rank0"] = torch.equal(rank0, flat)
    out["state"] = state
    return out


def dp_rank(spec_path: str, rank: str, world: str) -> int:
    """One rank of ``e2e_dp`` (``python3 chip_smoke.py --dp-rank SPEC RANK
    WORLD``): each train case of the spec (two steps) under a gloo group of
    the ranks on the one card, then the flagship cfg's eval through the
    eval entry point under ``torchrun``'s variables. Writes its results to
    ``SPEC.rank<RANK>``."""
    rank, world = int(rank), int(world)
    spec = torch.load(spec_path, weights_only=False)
    if "spatial_train" in spec:
        return spatial_train_rank(spec, spec_path, rank, world)
    if "spatial" in spec:
        return spatial_rank(spec, spec_path, rank, world)
    results = {}
    cfg = load_config(spec["cases"]["train"]["cfg"])
    mesh = mesh_from_cfg(cfg, device="cuda", init_method=spec["init"], rank=rank,
                         world_size=world)
    try:
        results["backend"] = dist.get_backend(mesh.group)
        for name, case in spec["cases"].items():
            out = dp_step(case, mesh)
            if rank == 0:
                torch.save({n: g.cpu() for n, g in out["grads"].items()}, case["grads_out"])
            results[name] = {k: v for k, v in out.items()
                             if k not in ("grads", "state", "reduces")}
            del out
            torch.cuda.empty_cache()
    finally:
        mesh.close()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(spec["eval"]["port"]))
    reset_counts()
    (result,) = eval_entry.main(spec["eval"]["argv"])
    results["eval"] = dict(miou=result["miou"], stats=result["stats"], launches=counts())
    for name in DP_INT8_RUNS:
        os.environ["MASTER_PORT"] = str(spec[name]["port"])
        reset_counts()
        with (own_scales() if name.endswith("_own") else contextlib.nullcontext(),
              quant_ops.scales_recorded() as scales):
            (result,) = eval_entry.main(spec[name]["argv"])
        results[name] = dict(miou=result["miou"], stats=result["stats"], launches=counts(),
                             scales=torch.stack(scales).float().cpu())
    torch.save(results, f"{spec_path}.rank{rank}")
    return 0


# the int8 evals of the ranks: their flags beside ``--quantize``, and the L1
# distance of their confusion from one process's quantized eval on the same
# global batches as a share of the valid pixels: within it, and for a
# control whose ranks take each its own absmax (``own_scales``, not the
# reference's call's scale) above it. The cfg in bf16 as shipped, and in
# f32 with FrozenBN (TF32 off), where a rank's activations are one
# process's to the bit and its scales are held to one process's: with
# GroupNorm, f32 sums at N=1 and N=2 round apart, and one ulp at a
# rounding boundary flips an int8 step (f32 GroupNorm read scales 5.6% off
# one process's). The limits sit between the readings on an NVIDIA H100
# 80GB HBM3 (700 W; PERF.md): bf16 0.175% sound, 0.239% control; f32
# FrozenBN 0 sound, 0.156% control
F32_FROZENBN = ("--set-network", "dtype=float32", "--set-network", "norm=frozenbn")
DP_INT8_RUNS = {"eval_int8": ((), 0.002), "eval_int8_own": ((), 0.002),
                "eval_int8_f32": (F32_FROZENBN, 0.0001),
                "eval_int8_f32_own": (F32_FROZENBN, 0.0001)}


@contextlib.contextmanager
def own_scales():
    """The control of ``e2e_dp_eval_int8``: each rank's int8 calls take
    their own absmax for the duration, not the world's (the scale group's
    max the identity)."""
    group_max = quant_ops.process_group_max
    quant_ops.process_group_max = lambda group: lambda t: t
    try:
        yield
    finally:
        quant_ops.process_group_max = group_max


def run_ranks(spec_path: Path, world: int, timeout: float = 600.0) -> list[dict]:
    """``world`` processes of ``dp_rank`` on ``spec_path``; each one's
    results. A rank that fails fails the phase; every rank is stopped
    before this returns."""
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-rank",
                               str(spec_path), str(r), str(world)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    failed = [f"rank {r} exited {p.returncode}:\n{log[-6000:]}"
              for r, (p, log) in enumerate(zip(procs, logs)) if p.returncode != 0]
    check(not failed, "ranks of " + spec_path.name + " failed: " + "\n".join(failed))
    return [torch.load(f"{spec_path}.rank{r}", weights_only=False) for r in range(world)]


def dp_case(root: Path, data: Path, name: str, cfg_name: str, set_network: tuple,
            seed: int) -> dict:
    """A train case of ``e2e_dp``: the cfg as shipped (with ``set_network``)
    on the train tree, the model's seeded weights with live flow heads and
    the loader's first global batch, written where the ranks read them."""
    path = eval_cfg(cfg_name, root, data, stem=name, end_epoch=1)
    cfg = load_config(str(path))
    eval_entry.apply_network_overrides(cfg, set_network)
    imdb = Cityscape(cfg.dataset.image_set, str(root / f"cache_{name}"), str(data))
    objective = str(cfg.TRAIN.objective)
    host = next(iter((TrainClipLoader if objective == "clip" else TrainPairLoader)(
        imdb, cfg, seed=1)))
    model = build_model(cfg, device="cuda", generator=torch.Generator().manual_seed(SEED))
    batch = to_device(host, "cuda", keys=tuple(host))
    frames = (batch["clip"] if objective == "clip" else torch.stack(
        [batch["data_ref"], batch["data"]], dim=1)).permute(0, 1, 3, 4, 2)
    max_flow = live_flow_heads(model, frames, seed)
    check(max_flow > 0.5, f"{name}: flow {max_flow} too small to exercise the warp")
    weights = root / f"{name}.weights.pt"
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, weights)
    del model, batch
    return dict(cfg=str(path), set_network=tuple(set_network), weights=str(weights),
                batch=host, grads_out=str(root / f"{name}.grads.pt"), max_abs_flow=max_flow,
                global_batch={k: list(v.shape) for k, v in host.items()})


def dp_agreement(grads: dict, loss: float, ref: dict) -> dict:
    """A step's gradients and loss against another's (``ref``): the loss's
    relative difference, each gradient's cosine (``grad_agreement``) and
    the cosine of all the gradients as one vector (``cosine_all``)."""
    out = grad_agreement((loss, grads, None), (ref["loss"], ref["grads"], None))
    dot = sum((grads[n].double() * ref["grads"][n].double()).sum() for n in grads)
    na = sum(grads[n].double().square().sum() for n in grads)
    nb = sum(ref["grads"][n].double().square().sum() for n in grads)
    out["cosine_all"] = float(dot / (na * nb).sqrt())
    return out


def e2e_dp(root: Path, data: Path) -> dict[str, dict[str, int]]:
    """Phase 23: data parallelism (``parallel/mesh.py``) at full width.

    e2e_dp_nccl: the flagship clip step (``accel18_cityscapes.yaml`` as
    shipped: R101 + R18, groupnorm, bf16, B=2 x 5 frames at 768x768,
    remat, aux 0.5) in this process under an NCCL group of one rank: the
    all-reduce leaves every gradient and the loss bit-equal, and the
    masters equal the same SGD update applied to the unreduced gradients
    with no group, bit for bit.

    Two processes then join a gloo group (NCCL refuses two ranks on one
    card), each on its rows of the same global batches, two steps a case,
    against one process on the whole batch:

    e2e_dp_train: the flagship step, B=2 split 1 + 1. In f32 (the cfg with
    ``dtype=float32``): the loss within 1e-3 and every gradient at cosine
    >= 0.999 (section 2's train limits), where rounding is not in the way.
    In bf16 as shipped the ranks' convs run at N=1 where the one process
    runs N=2, so cuDNN rounds them another way (per-tensor cosines down to
    0.86-0.88 in R101's first GroupNorms, printed): the loss is held within
    1e-2 and the cosine of all the gradients as one vector at 0.999. Both:
    the two ranks' masters bit-equal after the steps, each rank's exact #1
    launches (4 forward + 4 recomputed), step ms (the second step) and
    all-reduce ms per rank.

    e2e_dp_train_bn: the pair cfg with ``norm: batchnorm`` (conv7 stem) in
    f32, B=4 split 2 + 2: the loss and every running statistic within
    1e-3, the cosine of all the gradients at 0.999 and of each at
    ``DP_BN_TENSOR_COSINE``, the masters bit-equal across the ranks, 1 #1
    launch a rank; the one-process step rerun from the same start is
    printed beside it (the card's own spread).

    e2e_dp_eval: the flagship cfg's eval through the eval entry point
    under ``torchrun``'s variables, ``TEST.BATCH_IMAGES: 2`` (one clip a
    rank), on a val split of DP_EVAL_CLIPS clips: the confusion matrix
    equal to the one-process entry point's exactly (run with the cfg's 1
    clip a batch, each clip at the ranks' shapes), each rank's 4 #1 and 1
    #2 a clip.

    e2e_dp_eval_int8: that eval with ``--quantize`` (``DP_INT8_RUNS``), in
    bf16 as shipped and in f32 with FrozenBN, against one process's on the
    same global batches of 2 clips: every int8 call's activation scale
    equal on the ranks (one MAX all-reduce each), in f32 within
    ``SPATIAL_SCALE_REL`` of one process's; the confusion's L1 distance
    within the run's limit, and above it for a control run whose ranks
    take each its own absmax; the launches of the unquantized eval.

    Returns each phase's launches (rank 0's for the two-rank phases)."""
    write_city_split(data, "val", DP_EVAL_CLIPS, 1 - K, 0, SEED + 30)
    # the entry points' segdb caches list the val split's 1 snippet of phase 14
    shutil.rmtree(root / "cache", ignore_errors=True)
    f32 = ("dtype=float32",)
    cases = dict(
        train=dp_case(root, data, "e2e_dp_train", "accel18_cityscapes", f32, SEED + 140),
        train_bf16=dp_case(root, data, "e2e_dp_train_bf16", "accel18_cityscapes", (),
                           SEED + 140),
        bn=dp_case(root, data, "e2e_dp_train_bn", "accel18_cityscapes_pair",
                   ("norm=batchnorm", "stem=conv7", *f32), SEED + 141))
    eval_path = eval_cfg("accel18_cityscapes", root, data, stem="e2e_dp_eval")
    text, n = re.subn(r"(?m)^(TEST:\n(?:  .*\n)*?)  BATCH_IMAGES: 1$", r"\g<1>  BATCH_IMAGES: 2",
                      eval_path.read_text())
    check(n == 1, "e2e_dp_eval: TEST.BATCH_IMAGES not set")
    eval_path.write_text(text)
    spec_path = root / "dp_spec.pt"
    eval_argv = ["--cfg", str(eval_path), "--random-weights", "--max-items", str(DP_EVAL_CLIPS)]
    torch.save(dict(init=f"file://{root / 'dp_rendezvous'}", cases=cases,
                    eval=dict(argv=eval_argv, port=free_port()),
                    **{name: dict(argv=[*eval_argv, "--quantize", *flags], port=free_port())
                       for name, (flags, _) in DP_INT8_RUNS.items()}),
               spec_path)

    # e2e_dp_nccl on the shipped bf16 step, which is also its one-process reference
    torch.cuda.empty_cache()
    shipped = cases["train_bf16"]
    mesh = mesh_from_cfg(load_config(shipped["cfg"]), device="cuda",
                         init_method=f"file://{root / 'nccl_rendezvous'}", rank=0, world_size=1)
    try:
        backend = dist.get_backend(mesh.group)
        _, tx, start = dp_train_state(shipped, "cuda")
        initial = {n: p.clone() for n, p in start.master.items()}
        trace = {n: t.clone() for n, t in start.opt_state["trace"].items()}
        del start
        torch.cuda.empty_cache()
        refs = {"train_bf16": dp_step(shipped, mesh, steps=1)}
    finally:
        mesh.close()
    ref = refs["train_bf16"]
    (reduce,) = ref.pop("reduces")
    *before, loss_before = reduce["before"]
    same_grads = all(torch.equal(a, b)
                     for a, b in zip(before, ref["grads"].values(), strict=True))
    same_loss = float(loss_before[0]) == ref["loss"]
    # the same update with no group, on the unreduced gradients
    opt_state = {"count": 0, "trace": trace}
    tx.update(dict(zip(ref["grads"], before)), opt_state, initial)
    same_masters = all(torch.equal(initial[n], p) for n, p in ref["state"].master.items())
    del initial, trace, opt_state, before, reduce, ref["state"]
    torch.cuda.empty_cache()
    emit(dict(phase="e2e_dp_nccl", cfg="experiments/cfgs/accel18_cityscapes.yaml", backend=backend,
              world=1, batch=shipped["global_batch"], loss=ref["loss"],
              all_reduce_ms=ref["all_reduce_ms"], all_reduce_numel=ref["all_reduce_numel"],
              first_step_ms=ref["first_step_ms"], launches=ref["launches"],
              reduced_equal_unreduced=same_grads, loss_equal=same_loss,
              masters_equal_no_group_update=same_masters, card=card()))
    check(backend == "nccl", f"e2e_dp_nccl: backend {backend}")
    check(same_grads and same_loss and same_masters,
          f"e2e_dp_nccl: grads {same_grads}, loss {same_loss}, masters {same_masters}")
    check(ref["launches"] == launches_of(warp=2 * (K - 1), upsample2x=FLOW_RESIZES * 2 * (K - 1)),
          f"e2e_dp_nccl launches {ref['launches']}")
    for name in ("train", "bn"):
        refs[name] = dp_step(cases[name], None, steps=1)
        refs[name].pop("state")
        torch.cuda.empty_cache()
    # the card's own spread: the one-process batchnorm step again from the same start
    rerun = dp_step(cases["bn"], None, steps=1)
    bn_rerun = dp_agreement(rerun["grads"], rerun["loss"], refs["bn"])
    del rerun
    torch.cuda.empty_cache()
    reset_counts()
    (one_eval,) = eval_entry.main(["--cfg", str(eval_cfg("accel18_cityscapes", root, data,
                                                         stem="e2e_dp_eval_one")),
                                   "--random-weights", "--max-items", str(DP_EVAL_CLIPS)])
    one_eval_launched = counts()
    torch.cuda.empty_cache()
    # the quantized eval in one process on the ranks' global batches of 2
    # clips: its int8 scales are those of the whole batch, as the ranks' are
    reset_counts()
    with quant_ops.scales_recorded() as one_scales:
        (one_int8,) = eval_entry.main([*eval_argv, "--quantize"])
    one_int8.update(launches=counts(), scales=torch.stack(one_scales).float().cpu())
    # and in f32 with FrozenBN, where the scales are held to the one process's
    with quant_ops.scales_recorded() as one_scales:
        (one_int8_f32,) = eval_entry.main([*eval_argv, "--quantize", *F32_FROZENBN])
    one_int8_f32.update(scales=torch.stack(one_scales).float().cpu())
    del one_scales
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks(spec_path, DP_RANKS)
    wall_s = time.perf_counter() - t0
    compared = {}
    for name, case in cases.items():
        per_rank, one = [r[name] for r in ranks], refs[name]
        agreement = dp_agreement(torch.load(case["grads_out"], map_location="cuda"),
                                 per_rank[0]["loss"], one)
        stat_err = max([((per_rank[0]["stats"][k] - one["stats"][k]).abs().max()
                         / one["stats"][k].abs().max().clamp_min(1e-12)).item()
                        for k in one["stats"]], default=0.0)
        compared[name] = dict(
            cfg=Path(case["cfg"]).name, set_network=list(case["set_network"]),
            global_batch=case["global_batch"], rows_per_rank=[r["rows"] for r in per_rank],
            max_abs_flow=case["max_abs_flow"], losses=[r["loss"] for r in per_rank],
            one_process_loss=one["loss"], vs_one_process=agreement,
            running_stats=len(one["stats"]), running_stats_max_rel_err=stat_err,
            masters_equal_across_ranks=[r["masters_equal_rank0"] for r in per_rank],
            step_ms_per_rank=[r["step_ms"] for r in per_rank],
            first_step_ms_per_rank=[r["first_step_ms"] for r in per_rank],
            all_reduce_ms_per_rank=[r["all_reduce_ms"] for r in per_rank],
            all_reduce_numel=per_rank[0]["all_reduce_numel"],
            one_process_first_step_ms=one["first_step_ms"],
            launches_per_rank=[r["launches"] for r in per_rank])
        warps = 1 if name == "bn" else 2 * (K - 1)
        expected = launches_of(warp=warps, upsample2x=FLOW_RESIZES * warps)
        for r, out in enumerate(per_rank):
            check(out["launches"] == expected, f"e2e_dp {name} rank {r} launches {out['launches']}")
            check(out["masters_equal_rank0"], f"e2e_dp {name}: rank {r}'s masters differ")
            check(out["loss"] == per_rank[0]["loss"], f"e2e_dp {name}: the ranks' losses differ")
        check(bool(one["stats"]) == (name == "bn"), f"e2e_dp {name}: {len(one['stats'])} stats")
    emit(dict(phase="e2e_dp_train", backend=ranks[0]["backend"], ranks=DP_RANKS,
              f32=compared["train"], bf16_as_shipped=compared["train_bf16"], ranks_wall_s=wall_s,
              card=card()))
    emit(dict(phase="e2e_dp_train_bn", backend=ranks[0]["backend"], ranks=DP_RANKS,
              **compared["bn"], one_process_rerun=bn_rerun, card=card()))
    check(ranks[0]["backend"] == "gloo", f"e2e_dp: backend {ranks[0]['backend']}")
    for name in ("train", "bn"):
        agreement = compared[name]["vs_one_process"]
        check(agreement["loss_rel_diff"] <= 1e-3, f"e2e_dp {name}: loss {agreement}")
        check(agreement["cosine_all"] >= 0.999, f"e2e_dp {name}: gradient {agreement}")
        check(agreement["cosine_min"] >= (0.999 if name == "train" else DP_BN_TENSOR_COSINE),
              f"e2e_dp {name}: gradient cosines {agreement}")
        check(compared[name]["running_stats_max_rel_err"] <= 1e-3,
              f"e2e_dp {name}: running statistics {compared[name]['running_stats_max_rel_err']}")
    bf16 = compared["train_bf16"]["vs_one_process"]
    check(bf16["loss_rel_diff"] <= 1e-2 and bf16["cosine_all"] >= 0.999,
          f"e2e_dp train_bf16: {bf16}")

    cm_one = one_eval["stats"]["confusion"]
    per_rank = [r["eval"] for r in ranks]
    emit(dict(phase="e2e_dp_eval", cfg="experiments/cfgs/accel18_cityscapes.yaml",
              test_batch_images=2, ranks=DP_RANKS, clips=DP_EVAL_CLIPS,
              miou=[r["miou"] for r in per_rank], one_process_miou=one_eval["miou"],
              frames=[r["stats"]["frames"] for r in per_rank],
              fps=[r["stats"]["fps"] for r in per_rank], one_process_fps=one_eval["stats"]["fps"],
              confusion_equal=[bool((r["stats"]["confusion"] == cm_one).all()) for r in per_rank],
              launches_per_rank=[r["launches"] for r in per_rank],
              one_process_launches=one_eval_launched, card=card()))
    for r, out in enumerate(per_rank):
        check((out["stats"]["confusion"] == cm_one).all() and out["miou"] == one_eval["miou"],
              f"e2e_dp_eval rank {r}: confusion differs from the one-process eval's")
        check(out["stats"]["frames"] == DP_EVAL_CLIPS * K, f"e2e_dp_eval frames {out['stats']}")
        per_rank_clips = DP_EVAL_CLIPS // DP_RANKS
        check(out["launches"] == launches_of(warp=(K - 1) * per_rank_clips,
                                             upsample_argmax=per_rank_clips,
                                             upsample2x=FLOW_RESIZES * per_rank_clips),
              f"e2e_dp_eval rank {r} launches {out['launches']}")
    # the quantized evals: int8 scales over the global batch of 2 clips; the
    # controls take each rank's own
    valid = float(one_int8["stats"]["confusion"].sum())
    runs = {}
    for name, (flags, share) in DP_INT8_RUNS.items():
        one = one_int8_f32 if flags else one_int8
        int8 = [r[name] for r in ranks]
        cm = one["stats"]["confusion"]
        runs[name] = dict(
            miou=[out["miou"] for out in int8], one_process_miou=one["miou"],
            frames=[out["stats"]["frames"] for out in int8],
            scored=[float(out["stats"]["confusion"].sum()) for out in int8],
            confusion_equal=[bool((out["stats"]["confusion"] == cm).all()) for out in int8],
            confusion_l1=[float(abs(out["stats"]["confusion"] - cm).sum()) for out in int8],
            int8_scales=scale_agreement([out["scales"] for out in int8], one["scales"]),
            fps=[out["stats"]["fps"] for out in int8], one_process_fps=one["stats"]["fps"],
            launches_per_rank=[out["launches"] for out in int8],
            confusion_l1_limit=share * valid)
    emit(dict(phase="e2e_dp_eval_int8", cfg="experiments/cfgs/accel18_cityscapes.yaml",
              flags=["--quantize"], test_batch_images=2, ranks=DP_RANKS, clips=DP_EVAL_CLIPS,
              valid_pixels=valid, bf16=runs["eval_int8"],
              bf16_control_own_scales=runs["eval_int8_own"], f32_frozenbn=runs["eval_int8_f32"],
              f32_frozenbn_control_own_scales=runs["eval_int8_f32_own"],
              one_process_launches=one_int8["launches"], card=card()))
    for name in ("eval_int8", "eval_int8_f32"):
        run, scales = runs[name], runs[name]["int8_scales"]
        check(scales["equal_across_ranks"] and scales["calls"] > 0
              and scales["max_all_reduces_per_rank"] == [scales["calls"]] * DP_RANKS,
              f"e2e_dp_eval_int8 {name}: the ranks' int8 scales differ {scales}")
        check(name == "eval_int8" or scales["max_rel_diff_vs_one_process"] <= SPATIAL_SCALE_REL,
              f"e2e_dp_eval_int8 {name}: scales off one process's {scales}")
        for r in range(DP_RANKS):
            check(run["frames"][r] == DP_EVAL_CLIPS * K and run["scored"][r] == valid,
                  f"e2e_dp_eval_int8 {name} rank {r}: {run['frames'][r]} frames, "
                  f"{run['scored'][r]} pixels scored")
            check(run["confusion_l1"][r] <= run["confusion_l1_limit"],
                  f"e2e_dp_eval_int8 {name} rank {r}: confusion L1 {run['confusion_l1'][r]} "
                  f"(limit {run['confusion_l1_limit']})")
            check(run["launches_per_rank"][r] == per_rank[r]["launches"],
                  f"e2e_dp_eval_int8 {name} rank {r} launches {run['launches_per_rank'][r]}")
    # the limit tells the per-rank scales apart
    for name in ("eval_int8_own", "eval_int8_f32_own"):
        control, limit = runs[name]["confusion_l1"], runs[name]["confusion_l1_limit"]
        check(min(control) > limit,
              f"e2e_dp_eval_int8 {name}: the per-rank-scale control's L1 {control} is within "
              f"{limit}")
    return {"e2e_dp_nccl": ref["launches"], "e2e_dp_train": ranks[0]["train_bf16"]["launches"],
            "e2e_dp_train_bn": ranks[0]["bn"]["launches"],
            "e2e_dp_eval": per_rank[0]["launches"],
            "e2e_dp_eval_int8": runs["eval_int8"]["launches_per_rank"][0]}


# ---- phase 24: the spatial axis over two ranks on the one card -------------------

SPATIAL_RANKS = 2
# the spatial cases: (net, propagate, frames, interval, seed of the frames and
# the flow heads, each rank's launches a group)
SPATIAL_CASES = {
    "accel18_incremental": (BENCH_NET, "incremental", K, K, SEED + 150,
                            dict(fused_stem=2, warp=K - 1, upsample_argmax=1,
                                 upsample2x=FLOW_RESIZES)),
    # the flagship norm and stem as shipped: groupnorm (its sums over the
    # group), conv7, mean1, bf16. Its random-weight logits (max ~2.6) put
    # more pixels within bf16 rounding of a flip than the clear-margin rule
    # allows for, so it is held through the same weights in f32
    # (SPATIAL_WITNESSED)
    "flagship_incremental": (FLAGSHIP_NET, "incremental", K, K, SEED + 156,
                             dict(warp=K - 1, upsample_argmax=1, upsample2x=FLOW_RESIZES)),
    # the same in f32, on the same frames
    "flagship_f32_incremental": (dict(FLAGSHIP_NET, dtype="float32"), "incremental", K, K,
                                 SEED + 156, dict(warp=K - 1, upsample_argmax=1,
                                                  upsample2x=FLOW_RESIZES)),
    "dff_direct": (DFF_NET, "direct", K, K, SEED + 152,
                   dict(fused_stem=1, warp_onehot=1, upsample_argmax=1,
                        upsample2x=FLOW_RESIZES)),
    # one frame of DeepLab-101 with every dilated conv on #5: 3 layer4 conv2 + fc6
    "deeplab101_pallas": (dict(DEEPLAB_NET, dilated_conv="pallas"), "direct", 1, 1, SEED + 154,
                          dict(fused_stem=1, dilated_conv=4, upsample_argmax=1)),
    # the int8 bench row: every int8 call's activation scale maxed over the
    # ranks (the frame's whole call); in bf16 as served and in f32 on the
    # same weights and frames
    "int8_incremental": (INT8_NET, "incremental", K, K, SEED + 158,
                         dict(fused_stem=2, warp=K - 1, upsample_argmax=1,
                              upsample2x=FLOW_RESIZES)),
    "int8_f32_incremental": (dict(INT8_NET, dtype="float32"), "incremental", K, K, SEED + 158,
                             dict(fused_stem=2, warp=K - 1, upsample_argmax=1,
                                  upsample2x=FLOW_RESIZES)),
    # accel18_fast with both downscales folded (f=2 into the update stem, f=4
    # into FlowNet's conv1 halves): conv7, so no stem kernel; the update
    # branch's scores resized up by 2 besides FlowNet's resizes
    "fold_direct": (FOLD_NET, "direct", K, K, SEED + 160,
                    dict(warp=1, upsample_argmax=1, upsample2x=FLOW_RESIZES + 1)),
    # the bench row with the s2d stem (no stem kernel)
    "s2d_incremental": (dict(BENCH_NET, stem="s2d"), "incremental", K, K, SEED + 162,
                        dict(warp=K - 1, upsample_argmax=1, upsample2x=FLOW_RESIZES)),
}
# a case's class-map limits against one process where they are not
# check_class_maps' (0.99 overall, 0.9999 off near-ties): the DFF row's
# 0.98; the int8 rows at the one-process int8 limits of phase 15, off
# near-ties at 0.999 in f32
SPATIAL_LIMITS = {"dff_direct": (0.98, 0.9999), "int8_incremental": (0.95, 0.99),
                  "int8_f32_incremental": (0.95, 0.999)}
# an int8 call's activation scale on a rank against one process's, in f32
# (TF32 off on both sides): within this relative difference
SPATIAL_SCALE_REL = 1e-6
# bf16 cases held through their weights in f32 (TF32 off, one process), the
# witness of how far bf16 rounding alone moves their class maps: a rank's
# rows differ from the one process's rows at most SPATIAL_WITNESS_RATIO
# times as much as the one process's rows differ from the f32 rows (two bf16
# runs, each that far from f32, differ by about twice that at most), over
# the shard and its boundary band, and on the shard's clear pixels
SPATIAL_WITNESSED = ("flagship_incremental",)
SPATIAL_WITNESS_RATIO = 2.0
# a shard's rows within this many rows of a shard boundary (4 rows of the
# stride-16 maps), where a fault in a halo shows first
SPATIAL_BAND = 64
# the spatial eval's confusion matrices against one process: an L1 of at
# most twice this share of the valid pixels (about 4x the share PERF.md
# records for an H100)
SPATIAL_EVAL_MOVED = 0.003
# each kernel's plain version and the leading arguments of its wrapper it takes
PLAINS = {
    "warp": (warp_ops.warp_plain, 3),
    "upsample_argmax": (ua_ops.upsample_argmax_plain, 2),
    "fused_stem": (stem_ops.fused_stem_plain, 4),
    "warp_onehot": (onehot_ops.warp_onehot_plain, 6),
    "dilated_conv": (dilated_ops.conv3x3_dilated_plain, 3),
    "upsample2x": (upsample_ops.upsample2x_plain, 1),
}

def measured_group(model, frames: torch.Tensor, interval: int, propagate: str) -> dict:
    """One group through ``clip_predictions`` (after the caller's warm-up):
    its class maps, host ms (ending in a synchronize), launches, and the
    peak memory allocated during it, all of it and above what was
    allocated before it (the weights and the frames)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    pred = clip_predictions(model, frames, interval, propagate)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    return dict(pred=pred, ms=ms, launches=counts(), peak_bytes=peak,
                peak_bytes_above_inputs=peak - base)


@contextlib.contextmanager
def cudnn_tf32(enabled: bool):
    """cuDNN's f32 convs on TF32 (PyTorch's default) or not, for the duration."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def spatial_group(model, frames: torch.Tensor, interval: int, propagate: str,
                  shard=None) -> dict:
    """A measured group (``measured_group``) after a warm-up, under
    PyTorch's default cuDNN TF32 flag, as the port serves (with ``shard``:
    the halo counters of the measured group, held equal to the warm-up's);
    then, with TF32 off as the rest of this script runs, the peak memory of
    another group (``*_tf32_off``): at a shard's shapes cuDNN may pick an
    algorithm for an f32 conv (FlowNet's flow heads) with a large workspace."""
    with cudnn_tf32(True):
        before = shard.counters() if shard else {}
        clip_predictions(model, frames, interval, propagate)
        warm = shard.counters() if shard else {}
        out = measured_group(model, frames, interval, propagate)
        if shard:
            out["halo"] = {k: v - warm[k] for k, v in shard.counters().items()}
            check(out["halo"] == {k: warm[k] - before[k] for k in warm},
                  f"e2e_spatial: the groups exchanged {out['halo']} and {warm}")
    with cudnn_tf32(False):
        clip_predictions(model, frames, interval, propagate)
        strict = measured_group(model, frames, interval, propagate)
    out.update(peak_bytes_tf32_off=strict["peak_bytes"],
               peak_bytes_above_inputs_tf32_off=strict["peak_bytes_above_inputs"])
    return out


@contextlib.contextmanager
def launches_recorded():
    """Every launch of each kernel's wrapper, for the duration: (kernel,
    copies of the arguments its plain version takes, a copy of the
    output, whether a backward's recompute launched it), in order. A
    wrapper counts its launches on the function its module's name holds,
    the recording one for the duration: the counts pass to it and back."""
    seen = []

    def recording(name: str, launch):
        arity = PLAINS[name][1]

        def recorded(*args):
            out = launch(*args)
            seen.append((name, tuple(a.clone() if isinstance(a, torch.Tensor) else a
                                     for a in args[:arity]), out.clone(),
                           spatial.in_backward()))
            return out

        recorded.__dict__.update(launch.__dict__)
        return recorded

    modules = {name: sys.modules[fn.__module__] for name, fn in LAUNCHERS.items()}
    for name, fn in LAUNCHERS.items():
        setattr(modules[name], fn.__name__, recording(name, fn))
    try:
        yield seen
    finally:
        for name, fn in LAUNCHERS.items():
            fn.__dict__.update(getattr(modules[name], fn.__name__).__dict__)
            setattr(modules[name], fn.__name__, fn)


def held_to_plain(name: str, args: tuple, got: torch.Tensor) -> dict:
    """One launch's output ``got`` against its kernel's plain version on the
    same ``args``, at the kernel's limit in phase 2: a max error within
    ``tol`` (f32: 1e-5 for #1, 1e-5 * max|ref| for #4, 1e-4 * max|ref| for
    #3 and #5; bf16: 1e-2 * max|ref| for #1, one ulp at max|ref| for #4,
    2e-2 * max|ref| for #3 and #5, and at most 0.1% of #3's outputs other
    than the plain version's); #2's class maps equal on >= 0.9999 of the
    pixels, each disagreement within 1e-5 * max|upscaled logits| of a tie;
    #6 equal to its plain version."""
    ref = PLAINS[name][0](*args)
    row = dict(kernel=name, shape=list(args[0].shape), dtype=str(args[0].dtype))
    if name == "upsample_argmax":
        logits, out_hw = args
        up = F.interpolate(logits.float(), size=tuple(out_hw), mode="bilinear",
                           align_corners=False)
        gap = (up.gather(1, ref[:, None].long()) - up.gather(1, got[:, None].long()))[:, 0]
        agree = (got == ref).float().mean().item()
        err, tol = gap.abs().max().item(), 1e-5 * up.abs().max().item()
        return dict(row, agreement=agree, max_abs_err=err, tol=tol,
                    ok=got.shape == ref.shape and agree >= 0.9999 and err <= tol)
    err = (got.float() - ref.float()).abs().max().item()
    peak = ref.float().abs().max().item()
    bf16 = got.dtype == torch.bfloat16
    if name == "warp":
        tol = 1e-2 * peak if bf16 else 1e-5
    elif name == "warp_onehot":
        tol = 2.0 ** (math.floor(math.log2(max(peak, 2.0 ** -126))) - 7) if bf16 else 1e-5 * peak
    elif name == "upsample2x":
        tol = 0.0
    else:
        tol = (2e-2 if bf16 else 1e-4) * peak
    differ = (got != ref).float().mean().item()
    ok = (got.shape == ref.shape and got.dtype == ref.dtype and err <= tol
          and (name != "fused_stem" or not bf16 or differ <= 1e-3))
    return dict(row, max_abs_err=err, tol=tol, differ_share=differ, ok=ok)


def held_launches(model, frames: torch.Tensor, interval: int, propagate: str, mesh) -> list:
    """One group, as the measured groups run it (``spatial_sharding`` of
    ``mesh``, TF32 on), with every kernel launch recorded; then each launch
    held against its kernel's plain version on the very inputs it was given
    (on a spatial rank, the halo-extended shards), outside the context with
    TF32 off (``held_to_plain``)."""
    with (launches_recorded() as launched, cudnn_tf32(True),
          spatial.spatial_sharding(mesh, model)):
        clip_predictions(model, frames, interval, propagate)
    return [held_to_plain(*launch[:3]) for launch in launched]


def held_summary(held: list) -> dict:
    """Per kernel: the launches held, all within their limits (``ok``), the
    worst ``max_abs_err / tol``, the least agreement (#2) and the shapes."""
    out = {}
    for row in held:
        k = out.setdefault(row["kernel"], dict(launches=0, ok=True, worst_err_over_tol=0.0,
                                               shapes=[]))
        k["launches"] += 1
        k["ok"] = k["ok"] and row["ok"]
        k["worst_err_over_tol"] = max(k["worst_err_over_tol"], (
            row["max_abs_err"] / row["tol"] if row["tol"] else float(row["max_abs_err"] > 0)))
        if "agreement" in row:
            k["min_agreement"] = min(k.get("min_agreement", 1.0), row["agreement"])
        if row["shape"] not in k["shapes"]:
            k["shapes"].append(row["shape"])
    return out


def check_held(phase: str, summary: dict, per_kernel: dict) -> None:
    """Every launch of ``per_kernel`` {kernel: launches} was held, and
    each within its kernel's limit."""
    check({k: v["launches"] for k, v in summary.items()} == per_kernel,
          f"{phase}: launches held {summary}, expected {per_kernel}")
    check(all(v["ok"] for v in summary.values()), f"{phase}: a kernel against plain {summary}")


def boundary_band(index: int, rows: int) -> torch.Tensor:
    """The rows of spatial rank ``index``'s shard of ``rows`` rows within
    SPATIAL_BAND rows of a shard boundary."""
    band = torch.zeros(rows, dtype=torch.bool)
    if index > 0:
        band[:SPATIAL_BAND] = True
    if index < SPATIAL_RANKS - 1:
        band[-SPATIAL_BAND:] = True
    return band


def shard_agreement(index: int, pred: torch.Tensor, want: torch.Tensor,
                    clear: torch.Tensor) -> dict:
    """Spatial rank ``index``'s class-map rows ``pred`` (F, h, W) against
    its rows of the whole maps ``want`` (F, H, W), with the clear pixels
    ``clear`` (F, H, W) (``class_map_agreement``), over the shard and over
    its boundary band (``band``)."""
    h = pred.shape[-2]
    rows = slice(index * h, (index + 1) * h)
    want, clear, band = want[:, rows], clear[:, rows], boundary_band(index, h)
    return dict(class_map_agreement(pred, want, clear),
                band=class_map_agreement(pred[:, band], want[:, band], clear[:, band]))


def int8_scales(model, frames: torch.Tensor, interval: int, propagate: str):
    """Every int8 call's activation scale in one group of ``model`` (TF32
    off), as an f32 tensor; None for a model without int8 convs."""
    if not model.quantized:
        return None
    with cudnn_tf32(False), quant_ops.scales_recorded() as scales:
        clip_predictions(model, frames, interval, propagate)
    return torch.stack(scales).float().cpu()


def scale_agreement(per_rank: list, one: torch.Tensor | None) -> dict | None:
    """The ranks' int8 scales against each other and against one process's
    (the number of calls: one MAX all-reduce each on a rank)."""
    if one is None:
        return None
    return dict(calls=len(one), max_all_reduces_per_rank=[len(s) for s in per_rank],
                equal_across_ranks=all(torch.equal(s, per_rank[0]) for s in per_rank),
                max_rel_diff_vs_one_process=max(
                    ((s - one).abs() / one.abs()).max().item() for s in per_rank))


def spatial_rank(spec: dict, spec_path: str, rank: int, world: int) -> int:
    """One rank of ``e2e_spatial``: each case's group on this rank's rows of
    the frames under a ``data=1 x spatial=world`` mesh (gloo), with every
    launch of a group held against its plain version (``held_launches``),
    then the flagship cfg's eval through the eval entry point under
    ``torchrun``'s variables with ``tpu.mesh.spatial: world``, its launches
    held the same way. Writes its results to ``SPEC.rank<RANK>``."""
    results = {}
    mesh = mesh_from_cfg(load_config(spec["cfg"]), device="cuda", init_method=spec["init"],
                         rank=rank, world_size=world)
    try:
        results["backend"] = dist.get_backend(mesh.spatial_group)
        for name, case in spec["cases"].items():
            net, propagate, _, interval, _, _ = SPATIAL_CASES[name]
            model = build_model(net, device="cuda", generator=torch.Generator().manual_seed(SEED))
            model.load_state_dict(torch.load(case["weights"], map_location="cuda"))
            frames = torch.load(case["frames"])
            mine = frames[:, :, spatial.frame_rows(mesh, frames.shape[2])].cuda()
            held = held_summary(held_launches(model, mine, interval, propagate, mesh))
            with spatial.spatial_sharding(mesh, model) as shard:
                out = spatial_group(model, mine, interval, propagate, shard)
                scales = int8_scales(model, mine, interval, propagate)
            results[name] = dict(out, pred=out["pred"].cpu(), held=held, scales=scales)
            del model, mine, out
            torch.cuda.empty_cache()
    finally:
        mesh.close()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(spec["eval"]["port"]))
    reset_counts()
    with launches_recorded() as launched:
        (result,) = eval_entry.main(spec["eval"]["argv"])
    results["eval"] = dict(miou=result["miou"], stats=result["stats"], launches=counts(),
                           held=held_summary([held_to_plain(*launch[:3])
                                              for launch in launched]))
    torch.save(results, f"{spec_path}.rank{rank}")
    return 0


def e2e_spatial(root: Path, data: Path, valid_per_clip: int) -> dict[str, dict[str, int]]:
    """Phase 24: the spatial axis (``parallel/spatial.py``) at 1024x2048:
    two gloo ranks on the one card (processes of this script,
    ``--dp-rank``), ``tpu.mesh.spatial: 2``, each on its 512 rows of every
    frame, against one process on the whole frames.

    e2e_spatial: the Accel-18 bench row, incremental, B=1, k=5 (#1, #2,
    #3); the same with the flagship's groupnorm, conv7 and mean1 (#1, #2;
    the sums over the group), in bf16 and in f32; the DFF row, direct (#3,
    #4, #2); one DeepLab-101 frame with ``dilated_conv: pallas`` (#3, #5,
    #2); the int8 bench row (``INT8_NET``; #3, #1, #2), in bf16 and in f32
    on the same weights and frames, every int8 call's activation scale
    recorded on each rank and in one process (TF32 off; one MAX
    all-reduce a call on a rank): equal on the ranks, and in f32 within
    ``SPATIAL_SCALE_REL`` of the one process's; the folded fast model
    (``FOLD_NET``, direct: f=2 in the update stem, f=4 in FlowNet's conv1
    halves; #1, #2); the bench row with ``stem: s2d`` (#1, #2). The class
    maps at ``SPATIAL_LIMITS`` where a case has its own. On each rank every kernel launch of a group is held against its
    plain version on the halo-extended shard it was given, at phase 2's
    limits (``held_launches``). Each rank's class-map rows go against the
    one-process ``push_group`` rows under ``check_class_maps``' limits
    (the clear pixels of the one-process model's logits: cuDNN picks other
    algorithms at the shards' shapes and bf16 near-ties flip), over the
    shard and over its band of SPATIAL_BAND rows at the shard boundary; the
    bf16 flagship, whose random-weight logits leave more near-ties than
    those limits allow for, is held against the one process's rows through
    its f32 witness instead (SPATIAL_WITNESSED: the one process's bf16 rows
    against the same weights in f32 say how far bf16 rounding alone moves
    them; the ranks' rows against f32 are printed too). Each rank's
    launches exactly;
    per rank its halo exchanges and their bytes a group, its peak memory
    against one process's, and its ms a group (printed: the two ranks
    share the card and their exchanges go through the host). These groups
    run under PyTorch's default cuDNN TF32 flag, as the port serves; the
    peak memory with TF32 off (this script's setting elsewhere) is printed
    beside it (``spatial_group``).

    e2e_spatial_eval: the flagship cfg (groupnorm, conv7, mean1; #1, #2)
    through the eval entry point under ``torchrun``'s variables with
    ``tpu.mesh.spatial: 2`` on the eval tree, against the one-process
    entry point: every launch held against its plain version, the
    confusion matrices within an L1 of 2 * SPATIAL_EVAL_MOVED of the valid
    pixels (exact equality printed), the mIoU within 1 point, the global
    frames, each rank's launches exactly.

    Returns each part's launches per rank (rank 0's)."""
    cases, one = {}, {}
    for name, (net, propagate, n_frames, interval, seed, _) in SPATIAL_CASES.items():
        model = build_model(net, device="cuda", generator=torch.Generator().manual_seed(SEED))
        frames = moving_clip(n_frames, (H, W), seed, "cuda")
        max_flow = (live_flow_heads(model, frames if n_frames > 1 else frames.repeat(1, 2, 1, 1, 1),
                                    seed + 1) if hasattr(model, "flownet") else None)
        out = spatial_group(model, frames, interval, propagate)
        # push_group is clip_predictions of the group
        with cudnn_tf32(True):
            check(torch.equal(out["pred"], VideoSegmenter(model, interval, propagate=propagate)
                              .push_group(frames)),
                  f"e2e_spatial {name}: push_group and clip_predictions differ")
            clear, logits_peak, _ = clear_pixels(model, frames, propagate, interval)
        one[name] = dict(out, pred=out["pred"].cpu(), clear=clear.cpu(),
                         logits_max_abs=logits_peak, max_abs_flow=max_flow,
                         scales=int8_scales(model, frames, interval, propagate))
        if name in SPATIAL_WITNESSED:
            exact = build_model(dict(net, dtype="float32"), device="cuda",
                                generator=torch.Generator().manual_seed(SEED))
            exact.load_state_dict(model.state_dict())
            one[name]["f32_pred"] = clip_predictions(exact, frames, interval, propagate).cpu()
            del exact
        cases[name] = dict(weights=str(root / f"spatial_{name}.pt"),
                           frames=str(root / f"spatial_{name}.frames.pt"))
        torch.save(model.state_dict(), cases[name]["weights"])
        torch.save(frames.cpu(), cases[name]["frames"])
        del model, frames, out, clear
        torch.cuda.empty_cache()

    # the flagship cfg's eval, one process and on the spatial mesh
    reset_counts()
    argv = ["--random-weights", "--max-items", str(EVAL_SNIPPETS)]
    (one_eval,) = eval_entry.main(["--cfg", str(eval_cfg("accel18_cityscapes", root, data,
                                                         stem="e2e_spatial_eval_one")), *argv])
    one_eval_launched = counts()
    path = eval_cfg("accel18_cityscapes", root, data, stem="e2e_spatial_eval")
    path.write_text(path.read_text().rstrip("\n")
                    + f"\ntpu:\n  mesh:\n    spatial: {SPATIAL_RANKS}\n")
    torch.cuda.empty_cache()
    spec_path = root / "spatial_spec.pt"
    torch.save(dict(spatial=SPATIAL_RANKS, init=f"file://{root / 'spatial_rendezvous'}",
                    cfg=str(path), cases=cases,
                    eval=dict(argv=["--cfg", str(path), *argv], port=free_port())), spec_path)
    t0 = time.perf_counter()
    ranks = run_ranks(spec_path, SPATIAL_RANKS)
    wall_s = time.perf_counter() - t0

    rows = H // SPATIAL_RANKS
    parts = {}
    for name, (net, propagate, n_frames, interval, _, per_group) in SPATIAL_CASES.items():
        ref = one[name]
        per_rank = [r[name] for r in ranks]
        part = dict(
            config=name, propagate=propagate, hw=[H, W], B=1, frames=n_frames,
            max_abs_flow=ref["max_abs_flow"], logits_max_abs=ref["logits_max_abs"],
            class_maps_per_rank=[shard_agreement(i, out["pred"][0], ref["pred"][0], ref["clear"])
                                 for i, out in enumerate(per_rank)],
            held_per_rank=[out["held"] for out in per_rank],
            halo_per_rank=[out["halo"] for out in per_rank],
            group_ms_per_rank=[out["ms"] for out in per_rank], one_process_group_ms=ref["ms"],
            peak_mb_per_rank=[out["peak_bytes"] / 2**20 for out in per_rank],
            one_process_peak_mb=ref["peak_bytes"] / 2**20,
            peak_mb_above_inputs_per_rank=[out["peak_bytes_above_inputs"] / 2**20
                                           for out in per_rank],
            one_process_peak_mb_above_inputs=ref["peak_bytes_above_inputs"] / 2**20,
            peak_mb_above_inputs_tf32_off_per_rank=[
                out["peak_bytes_above_inputs_tf32_off"] / 2**20 for out in per_rank],
            one_process_peak_mb_above_inputs_tf32_off=(
                ref["peak_bytes_above_inputs_tf32_off"] / 2**20),
            launches_per_rank=[out["launches"] for out in per_rank],
            one_process_launches=ref["launches"],
            int8_scales=scale_agreement([out["scales"] for out in per_rank], ref["scales"]))
        if name in SPATIAL_WITNESSED:
            part["f32_witness"] = dict(
                one_process=[shard_agreement(i, ref["pred"][0, :, i * rows:(i + 1) * rows],
                                             ref["f32_pred"][0], ref["clear"])
                             for i in range(SPATIAL_RANKS)],
                ranks=[shard_agreement(i, out["pred"][0], ref["f32_pred"][0], ref["clear"])
                       for i, out in enumerate(per_rank)])
        parts[name] = part
    emit(dict(phase="e2e_spatial", backend=ranks[0]["backend"], ranks=SPATIAL_RANKS,
              rows_per_rank=rows, band_rows=SPATIAL_BAND, ranks_wall_s=wall_s, **parts,
              card=card()))
    check(ranks[0]["backend"] == "gloo", f"e2e_spatial: backend {ranks[0]['backend']}")
    for name, part in parts.items():
        net, per_group = SPATIAL_CASES[name][0], SPATIAL_CASES[name][5]
        expected = launches_of(**per_group)
        check(one[name]["launches"] == expected,
              f"e2e_spatial {name}: one process launched {one[name]['launches']}")
        for r, (launched, c) in enumerate(zip(part["launches_per_rank"],
                                              part["class_maps_per_rank"], strict=True)):
            phase = f"e2e_spatial {name} rank {r}"
            check(launched == expected, f"{phase} launches {launched}")
            check_held(f"{phase} kernels on its shards", part["held_per_rank"][r], per_group)
            if name in SPATIAL_WITNESSED:
                w = part["f32_witness"]["one_process"][r]
                for what, got, want in (("shard", c["agreement"], w["agreement"]),
                                        ("band", c["band"]["agreement"], w["band"]["agreement"]),
                                        ("clear", c["clear_agreement"], w["clear_agreement"])):
                    check(1 - got <= SPATIAL_WITNESS_RATIO * (1 - want),
                          f"{phase} {what}: {got} of the one process's rows, which agree with "
                          f"f32 on {want}")
            else:
                overall, clear = SPATIAL_LIMITS.get(name, (0.99, 0.9999))
                check_class_maps(f"{phase} vs one process", c, overall, clear)
                check_class_maps(f"{phase} band vs one process", c["band"], overall, clear)
            scales = part["int8_scales"]
            if scales is not None:
                check(scales["equal_across_ranks"] and scales["calls"] > 0
                      and scales["max_all_reduces_per_rank"] == [scales["calls"]] * SPATIAL_RANKS,
                      f"{phase}: int8 scales {scales}")
                check(net.get("dtype") != "float32"
                      or scales["max_rel_diff_vs_one_process"] <= SPATIAL_SCALE_REL,
                      f"{phase}: int8 scales against one process's {scales}")
            check(part["halo_per_rank"][r]["exchanges"] > 0, f"e2e_spatial {name}: no exchange")
            check((part["halo_per_rank"][r]["reductions"] > 0) == name.startswith("flagship"),
                  f"e2e_spatial {name}: {part['halo_per_rank'][r]['reductions']} reductions")

    cm_one = one_eval["stats"]["confusion"]
    valid = EVAL_SNIPPETS * valid_per_clip
    limit = 2 * SPATIAL_EVAL_MOVED * valid
    per_rank = [r["eval"] for r in ranks]
    l1 = [float(abs(out["stats"]["confusion"] - cm_one).sum()) for out in per_rank]
    emit(dict(phase="e2e_spatial_eval", cfg="experiments/cfgs/accel18_cityscapes.yaml",
              ranks=SPATIAL_RANKS, clips=EVAL_SNIPPETS, miou=[out["miou"] for out in per_rank],
              one_process_miou=one_eval["miou"],
              frames=[out["stats"]["frames"] for out in per_rank],
              confusion_equal=[bool((out["stats"]["confusion"] == cm_one).all())
                               for out in per_rank],
              confusion_l1=l1, confusion_l1_limit=limit, valid_pixels=valid,
              held_per_rank=[out["held"] for out in per_rank],
              halo_per_rank=[out["stats"]["halo"] for out in per_rank],
              fps=[out["stats"]["fps"] for out in per_rank],
              one_process_fps=one_eval["stats"]["fps"],
              launches_per_rank=[out["launches"] for out in per_rank],
              one_process_launches=one_eval_launched, card=card()))
    per_clip = dict(warp=(K - 1) * EVAL_SNIPPETS, upsample_argmax=EVAL_SNIPPETS,
                    upsample2x=FLOW_RESIZES * EVAL_SNIPPETS)
    expected = launches_of(**per_clip)
    check(one_eval_launched == expected, f"e2e_spatial_eval one process {one_eval_launched}")
    for r, out in enumerate(per_rank):
        check(out["launches"] == expected, f"e2e_spatial_eval rank {r} launches {out['launches']}")
        check_held(f"e2e_spatial_eval rank {r} kernels on its shards", out["held"], per_clip)
        check(out["stats"]["frames"] == EVAL_SNIPPETS * K, f"e2e_spatial_eval frames {out['stats']}")
        check(float(out["stats"]["confusion"].sum()) == valid,
              f"e2e_spatial_eval rank {r}: {out['stats']['confusion'].sum()} pixels scored")
        check(l1[r] <= limit and abs(out["miou"] - one_eval["miou"]) <= 0.01,
              f"e2e_spatial_eval rank {r}: confusion L1 {l1[r]} (limit {limit}), mIoU "
              f"{out['miou']} against {one_eval['miou']}")
    launched = {name: ranks[0][name]["launches"] for name in SPATIAL_CASES}
    launched["eval"] = per_rank[0]["launches"]
    return launched

# ---- phase 25: training under the spatial axis, two ranks on the one card -------

# annotated snippets of the entry point's train split: two steps of B=2
SPATIAL_TRAIN_SNIPPETS = 4
# each case's launches a rank a step: #1's 4 step warps, forward and again in
# remat's recompute; with every dilated conv on #5, e2e_train_dilated's 38
# forward, 29 recomputed and 38 dx launches; the pair step's one warp. A
# FlowNet pass (#6) with each warp.
_STEP_WARPS = dict(warp=K - 1, upsample2x=FLOW_RESIZES * (K - 1))
SPATIAL_TRAIN_LAUNCHES = {
    "train": dict(forward=_STEP_WARPS, recomputed=_STEP_WARPS, dx=0),
    "train_bf16": dict(forward=_STEP_WARPS, recomputed=_STEP_WARPS, dx=0),
    "dilated": dict(forward=dict(_STEP_WARPS, dilated_conv=38),
                    recomputed=dict(_STEP_WARPS, dilated_conv=29), dx=38),
    "bn": dict(forward=dict(warp=1, upsample2x=FLOW_RESIZES), recomputed={}, dx=0),
    "s2d_fold": dict(forward=_STEP_WARPS, recomputed=_STEP_WARPS, dx=0),
}


@contextlib.contextmanager
def shards_recorded():
    """Every ``SpatialShard`` a ``spatial_sharding`` context opens (one a
    train step), for the duration."""
    opened, seen = spatial.spatial_sharding, []

    @contextlib.contextmanager
    def recording(mesh, model):
        with opened(mesh, model) as shard:
            seen.append(shard)
            yield shard

    spatial.spatial_sharding = recording
    try:
        yield seen
    finally:
        spatial.spatial_sharding = opened


@contextlib.contextmanager
def dx_recorded():
    """Every dx launch of #5 (copies of the gradient and the weights, the
    dilation, a copy of the output), for the duration."""
    launch, seen = dilated_ops.conv3x3_dilated_dx_cuda, []

    def recorded(grad, weight, dilation, packed_dx=None):
        out = launch(grad, weight, dilation, packed_dx)
        seen.append((grad.clone(), weight.clone(), dilation, out.clone()))
        return out

    dilated_ops.conv3x3_dilated_dx_cuda = recorded
    try:
        yield seen
    finally:
        dilated_ops.conv3x3_dilated_dx_cuda = launch


def held_dx(grad: torch.Tensor, weight: torch.Tensor, dilation: int, got: torch.Tensor) -> dict:
    """One dx launch against #5's plain dx (``F.conv2d`` on the rotated
    weights) on the same gradient and weights, at #5's limit in phase 2:
    1e-4 * max|ref| in f32, 2e-2 * max|ref| in bf16."""
    ref = dilated_ops.conv3x3_dilated_dx_plain(grad, weight, dilation)
    err = (got.float() - ref.float()).abs().max().item()
    tol = (2e-2 if got.dtype == torch.bfloat16 else 1e-4) * ref.float().abs().max().item()
    return dict(kernel="dilated_conv_dx", shape=list(grad.shape), dtype=str(grad.dtype),
                max_abs_err=err, tol=tol,
                ok=got.shape == ref.shape and got.dtype == ref.dtype and err <= tol)


def held_train_step(launched: list, dx: list) -> dict:
    """A train step's launches held against their plain versions on the
    inputs they were given (``held_to_plain``, ``held_dx``): the forward's,
    the recompute's and the dx launches, summed up apart."""
    rows = {"forward": [], "recomputed": []}
    for name, args, got, recomputed in launched:
        rows["recomputed" if recomputed else "forward"].append(held_to_plain(name, args, got))
    return dict(forward=held_summary(rows["forward"]), recomputed=held_summary(rows["recomputed"]),
                dx=held_summary([held_dx(*launch) for launch in dx]))


def digest(tensors: dict) -> str:
    """A SHA-256 of the tensors' bytes in key order: equal digests, equal
    tensors bit for bit."""
    h = hashlib.sha256()
    for key in sorted(tensors):
        h.update(key.encode())
        h.update(tensors[key].detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def spatial_train_rank(spec: dict, spec_path: str, rank: int, world: int) -> int:
    """One rank of ``e2e_spatial_train``: each case's two train steps
    (``dp_step``) on this rank's rows of the global batch under a ``data=1
    x spatial=world`` mesh (gloo), the first step's launches recorded and
    held against their plain versions and its shard's counters kept; then
    the train entry point under ``torchrun``'s variables with
    ``tpu.mesh.spatial: world``. Writes its results to ``SPEC.rank<RANK>``."""
    results = {}
    mesh = mesh_from_cfg(load_config(spec["cfg"]), device="cuda", init_method=spec["init"],
                         rank=rank, world_size=world)
    try:
        results["backend"] = dist.get_backend(mesh.spatial_group)
        for name, case in spec["cases"].items():
            records = {}

            @contextlib.contextmanager
            def recording(records=records):
                with launches_recorded() as launched, dx_recorded() as dx:
                    yield
                records.update(launched=launched, dx=dx)

            with shards_recorded() as shards:
                out = dp_step(case, mesh, around_first=recording)
            held = held_train_step(records.pop("launched"), records.pop("dx"))
            if rank == 0:
                torch.save({n: g.cpu() for n, g in out["grads"].items()}, case["grads_out"])
            results[name] = {k: v for k, v in out.items()
                             if k not in ("grads", "state", "reduces")}
            results[name].update(held=held, halo=shards[0].counters(),
                                 steps_exchanged_alike=all(
                                     s.counters() == shards[0].counters() for s in shards))
            del out, shards
            torch.cuda.empty_cache()
    finally:
        mesh.close()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(spec["entry"]["port"]))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with shards_recorded() as shards:
        state = train_entry.main(spec["entry"]["argv"])
    results["entry"] = dict(steps=state.step, wall_s=time.perf_counter() - t0, launches=counts(),
                            peak_bytes=torch.cuda.max_memory_allocated(),
                            halo=shards[0].counters(), master_digest=digest(state.master))
    torch.save(results, f"{spec_path}.rank{rank}")
    return 0


def trace_agreement(ckpt: dict, ref: dict) -> dict:
    """Two train checkpoints' momentum traces (the gradients the steps
    took, weight decay included): each tensor's cosine (min, the number
    under 0.999) and the masters' largest relative difference."""
    trace, ref_trace = ckpt["optimizer"]["trace"], ref["optimizer"]["trace"]
    cos = sorted((cosine(trace[n], ref_trace[n]), n) for n in ref_trace)
    master_err = max(((ckpt["model"][n] - ref["model"][n]).abs().max()
                      / ref["model"][n].abs().max().clamp_min(1e-12)).item() for n in ref_trace)
    return dict(trace_cosine_min=cos[0][0], trace_under_0999=sum(c < 0.999 for c, _ in cos),
                worst=[(n, c) for c, n in cos[:3]], params=len(cos),
                master_max_rel_diff=master_err)


def e2e_spatial_train(root: Path, data: Path) -> dict:
    """Phase 25: training under the spatial axis (``parallel/spatial.py``,
    the exchanges' and the group sums' backward) at the flagship's width:
    two gloo ranks on the one card (processes of this script,
    ``--dp-rank``), ``tpu.mesh.spatial: 2``, each on its 384 rows of the
    768x768 crops of the same global batches, two steps a case, against
    one process on the whole batch.

    (a) the flagship clip step (``accel18_cityscapes.yaml``: R101 + R18,
    groupnorm, B=2 x 5 frames, remat, aux 0.5) in f32: the loss within
    1e-3 and every gradient at cosine >= 0.999 (section 2's train limits).
    (b) the same in bf16 as shipped, held as ``e2e_dp_train`` holds bf16:
    the loss within 1e-2 and all the gradients as one vector at 0.999.
    (c) the flagship with ``dilated_conv: pallas`` in bf16: every #1 and
    #5 launch of a rank, forward, recomputed and dx, held against its
    plain version on the very inputs the rank gave it. (d) the pair cfg
    with ``norm: batchnorm`` (conv7 stem) in f32, B=4: as ``e2e_dp_train_bn``
    holds it, the running statistics within 1e-3. (d') the flagship step in
    f32 with ``stem: s2d`` and ``fold_flow_downscale`` (their halos through
    ``halo_apply``, again in remat's recompute), at (a)'s limits. (e) the train entry
    point under ``torchrun``'s variables with ``tpu.mesh.spatial: 2`` in
    f32 on a train split of SPATIAL_TRAIN_SNIPPETS snippets (two steps):
    its logged losses within 1e-3 of the one-process entry point's and its
    checkpoint's momentum traces each at cosine >= 0.999.

    Every case: both ranks' masters bit-equal after the steps (the entry
    point's by digest), each rank's exact launches (forward and recomputed
    apart, and dx), each launch held against its plain version, the
    exchanges and all-reduces in the forward, the recompute and the
    backward, halo bytes, step ms and peak memory a rank beside one
    process's (printed, not held: the ranks share the card, and cuDNN picks
    its workspace at the shards' shapes). Returns rank 0's launches per
    case, and the split of (c)'s."""
    f32 = ("dtype=float32",)
    cases = dict(
        train=dp_case(root, data, "e2e_spatial_train", "accel18_cityscapes", f32, SEED + 170),
        train_bf16=dp_case(root, data, "e2e_spatial_train_bf16", "accel18_cityscapes", (),
                           SEED + 170),
        dilated=dp_case(root, data, "e2e_spatial_train_dilated", "accel18_cityscapes",
                        ("dilated_conv=pallas",), SEED + 170),
        bn=dp_case(root, data, "e2e_spatial_train_bn", "accel18_cityscapes_pair",
                   ("norm=batchnorm", "stem=conv7", *f32), SEED + 171),
        s2d_fold=dp_case(root, data, "e2e_spatial_train_s2d_fold", "accel18_cityscapes",
                         ("stem=s2d", "fold_flow_downscale=true", *f32), SEED + 173))
    # the entry points' own root: their segdb cache lists this split alone
    entry_root = root / "spatial_train"
    entry_data = entry_root / "cityscapes"
    write_city_split(entry_data, "train", SPATIAL_TRAIN_SNIPPETS, 1 - K, K - 1, SEED + 172)
    entry_argv = ["--frequent", "1", "--set-network", "dtype=float32"]
    one_path = eval_cfg("accel18_cityscapes", entry_root, entry_data,
                        stem="e2e_spatial_train_entry_one", end_epoch=1)
    path = eval_cfg("accel18_cityscapes", entry_root, entry_data, stem="e2e_spatial_train_entry",
                    end_epoch=1)
    path.write_text(path.read_text().rstrip("\n")
                    + f"\ntpu:\n  mesh:\n    spatial: {SPATIAL_RANKS}\n")
    spec_path = root / "spatial_train_spec.pt"
    torch.save(dict(spatial_train=True, init=f"file://{root / 'spatial_train_rendezvous'}",
                    cfg=str(path), cases=cases,
                    entry=dict(argv=["--cfg", str(path), *entry_argv], port=free_port())),
               spec_path)

    refs = {}
    for name in ("train", "train_bf16", "bn", "s2d_fold"):
        refs[name] = dp_step(cases[name], None)
        refs[name].pop("state")
        torch.cuda.empty_cache()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    one_state = train_entry.main(["--cfg", str(one_path), *entry_argv])
    one_entry = dict(steps=one_state.step, wall_s=time.perf_counter() - t0, launches=counts(),
                     peak_bytes=torch.cuda.max_memory_allocated())
    del one_state
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks(spec_path, SPATIAL_RANKS)
    wall_s = time.perf_counter() - t0
    compared = {}
    for name, case in cases.items():
        per_rank = [r[name] for r in ranks]
        part = dict(
            cfg=Path(case["cfg"]).name, set_network=list(case["set_network"]),
            global_batch=case["global_batch"],
            rows_per_rank=[[r["rows"], r["frame_rows"]] for r in per_rank],
            max_abs_flow=case["max_abs_flow"], losses=[r["loss"] for r in per_rank],
            masters_equal_across_ranks=[r["masters_equal_rank0"] for r in per_rank],
            step_ms_per_rank=[r["step_ms"] for r in per_rank],
            first_step_ms_per_rank=[r["first_step_ms"] for r in per_rank],
            all_reduce_ms_per_rank=[r["all_reduce_ms"] for r in per_rank],
            peak_mb_per_rank=[r["peak_bytes"] / 2**20 for r in per_rank],
            launches_per_rank=[r["launches"] for r in per_rank],
            held_per_rank=[r["held"] for r in per_rank],
            halo_per_rank=[r["halo"] for r in per_rank],
            steps_exchanged_alike=[r["steps_exchanged_alike"] for r in per_rank])
        if name in refs:
            one = refs[name]
            stat_err = max([((per_rank[0]["stats"][k] - one["stats"][k]).abs().max()
                             / one["stats"][k].abs().max().clamp_min(1e-12)).item()
                            for k in one["stats"]], default=0.0)
            part.update(one_process_loss=one["loss"],
                        vs_one_process=dp_agreement(
                            torch.load(case["grads_out"], map_location="cuda"),
                            per_rank[0]["loss"], one),
                        running_stats=len(one["stats"]), running_stats_max_rel_err=stat_err,
                        one_process_step_ms=one["step_ms"],
                        one_process_first_step_ms=one["first_step_ms"],
                        one_process_peak_mb=one["peak_bytes"] / 2**20,
                        one_process_launches=one["launches"])
        compared[name] = part

    entry_rows = {}
    for stem in ("e2e_spatial_train_entry", "e2e_spatial_train_entry_one"):
        out_dir = entry_root / "out" / stem / "leftImg8bit_train"
        entry_rows[stem] = ([json.loads(ln)["loss"] for ln in
                             (out_dir / "metrics.jsonl").read_text().splitlines()],
                            load_checkpoint(str(out_dir / "accel18"), 0))
    (losses, ckpt), (one_losses, one_ckpt) = entry_rows.values()
    entry_part = dict(
        cfg="experiments/cfgs/accel18_cityscapes.yaml", set_network=["dtype=float32"],
        snippets=SPATIAL_TRAIN_SNIPPETS, steps=[r["entry"]["steps"] for r in ranks],
        one_process_steps=one_entry["steps"], losses=losses, one_process_losses=one_losses,
        loss_rel_diff=[abs(a - b) / abs(b) for a, b in zip(losses, one_losses)],
        vs_one_process=trace_agreement(ckpt, one_ckpt),
        masters_equal_across_ranks=len({r["entry"]["master_digest"] for r in ranks}) == 1,
        wall_s_per_rank=[r["entry"]["wall_s"] for r in ranks], one_process_wall_s=one_entry["wall_s"],
        peak_mb_per_rank=[r["entry"]["peak_bytes"] / 2**20 for r in ranks],
        one_process_peak_mb=one_entry["peak_bytes"] / 2**20,
        launches_per_rank=[r["entry"]["launches"] for r in ranks],
        one_process_launches=one_entry["launches"],
        halo_per_rank=[r["entry"]["halo"] for r in ranks])
    del entry_rows, ckpt, one_ckpt
    emit(dict(phase="e2e_spatial_train", backend=ranks[0]["backend"], ranks=SPATIAL_RANKS,
              f32=compared["train"], bf16_as_shipped=compared["train_bf16"],
              dilated_pallas_bf16=compared["dilated"], pair_batchnorm_f32=compared["bn"],
              s2d_fold_flow_f32=compared["s2d_fold"],
              entry_point_f32=entry_part, ranks_wall_s=wall_s, card=card()))

    check(ranks[0]["backend"] == "gloo", f"e2e_spatial_train: backend {ranks[0]['backend']}")
    for name, part in compared.items():
        want = SPATIAL_TRAIN_LAUNCHES[name]
        per_step = {k: want["forward"].get(k, 0) + want["recomputed"].get(k, 0)
                    for k in LAUNCHERS}
        expected = launches_of(**{k: v for k, v in per_step.items() if v},
                               **({"dilated_conv_dx": want["dx"]} if want["dx"] else {}))
        for r in range(SPATIAL_RANKS):
            phase = f"e2e_spatial_train {name} rank {r}"
            check(part["masters_equal_across_ranks"][r], f"{phase}: masters differ from rank 0's")
            check(part["losses"][r] == part["losses"][0], f"{phase}: the ranks' losses differ")
            check(part["rows_per_rank"][r][1] == int(case_rows(cases[name])) // SPATIAL_RANKS,
                  f"{phase}: rows {part['rows_per_rank'][r]}")
            check(part["launches_per_rank"][r] == expected,
                  f"{phase} launches {part['launches_per_rank'][r]} != {expected}")
            held = part["held_per_rank"][r]
            check_held(f"{phase} forward", held["forward"], want["forward"])
            check_held(f"{phase} recomputed", held["recomputed"], want["recomputed"])
            check_held(f"{phase} dx", held["dx"],
                       {"dilated_conv_dx": want["dx"]} if want["dx"] else {})
            halo = part["halo_per_rank"][r]
            check(halo["exchanges"] > 0 and halo["exchanges_backward"] > 0
                  and halo["reductions"] > 0 and halo["reductions_backward"] > 0
                  and (halo["exchanges_recomputed"] > 0) == (name != "bn"),
                  f"{phase}: exchanges {halo}")
            check(part["steps_exchanged_alike"][r], f"{phase}: the two steps exchanged otherwise")
    for name, limits in (("train", (1e-3, None, 0.999)), ("train_bf16", (1e-2, 0.999, None)),
                         ("bn", (1e-3, 0.999, DP_BN_TENSOR_COSINE)),
                         ("s2d_fold", (1e-3, None, 0.999))):
        a = compared[name]["vs_one_process"]
        loss_lim, all_lim, each_lim = limits
        check(a["loss_rel_diff"] <= loss_lim, f"e2e_spatial_train {name}: loss {a}")
        check(all_lim is None or a["cosine_all"] >= all_lim, f"e2e_spatial_train {name}: {a}")
        check(each_lim is None or a["cosine_min"] >= each_lim,
              f"e2e_spatial_train {name}: gradient cosines {a}")
    check(compared["bn"]["running_stats"] > 0
          and compared["bn"]["running_stats_max_rel_err"] <= 1e-3,
          f"e2e_spatial_train bn: running statistics {compared['bn']['running_stats_max_rel_err']}")
    entry_launches = launches_of(warp=2 * (K - 1) * 2, upsample2x=FLOW_RESIZES * 2 * (K - 1) * 2)
    check(entry_part["steps"] == [2, 2] and entry_part["one_process_steps"] == 2
          and len(losses) == len(one_losses) == 2,
          f"e2e_spatial_train entry: steps {entry_part['steps']}, losses {losses} {one_losses}")
    check(entry_part["masters_equal_across_ranks"], "e2e_spatial_train entry: masters differ")
    check(all(d <= 1e-3 for d in entry_part["loss_rel_diff"]),
          f"e2e_spatial_train entry: losses {losses} against {one_losses}")
    check(entry_part["vs_one_process"]["trace_cosine_min"] >= 0.999,
          f"e2e_spatial_train entry: checkpoint {entry_part['vs_one_process']}")
    for r, launched in enumerate(entry_part["launches_per_rank"] + [one_entry["launches"]]):
        check(launched == entry_launches, f"e2e_spatial_train entry {r}: launches {launched}")
    held = compared["dilated"]["held_per_rank"][0]
    split = {k: dict(forward=held["forward"].get(k, {}).get("launches", 0),
                     recomputed=held["recomputed"].get(k, {}).get("launches", 0))
             for k in ("warp", "dilated_conv")}
    split["dilated_conv"]["dx"] = held["dx"].get("dilated_conv_dx", {}).get("launches", 0)
    return dict(launches={name: ranks[0][name]["launches"] for name in cases}, split=split)


def case_rows(case: dict) -> int:
    """The rows of a case's global batch's frames."""
    return case["global_batch"]["label"][-2]


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
    if sys.argv[1:2] == ["--dp-rank"]:
        return dp_rank(*sys.argv[2:5])

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
    kernel_upsample2x(results)
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
    # per-frame serving: DFF's key frame runs the stem and a tail, a non-key
    # frame a one-hot warp and a tail
    stream_launched = e2e_stream(
        "e2e_stream", "accel18 frozenbn fused7 bf16 push_frame", BENCH_NET, SEED + 16,
        ACCEL_FRAME_LAUNCHES, overall=0.99)
    torch.cuda.empty_cache()
    dff_stream_launched = e2e_stream(
        "e2e_dff_stream", "dff101 frozenbn fused7 bf16 onehot native D=4 push_frame", DFF_NET,
        SEED + 18, dict(key=launches_of(fused_stem=1, upsample_argmax=1),
                        cur=launches_of(warp_onehot=1, upsample_argmax=1,
                                        upsample2x=FLOW_RESIZES)), overall=0.98)
    torch.cuda.empty_cache()
    # a direct group: both stems, one batched warp, one tail, a FlowNet pass;
    # and the update branch's scores resized up by 2 to the feature grid
    # (fast: its half-resolution input; os8-mixed: its stride 16 on a
    # stride-8 grid)
    direct_group = launches_of(fused_stem=2, warp=1, upsample_argmax=1,
                               upsample2x=FLOW_RESIZES + 1)
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
        SEED + 24, launches_of(fused_stem=2, warp=(K - 2) + 1, upsample_argmax=1,
                               upsample2x=FLOW_RESIZES))
    torch.cuda.empty_cache()
    dff_composed_launched = e2e_variant(
        "e2e_dff_composed", "dff101 frozenbn fused7 bf16 onehot native composed", DFF_NET,
        "composed", SEED + 26, launches_of(fused_stem=1, warp_onehot=(K - 2) + 1,
                                           upsample_argmax=1, upsample2x=FLOW_RESIZES),
        overall=0.98)
    torch.cuda.empty_cache()
    quant_launched = e2e_quant()
    torch.cuda.empty_cache()
    fold_launched = e2e_fold()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_export_") as tmp:
        export_b1, export_b4 = e2e_export(Path(tmp))
        torch.cuda.empty_cache()
        export_args = e2e_export_args(Path(tmp))
        torch.cuda.empty_cache()
        export_dff = e2e_export_dff(Path(tmp))
        torch.cuda.empty_cache()
        export_deeplab = e2e_export_deeplab_pallas(Path(tmp))
        torch.cuda.empty_cache()
    noscale_launched = e2e_noscale()
    torch.cuda.empty_cache()
    quant_small_launched = e2e_quant_small()
    torch.cuda.empty_cache()
    e2e_graphs()
    torch.cuda.empty_cache()
    # eval from the cfg files: the flagship's 4 step warps, one tail and a
    # FlowNet pass per clip (groupnorm + conv7, no stem kernel); DFF's one
    # batched one-hot warp, one tail and a FlowNet pass
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        root = Path(tmp)
        data, valid_per_clip = write_eval_tree(root)
        eval_launched = e2e_eval("e2e_eval", "accel18_cityscapes", root, data, valid_per_clip,
                                 launches_of(warp=K - 1, upsample_argmax=1,
                                             upsample2x=FLOW_RESIZES), overall=0.99)
        torch.cuda.empty_cache()
        dff_eval_launched = e2e_eval("e2e_eval_dff", "dff_cityscapes", root, data,
                                     valid_per_clip,
                                     launches_of(warp_onehot=1, upsample_argmax=1,
                                                 upsample2x=FLOW_RESIZES), overall=0.98)
        torch.cuda.empty_cache()
        spatial_launched = e2e_spatial(root, data, valid_per_clip)
        torch.cuda.empty_cache()
    # training from the cfg files, one epoch each. The flagship's clip step
    # (remat): 4 step warps, and the same 4 again when the backward recomputes
    # each checkpointed step. With every dilated conv on the kernel: a R101
    # pass has 4 (3 layer4 conv2 + fc6), a R18 pass 5 (4 layer4 convs + fc6);
    # the key forward (1 R101) and the 5 frame outputs (5 R18) run again under
    # remat, the aux loss (1 R101 + 1 R18) does not: 4 + 25 + 9 = 38 forward,
    # 4 + 25 = 29 recomputed, 38 dx. The pair step: 1 warp. Eval of a
    # checkpoint: the flagship's 4 step warps and 1 tail, the pair cfg's one
    # direct warp and 1 tail. A FlowNet pass with each warp of a step (the
    # clip step's run inside its checkpointed steps) and with each clip of
    # an eval.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        root = Path(tmp)
        data = write_train_tree(root)
        clip_eval = launches_of(warp=K - 1, upsample_argmax=1, upsample2x=FLOW_RESIZES)
        train_launched = e2e_train("e2e_train", "accel18_cityscapes", root, data,
                                   launches_of(warp=2 * (K - 1),
                                               upsample2x=FLOW_RESIZES * 2 * (K - 1)),
                                   clip_eval)
        pair_launched = e2e_train("e2e_train_pair", "accel18_cityscapes_pair", root, data,
                                  launches_of(warp=1, upsample2x=FLOW_RESIZES),
                                  launches_of(warp=1, upsample_argmax=1,
                                              upsample2x=FLOW_RESIZES))
        dilated_launched = e2e_train(
            "e2e_train_dilated", "accel18_cityscapes", root, data,
            launches_of(warp=2 * (K - 1), dilated_conv=38 + 29, dilated_conv_dx=38,
                        upsample2x=FLOW_RESIZES * 2 * (K - 1)), None,
            set_network=("dilated_conv=pallas",))
        bn_launched = e2e_train_bn(root, data)
        torch.cuda.empty_cache()
        dp_launched = e2e_dp(root, data)
        torch.cuda.empty_cache()
        spatial_train = e2e_spatial_train(root, data)
    # each kernel with the launches of one path it serves: (path, launches, groups)
    paths = {name: ("accel18", accel_launched[name], accel_groups)
             for name in ("warp", "upsample_argmax", "fused_stem")}
    paths["warp_onehot"] = ("dff", dff_launched["warp_onehot"], dff_groups)
    paths["dilated_conv"] = ("deeplab101 pallas", deeplab_launched["dilated_conv"], 1)
    paths["upsample2x"] = ("accel18", accel_launched["upsample2x"], accel_groups)
    by_path = {"accel18": accel_launched, "dff": dff_launched,
               "deeplab101 pallas": deeplab_launched, "accel18 push_frame": stream_launched,
               "dff push_frame": dff_stream_launched, "accel18_fast": fast_launched,
               "accel18_os8mixed": os8_launched, "accel18 composed": composed_launched,
               "dff composed": dff_composed_launched, "accel18 cfg eval": eval_launched,
               "dff cfg eval": dff_eval_launched, "accel18 clip train": train_launched,
               "accel18 pair train": pair_launched,
               "accel18 clip train dilated_conv=pallas": dilated_launched,
               "accel18 int8": quant_launched, "accel18_fast fold": fold_launched,
               "accel18 pair train batchnorm pretrained": bn_launched,
               "accel18 exported B=1": export_b1, "accel18 exported B=4": export_b4,
               "accel18 exported, weights as argument": export_args,
               "dff exported": export_dff,
               "deeplab101 pallas exported, frame by frame": export_deeplab,
               "use_scale_field false": noscale_launched,
               "accel18 int8 small GEMMs": quant_small_launched,
               "accel18 clip train, NCCL group of one": dp_launched["e2e_dp_nccl"],
               "accel18 clip train, 2 gloo ranks (per rank)": dp_launched["e2e_dp_train"],
               "accel18 pair train batchnorm, 2 gloo ranks (per rank)":
                   dp_launched["e2e_dp_train_bn"],
               "accel18 cfg eval, 2 gloo ranks (per rank)": dp_launched["e2e_dp_eval"],
               "accel18 incremental, 2 spatial ranks (per rank)":
                   spatial_launched["accel18_incremental"],
               "dff direct, 2 spatial ranks (per rank)": spatial_launched["dff_direct"],
               "deeplab101 pallas frame, 2 spatial ranks (per rank)":
                   spatial_launched["deeplab101_pallas"],
               "accel18 cfg eval, 2 spatial ranks (per rank)": spatial_launched["eval"],
               "accel18 clip train, 2 spatial ranks (per rank)":
                   spatial_train["launches"]["train_bf16"],
               "accel18 clip train dilated_conv=pallas, 2 spatial ranks (per rank)":
                   spatial_train["launches"]["dilated"],
               "accel18 pair train batchnorm, 2 spatial ranks (per rank)":
                   spatial_train["launches"]["bn"],
               "accel18 cfg eval int8, 2 gloo ranks (per rank)": dp_launched["e2e_dp_eval_int8"],
               "accel18 int8 incremental, 2 spatial ranks (per rank)":
                   spatial_launched["int8_incremental"],
               "accel18_fast fold direct, 2 spatial ranks (per rank)":
                   spatial_launched["fold_direct"],
               "accel18 s2d incremental, 2 spatial ranks (per rank)":
                   spatial_launched["s2d_incremental"],
               "accel18 clip train s2d fold_flow_downscale, 2 spatial ranks (per rank)":
                   spatial_train["launches"]["s2d_fold"]}

    keys = ("max_abs_err", "shape", "ms", "device_ms", "host_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms", "library_call")
    emit({"kernels": [
        dict(name=name, route="cuda", source=f"accel_tpu_torch/kernels/{name}.cu",
             replaces=REPLACES[name], path=paths[name][0], launches=paths[name][1],
             launches_per_group=paths[name][1] / paths[name][2],
             launches_by_path={path: n[name] for path, n in by_path.items()},
             launch_floor_device_ms=floor["device_ms"],
             **{k: results[name][k] for k in keys},
             **({} if name not in spatial_train["split"] else dict(
                 spatial_train_launches=spatial_train["split"][name])),
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
