"""Clip inference and the training objectives (counterpart of
``accel_tpu/core/pipeline.py``).

A clip runs group by group: each keyframe group of ``interval`` frames runs
the reference branch once on its keyframe and propagates its output (the
score map for accel, fc6 features for dff) to the other frames by
flow-guided warps. The non-sequential work of a group (FlowNet passes,
score heads, update branch, fusion) runs batched across its frames. The
``deeplab`` family runs every frame as its own keyframe.
Propagation is ``incremental`` (anchor = previous frame), ``direct``
(anchor = keyframe) or ``composed`` (the per-step flow and scale fields
cascaded into one keyframe-to-frame warp per frame). ``scale_cascade``
says what incremental and composed propagation do with the per-step scale
fields: ``product`` multiplies them up, ``mean1``/``clamp`` renormalize or
clamp that product after every step, ``last`` uses only the current
step's field.

Tensors are NCHW with a leading (B, F) or (B, k) pair;
:func:`clip_predictions` keeps the JAX package's call shape at its
boundary: ``(B, F, H, W, 3)`` float in, ``(B, F, H, W)`` uint8 out.
``input_scale`` (a scalar or None) multiplies each frame where it is used,
so ``clip * input_scale`` is never built whole.

Training: :func:`pair_loss_and_stats` (one sampled warp per example) and
:func:`clip_loss_and_stats` (the loss through the cascaded propagation of
a whole clip) run with grad enabled; the clip objective's logits come from
:func:`train_clip_logits`, whose ``remat`` runs the JAX package's
sequential group step with each frame's work under
``torch.utils.checkpoint``. The serving entry points (:func:`clip_logits`,
:func:`clip_predictions`) run under ``torch.inference_mode``.

Under data parallelism (``group``: ``parallel/mesh.py``) the objectives
take this rank's rows of a global batch and return its share of the global
batch's loss: every count they divide by (valid pixels, annotated frames,
OHEM's kept pixels) is reduced over the ranks, and running-stat BatchNorm
normalizes by the global batch's statistics. No collective of the data
axis runs inside ``train_clip_logits``, whose remat would run it again in
the backward.

Under spatial sharding (``parallel/spatial.py``: inside
``spatial_sharding(mesh, model)``) the serving entry points and the
objectives take this rank's rows of every frame and return its rows of the
logits and class maps, or its share of the loss (``group`` is then the
world, which holds every rank's rows); the ops exchange their halos, and
GroupNorm and mean1 sum over the whole frame. Those collectives do run
inside ``train_clip_logits``: remat runs them again in the backward's
recompute, under the shard of the call (``_remat``), and every rank runs
the same graph, so they come in the same order on every rank.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from accel_tpu_torch.core.metrics import IGNORE_LABEL, softmax_cross_entropy
from accel_tpu_torch.models.resnet import BatchNorm
from accel_tpu_torch.ops import quant
from accel_tpu_torch.ops.upsample import resize_bilinear
from accel_tpu_torch.ops.upsample_argmax import upsample_argmax, upsample_argmax_plain
from accel_tpu_torch.ops.warp import bilinear_warp
from accel_tpu_torch.parallel import spatial
from accel_tpu_torch.utils.profiler import spanned

# Max full-resolution frames per batched call inside a group step; B*k
# beyond this runs in equal chunks (the largest divisor of B*k up to this),
# which is exact because every op involved is per-frame.
MAX_FULLRES_FRAMES_PER_DISPATCH = 20

UPSAMPLES = ("bilinear_logits", "bilinear_logits_xla", "nearest_pred")

# scale_cascade='clamp' clips the cumulative scale product to
# [1/_CASCADE_CLAMP, _CASCADE_CLAMP] after every step
_CASCADE_CLAMP = 2.0


def _scaled(x: torch.Tensor, scale) -> torch.Tensor:
    return x if scale is None else x * scale


def _chunked_apply(fn, x: torch.Tensor, scale=None):
    """``fn(x * scale)`` over the leading (frame) axis in chunks of at most
    MAX_FULLRES_FRAMES_PER_DISPATCH frames (the largest divisor of the
    frame count up to it); ``scale`` (None: none) multiplies one chunk at
    a time. ``fn`` returns a tensor or a tuple of
    tensors; chunks are concatenated per element. The chunks are those of
    the JAX package's ``lax.map``, so an int8 branch quantizes each chunk
    with its own activation scales, as there.

    The frame axis is the call's global one: under an int8 scale group
    that places this rank's samples in a global batch (``ops/quant.py``,
    ``ScaleGroup.batch``: a data axis) this rank runs its piece of every
    global chunk, in global order, under the chunk's group, so that the
    chunk's scales are maxed over the ranks that hold it. A rank that holds
    none of a chunk's frames runs a stand-in whose activations count for
    nothing (its first frame; its whole batch where it holds no sample of
    the call, whose output is then the stand-in's), so that every rank
    makes every chunk's all-reduces. A symbolic frame count (a program
    traced with a batch-polymorphic clip) runs unchunked, as the JAX
    package runs it under ``jax.export``: the chunk size needs a concrete
    count."""
    n = x.shape[0]
    if isinstance(n, torch.SymInt):
        return fn(_scaled(x, scale))
    group = quant.active()
    start, size, total = (0, n, n) if group is None or group.batch is None else group.batch
    per = n // max(size, 1)
    lo, hi, frames = start * per, (start + size) * per, total * per
    c = max(d for d in range(1, MAX_FULLRES_FRAMES_PER_DISPATCH + 1) if frames % d == 0)
    outs, stand_in = [], None
    for g in range(0, frames, c):
        a, b = max(lo, g), min(hi, g + c)
        with quant.sharing(None if group is None
                           else group.within(max(a - g, 0), max(b - a, 0), c)):
            if b > a:
                outs.append(fn(_scaled(x[a - lo:b - lo], scale)))
            else:
                stand_in = fn(_scaled(x if size == 0 else x[:1], scale))
    if not outs:
        return stand_in
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs, strict=True))
    return torch.cat(outs)


def _frames(t: torch.Tensor) -> torch.Tensor:
    """(B, k, ...) -> (B*k, ...)."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def _update_fuse_tail(model, frames_g, ref_all, input_scale=None):
    """Per-frame update branch at batch B*k + batched 1x1 fusion (accel),
    or the ref scores as they are (dff, deeplab)."""
    B, k = frames_g.shape[:2]
    if model.family != "accel":
        return ref_all
    upd = _chunked_apply(model.update_scores, _frames(frames_g), input_scale)
    fused = model.fuse(_frames(ref_all), upd)
    return fused.reshape(B, k, *fused.shape[1:])


def _rep_slice(rep, fn):
    """``fn`` on a prologue rep: a tensor, or each tensor of a tuple."""
    return tuple(fn(a) for a in rep) if isinstance(rep, tuple) else fn(rep)


def _group_flow_reps(model, frames_g, input_scale=None):
    """Every frame's FlowNet prologue, once (each frame is both a 'cur'
    and the next step's 'anchor'): the frame downscaled to FlowNet
    resolution, or under ``fold_flow_downscale`` its conv1 partials
    (cur, anchor). (B, k, ...) tensors, a tuple of two for the fold."""
    B, k = frames_g.shape[:2]
    fn = model.flow_stem_partials if model.fold_flow_downscale else model.downscale_for_flow
    rep = _chunked_apply(fn, _frames(frames_g), input_scale)
    return _rep_slice(rep, lambda a: a.reshape(B, k, *a.shape[1:]))


def _flow_from_reps(model, cur_rep, anchor_rep):
    """The FlowNet pass from two frames' prologue reps: the cur frame's
    'cur' partial and the anchor's 'anchor' partial under the fold."""
    if model.fold_flow_downscale:
        return model.flow_pair_from_partials(cur_rep[0], anchor_rep[1])
    return model.flow_pair(cur_rep, anchor_rep)


def _key_pass(model, frames_g, input_scale):
    """The keyframe's propagated tensor and its scores."""
    prop = model.ref_propagated(_scaled(frames_g[:, 0], input_scale))
    return prop, model.ref_scores_from_propagated(prop)


def _with_key(key_scores, ref_nonkey, B, k):
    """The key's scores (B,...) and those of the k-1 warped frames
    (B*(k-1),...) -> (B,k,...)."""
    return torch.cat([key_scores[:, None],
                      ref_nonkey.reshape(B, k - 1, *ref_nonkey.shape[1:])], dim=1)


@spanned("model.warp")
def _warp_field(model, field, flow):
    """Warp a small per-pixel field (a flow or a scale field) by a step
    flow, in f32, through the model's warp dispatch (``use_pallas_warp``,
    ``warp_max_disp``, ``warp_gather``): the composition primitive."""
    return bilinear_warp(field.to(torch.float32), flow, use_pallas=model.use_pallas_warp,
                         max_disp=model.warp_max_disp, gather=model.warp_gather,
                         plain=not model.use_kernels)


def _cascade_post(acc_s, mode):
    """The scale_cascade intervention on a cumulative scale product:
    'mean1' renormalizes each sample to mean 1, 'clamp' clips to
    [1/_CASCADE_CLAMP, _CASCADE_CLAMP]; 'product' and 'last' leave it."""
    if mode == "mean1":
        m = spatial.mean(acc_s, (1, 2, 3), keepdim=True)
        return acc_s / (m.abs() + 1e-6)
    if mode == "clamp":
        return acc_s.clamp(1.0 / _CASCADE_CLAMP, _CASCADE_CLAMP)
    return acc_s


def _compose_fields(model, flow, scale):
    """Cascade per-step fields into per-frame fields that map each frame
    straight to the keyframe.

    ``flow`` (B, k-1, 2, h, w): step i maps frame i+1's pixels to their
    frame-i source. ``scale`` (B, k-1, C, h, w): step i's scale field, not
    normalized. Entry i of the result is ``F_i(p) = f_i(p) + F_{i-1}(p +
    f_i(p))`` and ``S_i(p) = norm(s_i)(p) * S_{i-1}(p + f_i(p))`` (each
    product through ``_cascade_post``), or under 'last' only
    ``norm(s_i)``. Samples outside the frame read 0, as the warp's do."""
    mode = model.scale_cascade
    acc_f = flow[:, 0]
    acc_s = _cascade_post(model.norm_scale(scale[:, 0]), mode)
    comp_f, comp_s = [acc_f], [acc_s]
    for i in range(1, flow.shape[1]):
        step_f = flow[:, i]
        step_s = model.norm_scale(scale[:, i])
        acc_f = step_f + _warp_field(model, acc_f, step_f)
        if mode == "last":
            acc_s = step_s
        else:
            acc_s = _cascade_post(step_s * _warp_field(model, acc_s, step_f), mode)
        comp_f.append(acc_f)
        comp_s.append(acc_s)
    return torch.stack(comp_f, dim=1), torch.stack(comp_s, dim=1)


def _group_step_direct_batched(model, frames_g, input_scale=None):
    """Direct mode: every non-key frame warps from the keyframe, so the
    k-1 flows, warps and score maps run as one call each at batch B*(k-1)."""
    B, k = frames_g.shape[:2]
    prop, key_scores = _key_pass(model, frames_g, input_scale)
    if k == 1:
        ref_all = key_scores[:, None]
    else:
        rep = _group_flow_reps(model, frames_g, input_scale)
        cur_rep = _rep_slice(rep, lambda a: _frames(a[:, 1:]))
        anchor_rep = _rep_slice(rep, lambda a: a[:, 0].repeat_interleave(k - 1, dim=0))
        flow, scale = _flow_from_reps(model, cur_rep, anchor_rep)
        warped = model.warp(prop.repeat_interleave(k - 1, dim=0), flow, scale)
        ref_all = _with_key(key_scores, model.ref_scores_from_propagated(warped), B, k)
    return _update_fuse_tail(model, frames_g, ref_all, input_scale)


def _step_fields(model, frames_g, input_scale):
    """The k-1 consecutive-pair flows and scale fields of a group, from one
    FlowNet call at batch B*(k-1): (B, k-1, 2, h, w) and (B, k-1, C, h, w)."""
    B, k = frames_g.shape[:2]
    rep = _group_flow_reps(model, frames_g, input_scale)
    flow, scale = _flow_from_reps(model, _rep_slice(rep, lambda a: _frames(a[:, 1:])),
                                  _rep_slice(rep, lambda a: _frames(a[:, :-1])))
    return (flow.reshape(B, k - 1, *flow.shape[1:]),
            scale.reshape(B, k - 1, *scale.shape[1:]))


def _group_step_composed_batched(model, frames_g, input_scale=None):
    """Composed mode: the cheap per-step fields (2-channel flow, scale
    field) cascade through the group, and the propagated tensor is warped
    once per frame, from the keyframe, at the composed displacement, under
    a bound of (k-1) x the per-step one. All wide work runs batched as in
    direct mode."""
    B, k = frames_g.shape[:2]
    prop, key_scores = _key_pass(model, frames_g, input_scale)
    if k == 1:
        ref_all = key_scores[:, None]
    else:
        flow, scale = _step_fields(model, frames_g, input_scale)
        cflow, cscale = _compose_fields(model, flow, scale)
        warped = model.warp(prop.repeat_interleave(k - 1, dim=0), _frames(cflow),
                            _frames(cscale), normalize_scale=False,
                            max_disp=int(model.warp_max_disp) * (k - 1))
        ref_all = _with_key(key_scores, model.ref_scores_from_propagated(warped), B, k)
    return _update_fuse_tail(model, frames_g, ref_all, input_scale)


@spanned("model.warp")
def propagate_step(model, carry, prod, flow, scale, cascade: str):
    """One step of the frame-to-frame cascade: ``carry`` warped by
    ``flow``. Returns (the next carry, the next cumulative scale product,
    the tensor to score). 'product' carries the modulated tensor and scores
    it. The other cascades carry the UNMODULATED tensor and modulate only
    the scored copy: by this step's normalized scale field ('last'), or by
    the cumulative product of the fields, warped along and renormalized
    ('mean1') or clamped ('clamp'), which ``prod`` carries (None at the
    first step and under 'product'/'last'). A model without the scale
    field takes the 'product' step, whose warp modulates nothing."""
    if cascade == "product" or not model.use_scale_field:
        warped = model.warp(carry, flow, scale)
        return warped, None, warped
    s = model.norm_scale(scale)
    warped = model.warp(carry, flow, s, normalize_scale=False, modulate=False)
    if cascade == "last":
        eff = s
    else:
        prod = s if prod is None else s * _warp_field(model, prod, flow)
        prod = eff = _cascade_post(prod, cascade)
    return warped, prod, warped * eff.to(warped.dtype)


def _group_step_incremental_batched(model, frames_g, input_scale=None):
    """Incremental mode (frame-to-frame cascade): all k-1 FlowNet passes
    are independent consecutive pairs, batched at B*(k-1); only the warp
    chains through the steps, each one a ``propagate_step`` under the
    model's ``scale_cascade``."""
    B, k = frames_g.shape[:2]
    prop, key_scores = _key_pass(model, frames_g, input_scale)
    if k == 1:
        ref_all = key_scores[:, None]
    else:
        flow, scale = _step_fields(model, frames_g, input_scale)
        carry, prod, warped_steps = prop, None, []
        for i in range(k - 1):
            carry, prod, scored = propagate_step(model, carry, prod, flow[:, i], scale[:, i],
                                                 model.scale_cascade)
            warped_steps.append(scored)
        warped = _frames(torch.stack(warped_steps, dim=1))
        ref_all = _with_key(key_scores, model.ref_scores_from_propagated(warped), B, k)
    return _update_fuse_tail(model, frames_g, ref_all, input_scale)


_GROUP_STEPS = {"incremental": _group_step_incremental_batched,
                "direct": _group_step_direct_batched,
                "composed": _group_step_composed_batched}


def _group_step(model, frames_g, propagate: str, input_scale=None):
    """One keyframe group: frames_g (B,k,3,H,W) -> logits (B,k,C,h,w)."""
    if propagate not in _GROUP_STEPS:
        raise ValueError(f"unknown propagate {propagate!r} {tuple(_GROUP_STEPS)}")
    return _GROUP_STEPS[propagate](model, frames_g, input_scale)


def _remat(fn):
    """``fn`` recomputed in the backward instead of keeping its
    activations (``jax.checkpoint``); the model draws no random numbers, so
    no RNG state is kept for the recompute. Under spatial sharding the
    recompute runs under the shard of the call (``spatial.bound``: on the
    card autograd recomputes in its own thread, which does not see the
    caller's context, and the convs and warps would run on the bare shard)
    and to its end (no early stop), so that every rank runs the same
    exchanges again; so does the int8 convs' scale group (``ops/quant.py``)."""

    def run(*args):
        shard, scales = spatial.active(), quant.active()
        if shard is None and scales is None:
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
        with set_checkpoint_early_stop(False):
            return checkpoint(quant.bound(scales, spatial.bound(shard, fn)), *args,
                              use_reentrant=False, preserve_rng_state=False)

    return run


def _group_step_remat(model, frames_g, propagate: str, input_scale=None):
    """The sequential group step of ``accel_tpu``'s ``_group_step`` under
    ``remat`` (``core/pipeline.py:515-618``): the keyframe forward, each
    propagation step and each frame's output run under
    ``torch.utils.checkpoint``, so a backward keeps one frame's activations
    at a time and runs each forward again. The FlowNet prologue of every
    frame runs once, outside."""
    if propagate not in _GROUP_STEPS:
        raise ValueError(f"unknown propagate {propagate!r} {tuple(_GROUP_STEPS)}")
    k = frames_g.shape[1]
    key_frame = _scaled(frames_g[:, 0], input_scale)
    # direct propagation warps once from the keyframe: no cascade to intervene on
    cascade = model.scale_cascade if propagate != "direct" else "product"

    @_remat
    def key_fwd(frame):
        prop = model.ref_propagated(frame)
        return prop, model.ref_scores_from_propagated(prop)

    @_remat
    def prop_step(carry, prod, cur_rep, anchor_rep):
        flow, scale = _flow_from_reps(model, cur_rep, anchor_rep)
        carry, prod, scored = propagate_step(model, carry, prod, flow, scale, cascade)
        return carry, prod, model.ref_scores_from_propagated(scored)

    @_remat
    def prop_step_composed(prop, acc_f, acc_s, cur_rep, anchor_rep):
        # the composed fields carry; the tensor is warped from the keyframe
        flow, scale = _flow_from_reps(model, cur_rep, anchor_rep)
        scale = model.norm_scale(scale)
        if acc_f is None:
            acc_f, acc_s = flow, _cascade_post(scale, cascade)
        else:
            acc_f = flow + _warp_field(model, acc_f, flow)
            acc_s = (scale if cascade == "last"
                     else _cascade_post(scale * _warp_field(model, acc_s, flow), cascade))
        warped = model.warp(prop, acc_f, acc_s, normalize_scale=False,
                            max_disp=int(model.warp_max_disp) * (k - 1))
        return acc_f, acc_s, model.ref_scores_from_propagated(warped)

    @_remat
    def frame_output(ref_s, frame):
        if model.family == "accel":
            return model.fuse(ref_s, model.update_scores(frame))
        return ref_s

    prop, ref_scores = key_fwd(key_frame)
    outs = [frame_output(ref_scores, key_frame)]
    if k > 1:
        rep = _group_flow_reps(model, frames_g, input_scale)
    carry, prod, acc_f, acc_s, anchor = prop, None, None, None, 0
    for i in range(1, k):
        cur_rep = _rep_slice(rep, lambda a: a[:, i])
        anchor_rep = _rep_slice(rep, lambda a: a[:, anchor])
        if propagate == "composed":
            acc_f, acc_s, ref_s = prop_step_composed(prop, acc_f, acc_s, cur_rep, anchor_rep)
            anchor = i
        else:
            new_carry, new_prod, ref_s = prop_step(carry, prod, cur_rep, anchor_rep)
            if propagate == "incremental":
                carry, prod, anchor = new_carry, new_prod, i
        outs.append(frame_output(ref_s, _scaled(frames_g[:, i], input_scale)))
    return torch.stack(outs, dim=1)


def _check_groups(model, clip: torch.Tensor, interval: int) -> int:
    F = clip.shape[1]
    k = 1 if model.family == "deeplab" else int(interval)
    if F % k != 0:
        raise ValueError(f"clip length {F} not divisible by interval {k}")
    return k


def train_clip_logits(model, clip: torch.Tensor, interval: int,
                      propagate: str = "incremental", remat: bool = False,
                      input_scale=None) -> torch.Tensor:
    """clip (B,F,3,H,W) normalized, F % interval == 0 -> stride-level
    logits (B,F,C,h,w) f32, one keyframe group after another, under the
    caller's grad mode: the logits of the clip objective (``accel_tpu``'s
    ``clip_logits`` with ``remat``). The ``deeplab`` family takes interval 1
    (every frame is a keyframe). ``input_scale`` (scalar or None)
    multiplies every frame where it is used. Without ``remat`` the batched
    group steps run; with it the sequential step of ``_group_step_remat``,
    which gives the same logits and gradients with one frame's activations
    kept at a time."""
    k = _check_groups(model, clip, interval)
    spatial.check_rows(clip.shape[-2], model.row_stride, f"the {model.family} model")
    step = _group_step_remat if remat else _group_step
    return torch.cat([step(model, clip[:, g:g + k], propagate, input_scale)
                      for g in range(0, clip.shape[1], k)], dim=1)


@torch.inference_mode()
def clip_logits(model, clip: torch.Tensor, interval: int, propagate: str = "incremental",
                input_scale=None) -> torch.Tensor:
    """``train_clip_logits`` without remat, for serving (inference mode)."""
    return train_clip_logits(model, clip, interval, propagate, input_scale=input_scale)


@torch.inference_mode()
def clip_predictions(model, clip: torch.Tensor, interval: int, propagate: str = "incremental",
                     full_res: bool = True, upsample: str = "bilinear_logits",
                     input_scale=None) -> torch.Tensor:
    """clip (B,F,H,W,3) float -> per-frame argmax class maps, uint8:
    (B,F,H,W) with ``full_res``, else (B,F,h,w) at feature stride.

    ``upsample``: 'bilinear_logits' (the reference eval protocol: bilinear
    upsample of the logits, then argmax, fused in one kernel on CUDA),
    'bilinear_logits_xla' (the same, materialized, one frame at a time)
    or 'nearest_pred' (argmax at stride, each class repeated over its
    H/h x W/w block)."""
    return clip_predictions_body(model, clip, interval, propagate, full_res, upsample,
                                 input_scale)


def clip_predictions_body(model, clip: torch.Tensor, interval: int,
                          propagate: str = "incremental", full_res: bool = True,
                          upsample: str = "bilinear_logits", input_scale=None) -> torch.Tensor:
    """``clip_predictions`` under the caller's grad mode: the program
    ``core/export.py`` traces (``torch.export`` does not trace into
    ``torch.inference_mode``)."""
    if upsample not in UPSAMPLES:
        raise ValueError(f"unknown upsample {upsample!r} {UPSAMPLES}")
    logits = train_clip_logits(model, clip.permute(0, 1, 4, 2, 3).contiguous(), interval,
                               propagate, input_scale=input_scale)
    return _class_maps(model, logits, tuple(clip.shape[2:4]), full_res, upsample)


@spanned("model.tail")
def _class_maps(model, logits: torch.Tensor, frame_hw, full_res: bool, upsample: str):
    """(B,F,C,h,w) logits -> the class maps ``clip_predictions`` returns."""
    B, F = logits.shape[:2]
    H, W = frame_hw
    if not full_res or upsample == "nearest_pred":
        pred = logits.argmax(dim=2).to(torch.uint8)
        if not full_res:
            return pred
        h, w = pred.shape[-2:]
        return pred.repeat_interleave(H // h, dim=2).repeat_interleave(W // w, dim=3)
    if upsample == "bilinear_logits":
        pred = upsample_argmax(_frames(logits), (H, W), plain=not model.use_kernels)
        return pred.reshape(B, F, H, W)
    return torch.stack([upsample_argmax_plain(logits[:, f], (H, W)) for f in range(F)], dim=1)


# ---- training objectives ---------------------------------------------------------


def _ce(logits, label, num_classes, loss_scale, ohem_fraction, group=None):
    """Softmax CE of stride-level logits upsampled to the label's size."""
    return softmax_cross_entropy(resize_bilinear(logits, tuple(label.shape[-2:])), label,
                                 num_classes, loss_scale, ohem_fraction, group)


@contextlib.contextmanager
def _global_batch_stats(norms, group):
    """Each BatchNorm in ``norms`` takes its batch statistics over the
    ranks of ``group`` for the duration."""
    for m in norms:
        m.group = group
    try:
        yield
    finally:
        for m in norms:
            m.group = None


def pair_loss_and_stats(model, batch: dict, num_classes: int, loss_scale: float = 1.0,
                        mutable_stats: bool = False, ohem_fraction: float | None = None,
                        aux_weight: float = 0.0, group=None):
    """Cross entropy of a (key, cur) pair batch -> (loss, None).

    ``batch``: 'data' and 'data_ref' (N,3,H,W), 'eq_flag' (N,), 'label'
    (N,H,W) with 255 ignored. The logits are upsampled to the label before
    the CE, as the reference computes it. ``aux_weight`` > 0 adds the CE
    of the raw reference-branch scores on the current frame and (accel) of
    the update branch's.

    ``mutable_stats`` (running-stat BatchNorm, ``norm: batchnorm``): the
    pair forward normalizes by batch statistics (the model in ``train()``
    mode, flax's ``train=True``), the auxiliary passes by the running
    statistics the step started from (flax applies them without
    ``train``), and then every BatchNorm folds its batch statistics into
    its running statistics; returns (loss, {state_dict key: running
    statistic}). Without it a BatchNorm model raises, as flax refuses to
    update ``batch_stats`` that are not mutable.

    ``group``: this rank's share of the global batch's loss (module
    docstring); the batch statistics are the global batch's."""
    norms = [m for m in model.modules() if isinstance(m, BatchNorm)]
    if norms and not mutable_stats:
        raise ValueError("a running-stat BatchNorm model needs mutable_stats=True")
    label = batch["label"]
    spatial.check_rows(label.shape[-2], model.row_stride, f"the {model.family} model")
    model.train(mutable_stats)
    try:
        with _global_batch_stats(norms, group):
            logits = model(batch["data"], batch["data_ref"], batch["eq_flag"])
    finally:
        model.eval()
    loss = _ce(logits, label, num_classes, loss_scale, ohem_fraction, group)
    if aux_weight > 0.0 and model.family in ("dff", "accel"):
        ref = model.ref_scores_from_propagated(model.ref_propagated(batch["data"]))
        loss = loss + aux_weight * _ce(ref, label, num_classes, loss_scale, ohem_fraction, group)
        if model.family == "accel":
            upd = model.update_scores(batch["data"])
            loss = loss + aux_weight * _ce(upd, label, num_classes, loss_scale, ohem_fraction,
                                           group)
    if not mutable_stats:
        return loss, None
    for m in norms:
        m.commit()
    return loss, running_stats(model)


def running_stats(model) -> dict[str, torch.Tensor]:
    """Every BatchNorm's running statistics by ``state_dict`` key (flax's
    ``batch_stats`` collection)."""
    return {f"{name}.{stat}": getattr(m, stat) for name, m in model.named_modules()
            if isinstance(m, BatchNorm) for stat in ("running_mean", "running_var")}


def clip_loss_and_stats(model, batch: dict, num_classes: int, loss_scale: float = 1.0,
                        propagate: str = "incremental", mutable_stats: bool = False,
                        ohem_fraction: float | None = None, aux_weight: float = 0.0,
                        remat: bool = False, group=None):
    """The clip objective -> (loss, None): CE through the cascaded
    propagation of the whole clip, so the annotated frame's gradient flows
    back through every warp, flow and scale field of the chain.

    ``batch``: 'clip' (B,F,3,H,W), 'label' (B,F,H,W) with 255 on every
    pixel of an unannotated frame; the clip is one keyframe group. Each
    frame's logits are upsampled and scored on their own (a mean over the
    frame's valid pixels across the batch); the sum is divided by the
    number of annotated frames. ``aux_weight`` > 0 adds the CE of the raw
    branch outputs on each clip's annotated frame alone (the loader
    annotates one frame a clip). Running-stat BatchNorm raises, as in the
    reference. ``group``: this rank's share of the global batch's loss
    (module docstring); a frame is annotated where any rank has a valid
    pixel of it, and each clip's aux frame is picked by its valid pixels
    over the whole frame."""
    if mutable_stats:
        raise NotImplementedError("clip objective + running-stat BN: use frozenbn/groupnorm")
    clip, label = batch["clip"], batch["label"]
    B, F = clip.shape[:2]
    logits = train_clip_logits(model, clip, F, propagate, remat)
    per_frame = torch.stack([_ce(logits[:, f], label[:, f], num_classes, loss_scale,
                                 ohem_fraction, group) for f in range(F)])
    valid = (label != IGNORE_LABEL) & (label < num_classes)
    annotated = valid.flatten(2).any(dim=2).any(dim=0)
    if group is not None:
        annotated = annotated.to(torch.int32)
        dist.all_reduce(annotated, op=dist.ReduceOp.MAX, group=group)
    loss = per_frame.sum() / annotated.sum().clamp(min=1)
    if aux_weight > 0.0:
        # the frame with the most valid pixels, the first such, per clip;
        # under spatial sharding the counts of the whole frame
        (n_valid,) = spatial.row_sum(valid.sum(dim=(2, 3)))
        ann_idx = n_valid.argmax(dim=1)
        rows = torch.arange(B, device=ann_idx.device)
        ann_frames, ann_label = clip[rows, ann_idx], label[rows, ann_idx]
        ref = model.ref_scores_from_propagated(model.ref_propagated(ann_frames))
        loss = loss + aux_weight * _ce(ref, ann_label, num_classes, loss_scale, ohem_fraction,
                                       group)
        if model.family == "accel":
            upd = model.update_scores(ann_frames)
            loss = loss + aux_weight * _ce(upd, ann_label, num_classes, loss_scale,
                                           ohem_fraction, group)
    return loss, None
