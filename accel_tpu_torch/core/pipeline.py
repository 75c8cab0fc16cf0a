"""Clip inference (counterpart of the inference half of
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
"""

from __future__ import annotations

import torch

from accel_tpu_torch.ops.upsample_argmax import upsample_argmax, upsample_argmax_plain
from accel_tpu_torch.ops.warp import bilinear_warp

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


def _chunked_apply(fn, x: torch.Tensor, scale=None) -> torch.Tensor:
    """``fn(x * scale)`` over the leading (frame) axis in chunks of at most
    MAX_FULLRES_FRAMES_PER_DISPATCH frames; ``scale`` (None: none)
    multiplies one chunk at a time."""
    n = x.shape[0]
    limit = MAX_FULLRES_FRAMES_PER_DISPATCH
    if n <= limit:
        return fn(_scaled(x, scale))
    c = max(d for d in range(1, limit + 1) if n % d == 0)
    return torch.cat([fn(_scaled(x[i:i + c], scale)) for i in range(0, n, c)])


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


def _group_flow_reps(model, frames_g, input_scale=None):
    """Every frame of the group downscaled to FlowNet resolution once
    (each frame is both a 'cur' and the next step's 'anchor')."""
    B, k = frames_g.shape[:2]
    rep = _chunked_apply(model.downscale_for_flow, _frames(frames_g), input_scale)
    return rep.reshape(B, k, *rep.shape[1:])


def _key_pass(model, frames_g, input_scale):
    """The keyframe's propagated tensor and its scores."""
    prop = model.ref_propagated(_scaled(frames_g[:, 0], input_scale))
    return prop, model.ref_scores_from_propagated(prop)


def _with_key(key_scores, ref_nonkey, B, k):
    """The key's scores (B,...) and those of the k-1 warped frames
    (B*(k-1),...) -> (B,k,...)."""
    return torch.cat([key_scores[:, None],
                      ref_nonkey.reshape(B, k - 1, *ref_nonkey.shape[1:])], dim=1)


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
        m = acc_s.mean(dim=(1, 2, 3), keepdim=True)
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
        cur_rep = _frames(rep[:, 1:])
        anchor_rep = rep[:, 0].repeat_interleave(k - 1, dim=0)
        flow, scale = model.flow_pair(cur_rep, anchor_rep)
        warped = model.warp(prop.repeat_interleave(k - 1, dim=0), flow, scale)
        ref_all = _with_key(key_scores, model.ref_scores_from_propagated(warped), B, k)
    return _update_fuse_tail(model, frames_g, ref_all, input_scale)


def _step_fields(model, frames_g, input_scale):
    """The k-1 consecutive-pair flows and scale fields of a group, from one
    FlowNet call at batch B*(k-1): (B, k-1, 2, h, w) and (B, k-1, C, h, w)."""
    B, k = frames_g.shape[:2]
    rep = _group_flow_reps(model, frames_g, input_scale)
    flow, scale = model.flow_pair(_frames(rep[:, 1:]), _frames(rep[:, :-1]))
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


def _group_step_incremental_batched(model, frames_g, input_scale=None):
    """Incremental mode (frame-to-frame cascade): all k-1 FlowNet passes
    are independent consecutive pairs, batched at B*(k-1); only the warp
    chains through the steps.

    ``scale_cascade='product'`` carries the modulated tensor (each step's
    scale field multiplies in). The others carry the UNMODULATED tensor and
    modulate only the scored copy: by the current step's scale field
    ('last'), or by the cumulative product of the steps' fields, warped
    along and renormalized ('mean1') or clamped ('clamp') after every
    step."""
    B, k = frames_g.shape[:2]
    prop, key_scores = _key_pass(model, frames_g, input_scale)
    if k == 1:
        ref_all = key_scores[:, None]
    else:
        flow, scale = _step_fields(model, frames_g, input_scale)
        mode = model.scale_cascade
        carry, prod, warped_steps = prop, None, []
        for i in range(k - 1):
            if mode == "product":
                carry = model.warp(carry, flow[:, i], scale[:, i])
                warped_steps.append(carry)
                continue
            s = model.norm_scale(scale[:, i])
            carry = model.warp(carry, flow[:, i], s, normalize_scale=False, modulate=False)
            if mode == "last":
                eff = s
            else:
                prod = s if prod is None else s * _warp_field(model, prod, flow[:, i])
                prod = eff = _cascade_post(prod, mode)
            warped_steps.append(carry * eff.to(carry.dtype))
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


@torch.inference_mode()
def clip_logits(model, clip: torch.Tensor, interval: int, propagate: str = "incremental",
                input_scale=None) -> torch.Tensor:
    """clip (B,F,3,H,W) normalized, F % interval == 0 -> stride-level
    logits (B,F,C,h,w) f32, one keyframe group after another. The
    ``deeplab`` family takes interval 1 (every frame is a keyframe).
    ``input_scale`` (scalar or None) multiplies every frame where it is
    used."""
    F = clip.shape[1]
    k = 1 if model.family == "deeplab" else int(interval)
    if F % k != 0:
        raise ValueError(f"clip length {F} not divisible by interval {k}")
    return torch.cat([_group_step(model, clip[:, g:g + k], propagate, input_scale)
                      for g in range(0, F, k)], dim=1)


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
    if upsample not in UPSAMPLES:
        raise ValueError(f"unknown upsample {upsample!r} {UPSAMPLES}")
    B, F, H, W, _ = clip.shape
    logits = clip_logits(model, clip.permute(0, 1, 4, 2, 3).contiguous(), interval, propagate,
                         input_scale)
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
