"""Clip inference (counterpart of the inference half of
``accel_tpu/core/pipeline.py``).

A clip runs group by group: each keyframe group of ``interval`` frames runs
the reference branch once on its keyframe and propagates its output (the
score map for accel, fc6 features for dff) to the other frames by
flow-guided warps. The non-sequential work of a group (FlowNet passes,
score heads, update branch, fusion) runs batched across its frames. The
``deeplab`` family runs every frame as its own keyframe.
Propagation is ``incremental`` (anchor = previous frame; ``scale_cascade``
``last`` or ``product``) or ``direct`` (anchor = keyframe).

Tensors are NCHW with a leading (B, F) or (B, k) pair;
:func:`clip_predictions` keeps the JAX package's call shape at its
boundary: ``(B, F, H, W, 3)`` float in, ``(B, F, H, W)`` uint8 out.
"""

from __future__ import annotations

import torch

from accel_tpu_torch.ops.upsample_argmax import upsample_argmax

# Max full-resolution frames per batched call inside a group step; B*k
# beyond this runs in equal chunks (the largest divisor of B*k up to this),
# which is exact because every op involved is per-frame.
MAX_FULLRES_FRAMES_PER_DISPATCH = 20


def _chunked_apply(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` over the leading (frame) axis in chunks of at most
    MAX_FULLRES_FRAMES_PER_DISPATCH frames."""
    n = x.shape[0]
    limit = MAX_FULLRES_FRAMES_PER_DISPATCH
    if n <= limit:
        return fn(x)
    c = max(d for d in range(1, limit + 1) if n % d == 0)
    return torch.cat([fn(x[i:i + c]) for i in range(0, n, c)])


def _frames(t: torch.Tensor) -> torch.Tensor:
    """(B, k, ...) -> (B*k, ...)."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:])


def _update_fuse_tail(model, frames_g, ref_all):
    """Per-frame update branch at batch B*k + batched 1x1 fusion (accel),
    or the ref scores as they are (dff, deeplab)."""
    B, k = frames_g.shape[:2]
    if model.family != "accel":
        return ref_all
    upd = _chunked_apply(model.update_scores, _frames(frames_g))
    fused = model.fuse(_frames(ref_all), upd)
    return fused.reshape(B, k, *fused.shape[1:])


def _group_flow_reps(model, frames_g):
    """Every frame of the group downscaled to FlowNet resolution once
    (each frame is both a 'cur' and the next step's 'anchor')."""
    B, k = frames_g.shape[:2]
    rep = _chunked_apply(model.downscale_for_flow, _frames(frames_g))
    return rep.reshape(B, k, *rep.shape[1:])


def _group_step_direct_batched(model, frames_g):
    """Direct mode: every non-key frame warps from the keyframe, so the
    k-1 flows, warps and score maps run as one call each at batch B*(k-1)."""
    B, k = frames_g.shape[:2]
    prop = model.ref_propagated(frames_g[:, 0])
    key_scores = model.ref_scores_from_propagated(prop)
    if k == 1:
        ref_all = key_scores[:, None]
    else:
        rep = _group_flow_reps(model, frames_g)
        cur_rep = _frames(rep[:, 1:])
        anchor_rep = rep[:, 0].repeat_interleave(k - 1, dim=0)
        flow, scale = model.flow_pair(cur_rep, anchor_rep)
        warped = model.warp(prop.repeat_interleave(k - 1, dim=0), flow, scale)
        ref_nonkey = model.ref_scores_from_propagated(warped)
        ref_all = torch.cat([key_scores[:, None],
                             ref_nonkey.reshape(B, k - 1, *ref_nonkey.shape[1:])], dim=1)
    return _update_fuse_tail(model, frames_g, ref_all)


def _group_step_incremental_batched(model, frames_g):
    """Incremental mode (frame-to-frame cascade): all k-1 FlowNet passes
    are independent consecutive pairs, batched at B*(k-1); only the warp
    chains through the steps.

    ``scale_cascade='product'`` carries the modulated tensor (each step's
    scale field multiplies in). ``'last'`` carries the UNMODULATED tensor
    and modulates only the scored copy by the current step's scale field."""
    B, k = frames_g.shape[:2]
    prop = model.ref_propagated(frames_g[:, 0])
    key_scores = model.ref_scores_from_propagated(prop)
    if k == 1:
        ref_all = key_scores[:, None]
    else:
        rep = _group_flow_reps(model, frames_g)
        flow, scale = model.flow_pair(_frames(rep[:, 1:]), _frames(rep[:, :-1]))
        flow = flow.reshape(B, k - 1, *flow.shape[1:])
        scale = scale.reshape(B, k - 1, *scale.shape[1:])
        mode = model.scale_cascade
        carry, warped_steps = prop, []
        if mode == "product":
            for i in range(k - 1):
                carry = model.warp(carry, flow[:, i], scale[:, i])
                warped_steps.append(carry)
        elif mode == "last":
            for i in range(k - 1):
                s = model.norm_scale(scale[:, i])
                carry = model.warp(carry, flow[:, i], s, normalize_scale=False,
                                   modulate=False)
                warped_steps.append(carry * s.to(carry.dtype))
        else:
            raise NotImplementedError(f"scale_cascade={mode!r} is not ported yet "
                                      "(supported: 'last', 'product')")
        warped = _frames(torch.stack(warped_steps, dim=1))
        ref_nonkey = model.ref_scores_from_propagated(warped)
        ref_all = torch.cat([key_scores[:, None],
                             ref_nonkey.reshape(B, k - 1, *ref_nonkey.shape[1:])], dim=1)
    return _update_fuse_tail(model, frames_g, ref_all)


def _group_step(model, frames_g, propagate: str):
    """One keyframe group: frames_g (B,k,3,H,W) -> logits (B,k,C,h,w)."""
    if propagate == "direct":
        return _group_step_direct_batched(model, frames_g)
    if propagate == "incremental":
        return _group_step_incremental_batched(model, frames_g)
    raise NotImplementedError(f"propagate={propagate!r} is not ported yet "
                              "(supported: 'incremental', 'direct')")


@torch.inference_mode()
def clip_logits(model, clip: torch.Tensor, interval: int,
                propagate: str = "incremental") -> torch.Tensor:
    """clip (B,F,3,H,W) normalized, F % interval == 0 -> stride-level
    logits (B,F,C,h,w) f32, one keyframe group after another. The
    ``deeplab`` family takes interval 1 (every frame is a keyframe)."""
    F = clip.shape[1]
    k = 1 if model.family == "deeplab" else int(interval)
    if F % k != 0:
        raise ValueError(f"clip length {F} not divisible by interval {k}")
    return torch.cat([_group_step(model, clip[:, g:g + k], propagate)
                      for g in range(0, F, k)], dim=1)


@torch.inference_mode()
def clip_predictions(model, clip: torch.Tensor, interval: int,
                     propagate: str = "incremental", full_res: bool = True) -> torch.Tensor:
    """clip (B,F,H,W,3) float -> per-frame argmax class maps, uint8:
    (B,F,H,W) with ``full_res`` (bilinear upsample of the logits, then
    argmax, fused in one kernel on CUDA), else (B,F,h,w) at feature stride."""
    B, F, H, W, _ = clip.shape
    logits = clip_logits(model, clip.permute(0, 1, 4, 2, 3).contiguous(), interval,
                         propagate)
    if not full_res:
        return logits.argmax(dim=2).to(torch.uint8)
    pred = upsample_argmax(_frames(logits), (H, W), plain=not model.use_kernels)
    return pred.reshape(B, F, H, W)
