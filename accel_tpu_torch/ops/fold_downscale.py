"""A factor-f bilinear downscale folded into the first conv that reads it
(counterpart of ``accel_tpu/ops/fold_downscale.py``).

Downscale-then-conv is a composition of two linear maps, so it is one
strided conv on the full-resolution input whose kernel is the conv's
kernel dilated by f and convolved with the triangle taps of the downscale
(``ops/upsample.py::_down_taps``):

    y[o] = sum_k w[k] d(x)[s*o + k - q],   d(x)[i] = sum_j t[j] x[f*i + j - p]
         = sum_m W'[m] x[f*s*o + m - (f*q + p)],   W'[m] = sum_k w[k] t[m - f*k]

stride ``f*s``, ``f*(S-1) + T`` taps, padding ``f*q + p``. The composed
kernel is built from the live weight at every call (a product with a
constant tap matrix), so it stays differentiable and the parameters are
those of the plain conv.

The folded conv equals downscale + conv on every output whose window
stays inside the downscaled image. On the ring of outputs whose window
leaves it, it does not: the resize renormalizes its edge rows, and the
two-stage conv's zero padding drops whole phantom rows that the folded
taps still partly read. This ring is the JAX fold's too, so the port is
held against the JAX fold, not against the resize path.

The composed kernel is large for a 3-channel conv: 16x16 at stride 4 for
a 7x7/2 stem at f=2, 32x32 at stride 8 at f=4. It runs through
``F.conv2d`` (cuDNN on the card), as the JAX hook runs it through XLA's
conv; no Pallas kernel stands behind it.

Under spatial sharding the padded conv runs on one extended shard
(``spatial.halo_apply``): output row o reads input rows ``f*s*o - lo`` to
``f*s*o - lo + S' - 1``, so a shard needs ``lo`` rows above it and
``S' - lo - f*s`` below the ``f*s`` rows of its last output row.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from accel_tpu_torch.ops.upsample import _down_taps
from accel_tpu_torch.parallel import spatial


@functools.lru_cache(maxsize=None)
def _compose_matrix(f: int, S: int) -> np.ndarray:
    """(S', S) matrix M with M[m, k] = t[m - f*k], S' = f*(S-1) + T: the
    factor-``f`` downscale composed with an ``S``-tap conv along one axis,
    W'[m] = sum_k M[m, k] w[k]."""
    _, t = _down_taps(f)
    T = len(t)
    M = np.zeros((f * (S - 1) + T, S), np.float32)
    for k in range(S):
        M[f * k:f * k + T, k] = t
    return M


def composed_weight(weight: torch.Tensor, f: int) -> torch.Tensor:
    """(O, I, S_h, S_w) -> the composed (O, I, S_h', S_w') kernel, summed
    in f32 and rounded once to the weight's dtype (as the JAX hook does
    with its kernel in the compute dtype)."""
    mh = torch.from_numpy(_compose_matrix(f, weight.shape[2])).to(weight.device)
    mw = torch.from_numpy(_compose_matrix(f, weight.shape[3])).to(weight.device)
    return torch.einsum("mk,nl,oikl->oimn", mh, mw, weight.float()).to(weight.dtype)


def fold_downscale_conv(x: torch.Tensor, weight: torch.Tensor, f: int, stride: int,
                        padding: int) -> torch.Tensor:
    """``F.conv2d(downscale_f(x), weight, stride=stride, padding=padding)``
    as one conv on the full-resolution NCHW ``x`` (no bias; ring semantics
    above). ``weight`` is in x's dtype."""
    lo, hi = fold_padding(f, padding)
    w = composed_weight(weight, f)
    step = f * stride

    def conv(t):
        if lo == hi:
            return F.conv2d(t, w, stride=step, padding=lo)
        return F.conv2d(F.pad(t, (lo, hi, lo, hi)), w, stride=step)

    return spatial.halo_apply(conv, x, *fold_halo(f, weight.shape[2], stride, padding),
                              stride=step)


def fold_padding(f: int, padding: int) -> tuple[int, int]:
    """(lo, hi): the folded conv's padding before and after, ``f*padding``
    plus the downscale taps' reach on either side."""
    offs, _ = _down_taps(f)
    return f * padding + int(-offs[0]), f * padding + int(offs[-1] - (f - 1))


def fold_halo(f: int, taps: int, stride: int, padding: int) -> tuple[int, int]:
    """(top, bottom) input rows the folded conv of a ``taps``-row kernel
    reads beyond a shard (module docstring)."""
    lo, _ = fold_padding(f, padding)
    folded = _compose_matrix(f, taps).shape[0]
    return lo, max(folded - lo - f * stride, 0)
