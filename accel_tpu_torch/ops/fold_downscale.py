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
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from accel_tpu_torch.ops.upsample import _down_taps


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
    offs, _ = _down_taps(f)
    p_lo, p_hi = int(-offs[0]), int(offs[-1] - (f - 1))
    lo, hi = f * padding + p_lo, f * padding + p_hi
    w = composed_weight(weight, f)
    if lo == hi:
        return F.conv2d(x, w, stride=f * stride, padding=lo)
    return F.conv2d(F.pad(x, (lo, hi, lo, hi)), w, stride=f * stride)
