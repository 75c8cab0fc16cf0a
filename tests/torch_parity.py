"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

Variables for a flax module are made from its abstract init (``eval_shape``:
the tree and shapes without running the initializers) and filled from a
numpy seed, so every norm, bias and head is non-trivial and both packages
get the same numbers.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

# flow head gain: makes the predicted flow move content by a few feature
# pixels at the tiny test sizes (asserted by the pipeline tests)
FLOW_HEAD_GAIN = 200.0


def _leaf_value(path: tuple[str, ...], shape, rng: np.random.Generator) -> np.ndarray:
    name = path[-1]
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        a = rng.standard_normal(shape) / np.sqrt(fan_in)
        if path[-2] == "predict_flow2":
            a *= FLOW_HEAD_GAIN
        return a
    if name == "bias":
        b = 0.05 * rng.standard_normal(shape)
        return b + 1.0 if path[-2] == "scale_field" else b
    if name in ("scale", "var"):
        return rng.uniform(0.5, 1.5, shape)
    if name == "mean":
        return 0.1 * rng.standard_normal(shape)
    raise KeyError(f"no test value for leaf {'/'.join(path)}")


def seeded_variables(module, *init_args, seed: int = 0, **init_kwargs) -> dict:
    """Variables of ``module.init(key, *init_args, **init_kwargs)`` with
    every leaf drawn from ``np.random.default_rng(seed)`` (f32 numpy)."""
    abstract = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *init_args, **init_kwargs))
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(abstract)
    leaves = []
    for keypath, leaf in flat:
        path = tuple(k.key for k in keypath)
        leaves.append(np.asarray(_leaf_value(path, leaf.shape, rng), np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def nchw(a) -> torch.Tensor:
    """NHWC array -> NCHW f32 torch tensor (any leading dims before H)."""
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.movedim(-1, -3).contiguous()


def nhwc(t: torch.Tensor) -> np.ndarray:
    """NCHW torch tensor -> NHWC numpy."""
    return t.detach().movedim(-3, -1).cpu().numpy()


def assert_close(ours: np.ndarray, ref: np.ndarray, rel: float = 1e-4) -> None:
    """max|ours - ref| <= rel * (1 + max|ref|)."""
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    bound = rel * (1.0 + float(np.abs(ref).max()))
    assert err <= bound, f"max|diff| {err:.3g} > {bound:.3g}"


def assert_argmax_agrees(ours: np.ndarray, ref: np.ndarray, logits: np.ndarray,
                         min_agree: float, margin_rel: float = 1e-5) -> None:
    """Class maps agree on at least ``min_agree`` of the pixels, and every
    disagreement sits at a near-tie: top-2 margin of ``logits`` (the
    reference's channels-last full-res logits) <= margin_rel * max|logits|."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    diff = ours != ref
    agree = 1.0 - float(diff.mean())
    assert agree >= min_agree, f"agreement {agree}"
    if diff.any():
        top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
        margin = (top2[..., 1] - top2[..., 0])[diff]
        assert float(margin.max()) <= margin_rel * float(np.abs(logits).max())
