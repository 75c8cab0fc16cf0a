"""Model summary and shape inference (counterpart of
``accel_tpu/utils/summary.py``; the reference's ``lib/utils/symbol.py``
infer-shape debugging).

``param_count`` and ``param_summary`` count a model's parameters, as the
JAX package counts flax's ``params`` collection: the running statistics of
a norm are buffers here, as ``batch_stats`` are there, and are not counted.
``infer_shapes`` runs a function on fake tensors: shapes and dtypes without
computing.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import torch
from torch import nn
from torch.utils._pytree import tree_map_only

# the buffers a state dict holds beside the parameters (flax's batch_stats)
_BUFFERS = ("running_mean", "running_var")


class ShapeDtype(NamedTuple):
    """A tensor's shape and dtype (``jax.ShapeDtypeStruct``)."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def _params(model_or_state) -> list[tuple[str, torch.Tensor]]:
    if isinstance(model_or_state, nn.Module):
        return list(model_or_state.named_parameters())
    if isinstance(model_or_state, Mapping):
        return [(k, v) for k, v in model_or_state.items() if k.rsplit(".", 1)[-1] not in _BUFFERS]
    raise TypeError(f"expected an nn.Module or a state dict, got {type(model_or_state)}")


def param_count(model_or_state) -> int:
    """The number of parameter values of a module or a state dict (running
    statistics excluded)."""
    return sum(p.numel() for _, p in _params(model_or_state))


def param_summary(model_or_state, max_rows: int = 0) -> str:
    """One line per parameter: name, shape, dtype, count; at most
    ``max_rows`` of them (0: all) and then a ``TOTAL`` row."""
    params = _params(model_or_state)
    rows = [f"{name:70s} {str(tuple(p.shape)):20s} {str(p.dtype).removeprefix('torch.'):10s} "
            f"{p.numel():>12,}" for name, p in params]
    if max_rows and len(rows) > max_rows:
        rows = rows[:max_rows] + [f"... ({len(params) - max_rows} more)"]
    total = sum(p.numel() for _, p in params)
    rows.append(f"{'TOTAL':70s} {'':20s} {'':10s} {total:>12,}")
    return "\n".join(rows)


def infer_shapes(fn, *example_args):
    """The shapes and dtypes of ``fn(*example_args)`` without computing it:
    ``fn`` runs under a ``FakeTensorMode`` (tensors with metadata and no
    data; a module's real parameters are faked as they are met). Returns
    the output with every tensor replaced by its ``ShapeDtype``. The port's
    CUDA kernels do not run on fake tensors: shape a model on the CPU."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        args = tree_map_only(torch.Tensor, mode.from_tensor, example_args)
        with torch.no_grad():
            out = fn(*args)
    return tree_map_only(torch.Tensor, lambda t: ShapeDtype(tuple(t.shape), t.dtype), out)
