"""Weight bridge: flax variables of ``accel_tpu``'s ``AccelNet`` -> the
port's ``state_dict``.

The port names its modules as the flax tree does, so a leaf's path maps
one to one onto a torch key; only the leaf names and layouts change:

- ``params/.../kernel`` (conv, HWIO) -> ``....weight`` (OIHW);
- ``params/.../bias`` -> ``....bias``;
- ``params/.../scale`` (FrozenBN, BatchNorm or GroupNorm) -> ``....weight``;
- ``batch_stats/.../mean`` and ``var`` (FrozenBN, or flax ``nn.BatchNorm``'s
  running statistics) -> ``....running_mean`` and ``....running_var``.

The fused7 stem keeps the conv7 tree (``backbone/conv1/kernel`` and
``backbone/bn``), FlowNet's ``conv1`` is a (7,7,6,64) conv with a bias, and
the s2d stem's ``backbone/conv1_s2d/kernel`` (4,4,12,64) becomes
``backbone.conv1_s2d.weight`` (64,12,4,4): the port's ``space_to_depth``
orders its 12 channels as the JAX one does (``(dy*2 + dx)*3 + c``), so its
input channels need no permutation. None of them needs anything special.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flatten(tree: Mapping, prefix: tuple = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def flax_to_torch(variables: Mapping) -> dict[str, torch.Tensor]:
    """Nested dict of arrays (``model.init`` / ``load_params`` output) ->
    ``state_dict`` of f32 CPU tensors. Raises ``KeyError`` on a collection
    or leaf name it does not map, and on two leaves that map to one key."""
    out: dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables):
        collection, *mods, name = path
        if (collection, name) not in _LEAVES or not mods:
            raise KeyError(f"unmapped flax leaf {'/'.join(path)}")
        key = ".".join(mods + [_LEAVES[collection, name]])
        if key in out:
            raise KeyError(f"flax leaf {'/'.join(path)} maps onto {key} twice")
        a = np.asarray(leaf, dtype=np.float32)
        if name == "kernel":
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[key] = torch.from_numpy(np.ascontiguousarray(a))
    return out


@torch.no_grad()
def load_flax_variables(model: nn.Module, variables: Mapping) -> None:
    """Copy flax variables into ``model`` (cast to each tensor's dtype and
    device). Raises if a flax leaf is left over, a torch tensor is left
    unfilled, or a shape differs."""
    state = flax_to_torch(variables)
    target = model.state_dict()
    extra = sorted(set(state) - set(target))
    missing = sorted(set(target) - set(state))
    if extra or missing:
        raise KeyError(f"flax/torch mismatch: unconsumed flax leaves {extra}, "
                       f"unfilled torch tensors {missing}")
    for key, value in state.items():
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(f"{key}: flax shape {tuple(value.shape)} vs torch "
                             f"{tuple(target[key].shape)}")
        target[key].copy_(value)
