"""Weight bridge (``accel_tpu_torch/convert.py``): every flax leaf of the
accel model lands on exactly one torch tensor and every torch tensor is
filled, under frozenbn and groupnorm; anything left over raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import seeded_variables

from accel_tpu.models.accel import AccelNet as JAccelNet
from accel_tpu_torch.convert import flax_to_torch, load_flax_variables
from accel_tpu_torch.models.accel import AccelNet

torch.set_num_threads(2)
TINY = dict(ref_depth=18, update_depth=18, head_channels=32)


def _pair(norm, stem="conv7"):
    jm = JAccelNet(family="accel", dtype=jnp.float32, norm=norm, stem=stem, **TINY)
    cur = jnp.zeros((1, 128, 128, 3))
    v = seeded_variables(jm, cur, cur, jnp.ones((1,)), train=False, seed=21)
    tm = AccelNet(**TINY, norm=norm, stem=stem, device="meta", dtype=torch.float32)
    return v, tm.to_empty(device="cpu")


@pytest.mark.parametrize("norm,stem,n_params,n_stats", [
    ("groupnorm", "conv7", 170, 0),
    ("frozenbn", "conv7", 170, 80),
    ("frozenbn", "fused7", 170, 80),  # the fused stem keeps the conv7 tree
])
def test_every_leaf_consumed_once(norm, stem, n_params, n_stats):
    v, tm = _pair(norm, stem)
    leaves = jax.tree_util.tree_leaves(v)
    assert len(jax.tree_util.tree_leaves(v["params"])) == n_params
    assert len(jax.tree_util.tree_leaves(v.get("batch_stats", {}))) == n_stats
    state = flax_to_torch(v)
    assert len(state) == len(leaves) == len(tm.state_dict())
    load_flax_variables(tm, v)
    got = tm.state_dict()
    # HWIO -> OIHW, and the norm's scale / running stats
    k = np.asarray(v["params"]["ref_net"]["backbone"]["conv1"]["kernel"])
    w = got["ref_net.backbone.conv1.weight"].numpy()
    assert w.shape == (64, 3, 7, 7)
    assert w[5, 1, 2, 3] == k[2, 3, 1, 5]
    bn = v["params"]["update_net"]["backbone"]["layer2_block0"]["bn1"]["scale"]
    np.testing.assert_array_equal(got["update_net.backbone.layer2_block0.bn1.weight"], bn)
    if n_stats:
        var = v["batch_stats"]["ref_net"]["backbone"]["bn"]["var"]
        np.testing.assert_array_equal(got["ref_net.backbone.bn.running_var"], var)


def _drop(tree, path):
    *head, last = path
    for k in head:
        tree = tree[k]
    del tree[last]


def test_missing_or_extra_leaf_raises():
    v, tm = _pair("frozenbn")
    missing = jax.tree_util.tree_map(lambda a: a, v)
    _drop(missing, ("params", "fusion", "bias"))
    with pytest.raises(KeyError, match="fusion.bias"):
        load_flax_variables(tm, missing)

    extra = jax.tree_util.tree_map(lambda a: a, v)
    extra["params"]["flownet"]["conv7"] = {"kernel": np.zeros((3, 3, 8, 8), np.float32)}
    with pytest.raises(KeyError, match="flownet.conv7.weight"):
        load_flax_variables(tm, extra)

    odd = jax.tree_util.tree_map(lambda a: a, v)
    odd["params"]["fusion"]["gamma"] = np.zeros((19,), np.float32)
    with pytest.raises(KeyError, match="fusion/gamma"):
        flax_to_torch(odd)

    wrong = jax.tree_util.tree_map(lambda a: a, v)
    wrong["params"]["fusion"]["bias"] = np.zeros((7,), np.float32)
    with pytest.raises(ValueError, match="fusion.bias"):
        load_flax_variables(tm, wrong)
