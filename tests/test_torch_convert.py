"""Weight bridge (``accel_tpu_torch/convert.py``): every flax leaf of the
accel, dff and deeplab models lands on exactly one torch tensor and every
torch tensor is filled, under frozenbn and groupnorm; anything left over
raises."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import seeded_variables

from accel_tpu.models.accel import AccelNet as JAccelNet
from accel_tpu_torch.convert import flax_to_torch, load_flax_variables
from accel_tpu_torch.models.accel import AccelNet, build_model

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


@pytest.mark.parametrize("family,children", [
    ("dff", ["ref_net", "flownet"]),
    ("deeplab", ["ref_net"]),
])
def test_family_trees_load(family, children):
    """A dff tree (ref_net + FlowNet with a head_channels-wide scale field)
    and a deeplab tree (ref_net only) fill the family's modules exactly."""
    kw = dict(ref_depth=18, head_channels=1024)
    jm = JAccelNet(family=family, dtype=jnp.float32, **kw)
    cur = jnp.zeros((1, 128, 128, 3))
    v = seeded_variables(jm, cur, cur, jnp.ones((1,)), train=False, seed=22)
    assert sorted(v["params"]) == sorted(children)
    tm = AccelNet(family=family, **kw, device="meta", dtype=torch.float32).to_empty(device="cpu")
    assert [name for name, _ in tm.named_children()] == children
    assert len(flax_to_torch(v)) == len(jax.tree_util.tree_leaves(v)) == len(tm.state_dict())
    load_flax_variables(tm, v)
    fc6 = v["params"]["ref_net"]["head"]["fc6"]["kernel"]
    np.testing.assert_array_equal(tm.ref_net.head.fc6.weight.detach().numpy(),
                                  np.asarray(fc6).transpose(3, 2, 0, 1))
    if family == "dff":
        sf = v["params"]["flownet"]["scale_field"]["kernel"]
        assert sf.shape[-1] == 1024 and tm.flownet.scale_field.weight.shape[0] == 1024
        np.testing.assert_array_equal(tm.flownet.scale_field.bias.detach().numpy(),
                                      v["params"]["flownet"]["scale_field"]["bias"])


@pytest.mark.parametrize("family", ["dff", "deeplab"])
def test_build_model_seeds_family(family):
    net = dict(name=family, ref_depth=18, head_channels=64, dtype="float32",
               warp_dtype="native", warp_gather="onehot", dilated_conv="pallas_fc6")
    a = build_model(net, device="cpu", generator=torch.Generator().manual_seed(3))
    b = build_model(net, device="cpu", generator=torch.Generator().manual_seed(3))
    c = build_model(net, device="cpu", generator=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert a.family == family and sa.keys() == sb.keys()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["ref_net.head.fc6.weight"], sc["ref_net.head.fc6.weight"])
    assert not hasattr(a, "fusion") and not hasattr(a, "update_net")
    if family == "dff":
        # flax's init: identity warp, unit modulation over the feature width
        assert not a.flownet.predict_flow2.weight.any()
        assert torch.equal(a.flownet.scale_field.bias, torch.ones(64))
    else:
        assert not hasattr(a, "flownet")
