"""The port's pretrained-weight import (``core/pretrained.py``,
``utils/mxnet_io.py``) against ``accel_tpu``'s.

An MXNet ``.params`` file written by ``tests/test_convert.py``'s writer
reads back the same through both parsers. ``merge_pretrained`` at the JAX
test's depth (``tests/test_pretrained.py``): every Caffe/MSRA name of a
ResNet-18 merged into a tiny Accel model's reference backbone, the
ImageNet classifier left unmatched, exact flax paths into FlowNet and the
port's own keys; a torchvision ``.pth`` and an ``.npz`` through
``load_named_arrays``. Each merge is compared, tensor for tensor and
exactly, with JAX's merge bridged by ``convert.flax_to_torch`` (MXNet's
OIHW weights need no transpose in the port; JAX's HWIO paths take the
bridge's). Training from a written ``.params`` through the port's entry
point is in ``test_torch_train_data.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import seeded_variables

from accel_tpu.config import default_config as j_default_config
from accel_tpu.core import pretrained as jpre
from accel_tpu.models.accel import AccelNet as JAccelNet
from accel_tpu.utils.mxnet_io import load_mxnet_params as j_load_mxnet_params
from accel_tpu_torch.config import default_config
from accel_tpu_torch.convert import flax_to_torch
from accel_tpu_torch.core import pretrained as tpre
from accel_tpu_torch.models.resnet import STAGE_PLANS
from accel_tpu_torch.utils.mxnet_io import load_mxnet_params
from tests.test_convert import _write_mxnet_params
from tools.convert_params import convert_torch_resnet as j_convert_torch_resnet


@pytest.fixture(scope="module")
def tiny():
    """Seeded flax variables of a tiny Accel model and the port's tensors
    bridged from them."""
    jm = JAccelNet(family="accel", ref_depth=18, update_depth=18, head_channels=32,
                   dtype=jnp.float32)
    cur = jnp.zeros((1, 128, 128, 3))
    v = jax.tree.map(np.asarray, seeded_variables(jm, cur, cur, jnp.ones((1,)), seed=41))
    return v, flax_to_torch(v)


def assert_merged_as_jax(got: dict, jax_merged, ours_before: dict) -> int:
    """Every tensor of the port's merge equals JAX's merge, bridged; returns
    how many the merge changed."""
    want = flax_to_torch(jax.tree.map(np.asarray, jax_merged))
    assert got.keys() == want.keys()
    changed = 0
    for key, value in got.items():
        assert torch.equal(value, want[key]), key
        changed += not torch.equal(value, ours_before[key])
    return changed


def _caffe_arrays(variables, depth: int, seed: int):
    """A random OIHW/vector array for every Caffe name of ``depth`` that has
    a leaf in the reference backbone, plus ImageNet's fc1000."""
    rng = np.random.default_rng(seed)
    arg, aux = {}, {}
    backbone = {"params": variables["params"]["ref_net"]["backbone"],
                "batch_stats": variables["batch_stats"]["ref_net"]["backbone"]}
    for name, (coll, rel) in jpre.caffe_resnet_table(depth).items():
        leaf = backbone[coll]
        try:
            for p in rel:
                leaf = leaf[p]
        except KeyError:  # branch1 only on the blocks that change shape
            continue
        shape = leaf.shape if leaf.ndim != 4 else (leaf.shape[3], leaf.shape[2], *leaf.shape[:2])
        (aux if coll == "batch_stats" else arg)[name] = rng.standard_normal(shape).astype(
            np.float32)
    arg["fc1000_weight"] = rng.standard_normal((1000, 512)).astype(np.float32)
    return arg, aux


def test_mxnet_params_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {"arg:conv1_weight": rng.standard_normal((64, 3, 7, 7)).astype(np.float32),
               "arg:fc_bias": rng.standard_normal((19,)).astype(np.float32),
               "aux:bn_conv1_moving_mean": rng.standard_normal((64,)).astype(np.float32)}
    path = tmp_path / "rt-0000.params"
    _write_mxnet_params(str(path), tensors)
    arg, aux = load_mxnet_params(str(path))
    jarg, jaux = j_load_mxnet_params(str(path))
    assert arg.keys() == jarg.keys() == {"conv1_weight", "fc_bias"}
    assert aux.keys() == jaux.keys() == {"bn_conv1_moving_mean"}
    for name, value in tensors.items():
        short = name.split(":", 1)[1]
        got = (aux if name.startswith("aux:") else arg)[short]
        np.testing.assert_array_equal(got, value)
        np.testing.assert_array_equal(got, (jaux if name.startswith("aux:") else jarg)[short])
    with pytest.raises(ValueError, match="NDArray-list"):
        (tmp_path / "bad.params").write_bytes(b"\0" * 32)
        load_mxnet_params(str(tmp_path / "bad.params"))


@pytest.mark.parametrize("depth", [18, 34, 50, 101])
def test_caffe_table_matches_jax(depth):
    table = tpre.caffe_resnet_table(depth)
    jtable = jpre.caffe_resnet_table(depth)
    assert table.keys() == jtable.keys()
    leaves = {"kernel": "weight", "scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}
    for name, (_, rel) in jtable.items():
        assert table[name] == ".".join([*rel[:-1], leaves[rel[-1]]]), name
    blocks = sum(STAGE_PLANS[depth][1])
    assert len(table) == 5 + blocks * (5 * (2 if depth < 50 else 3) + 5)


def test_caffe_name_merge_into_backbone(tiny):
    v, ours = tiny
    arg, aux = _caffe_arrays(v, 18, seed=1)
    merged, rep = tpre.merge_pretrained(ours, arg, aux, submodule=("ref_net", "backbone"),
                                        depth=18)
    jmerged, jrep = jpre.merge_pretrained(v, arg, aux, submodule=("ref_net", "backbone"),
                                          depth=18)
    assert rep["matched"] == jrep["matched"] == len(arg) + len(aux) - 1
    assert rep["unmatched"] == jrep["unmatched"] == ["fc1000_weight"]
    assert not rep["skipped_shape"]
    assert assert_merged_as_jax(merged, jmerged, ours) == rep["matched"]
    # an OIHW conv weight lands as it is
    np.testing.assert_array_equal(merged["ref_net.backbone.conv1.weight"].numpy(),
                                  arg["conv1_weight"])


def test_exact_path_and_port_key_merge(tiny):
    """A flax path (HWIO kernel) into FlowNet, as the JAX test merges it,
    and the port's own key of the same tensor (OIHW); a wrong shape is
    reported and skipped, on both sides."""
    v, ours = tiny
    leaf = v["params"]["flownet"]["predict_flow2"]["kernel"]
    src = np.random.default_rng(2).standard_normal(leaf.shape).astype(np.float32)
    bad = np.zeros((3, 3), np.float32)
    arg = {"predict_flow2/kernel": src, "params/flownet/conv2/bias": bad}
    merged, rep = tpre.merge_pretrained(ours, arg, {}, submodule=("flownet",))
    jmerged, jrep = jpre.merge_pretrained(v, arg, {}, submodule=("flownet",))
    assert rep["matched"] == jrep["matched"] == 1 and not rep["unmatched"]
    assert [s[0] for s in rep["skipped_shape"]] == [s[0] for s in jrep["skipped_shape"]]
    assert assert_merged_as_jax(merged, jmerged, ours) == 1
    by_key, rep = tpre.merge_pretrained(
        ours, {"predict_flow2.weight": src.transpose(3, 2, 0, 1)}, {}, submodule=("flownet",))
    assert rep["matched"] == 1
    assert torch.equal(by_key["flownet.predict_flow2.weight"],
                       merged["flownet.predict_flow2.weight"])


def _torchvision_resnet18(seed: int) -> dict:
    """torchvision's resnet18 keys and shapes, random values."""
    rng = np.random.default_rng(seed)

    def bn(prefix, c):
        return {f"{prefix}.weight": rng.uniform(0.5, 1.5, c), f"{prefix}.bias": rng.normal(0, .1, c),
                f"{prefix}.running_mean": rng.normal(0, .1, c),
                f"{prefix}.running_var": rng.uniform(0.5, 1.5, c)}

    sd = {"conv1.weight": rng.standard_normal((64, 3, 7, 7)), **bn("bn1", 64)}
    cin = 64
    for li, w in enumerate((64, 128, 256, 512), start=1):
        for bi in range(2):
            t, c_in = f"layer{li}.{bi}", cin if bi == 0 else w
            sd[f"{t}.conv1.weight"] = rng.standard_normal((w, c_in, 3, 3))
            sd[f"{t}.conv2.weight"] = rng.standard_normal((w, w, 3, 3))
            sd.update(bn(f"{t}.bn1", w), **bn(f"{t}.bn2", w))
            if bi == 0 and (c_in != w):
                sd[f"{t}.downsample.0.weight"] = rng.standard_normal((w, c_in, 1, 1))
                sd.update(bn(f"{t}.downsample.1", w))
        cin = w
    return {k: torch.from_numpy(np.asarray(a, np.float32)) for k, a in sd.items()}


@pytest.mark.parametrize("stem", ["conv7", "s2d"])
def test_torchvision_conversion_matches_jax(stem):
    sd = _torchvision_resnet18(3)
    params, stats = tpre.convert_torch_resnet(sd, 18, stem=stem)
    jparams, jstats = j_convert_torch_resnet(sd, 18, stem=stem)
    want = flax_to_torch({"params": jparams, "batch_stats": jstats})
    got = {**params, **stats}
    assert got.keys() == want.keys()
    for key, value in got.items():
        np.testing.assert_array_equal(value, want[key].numpy(), err_msg=key)


def test_pth_and_npz_files_merge_as_jax(tiny, tmp_path):
    v, ours = tiny
    sd = _torchvision_resnet18(4)
    torch.save(sd, tmp_path / "r18.pth")
    arg, aux = tpre.load_named_arrays(str(tmp_path / "r18.pth"), depth=18)
    jarg, jaux = jpre._load_named_arrays(str(tmp_path / "r18.pth"), depth=18)
    merged, rep = tpre.merge_pretrained(ours, arg, aux, submodule=("update_net", "backbone"))
    jmerged, jrep = jpre.merge_pretrained(v, jarg, jaux, submodule=("update_net", "backbone"))
    assert rep["matched"] == jrep["matched"] == len(sd) and not rep["unmatched"]
    assert assert_merged_as_jax(merged, jmerged, ours) == len(sd)

    np.savez(tmp_path / "fc.npz", **{"arg:predict_flow2/bias": np.full(2, 0.5, np.float32),
                                     "stats/bn/mean": np.full(64, 0.25, np.float32)})
    arg, aux = tpre.load_named_arrays(str(tmp_path / "fc.npz"))
    assert arg.keys() == {"predict_flow2/bias"} and aux.keys() == {"bn/mean"}
    merged, rep = tpre.merge_pretrained(ours, {**arg, **aux}, {}, submodule=("flownet",))
    assert rep["matched"] == 1 and rep["unmatched"] == ["bn/mean"]  # FlowNet has no bn
    with pytest.raises(FileNotFoundError, match="not found"):
        tpre.load_named_arrays(str(tmp_path / "missing"))
    with pytest.raises(ValueError, match="unsupported"):
        (tmp_path / "w.bin").write_bytes(b"")
        tpre.load_named_arrays(str(tmp_path / "w.bin"))


def test_apply_pretrained_cfg_matches_jax(tiny, tmp_path, capsys):
    """``network.pretrained`` by its prefix (``{prefix}-{epoch:04d}.params``)
    and ``pretrained_flow``: the reports and tensors of both packages, and
    the scale-field warning where the flow weights meet a normalized field."""
    v, ours = tiny
    arg, aux = _caffe_arrays(v, 18, seed=5)
    _write_mxnet_params(str(tmp_path / "r18-0002.params"),
                        {**{f"arg:{k}": a for k, a in arg.items()},
                         **{f"aux:{k}": a for k, a in aux.items()}})
    flow = v["params"]["flownet"]["conv6_1"]["bias"]
    np.savez(tmp_path / "flow.npz", **{"params/flownet/conv6_1/bias": np.ones_like(flow)})
    reports = {}
    for name, cfg in (("jax", j_default_config()), ("port", default_config())):
        cfg.network.update(ref_depth=18, pretrained=str(tmp_path / "r18"), pretrained_epoch=2,
                           pretrained_flow=str(tmp_path / "flow.npz"), scale_field_norm="mean1")
        if name == "jax":
            jmerged, reports[name] = jpre.apply_pretrained_cfg(cfg, v)
        else:
            merged, reports[name] = tpre.apply_pretrained_cfg(cfg, ours)
    assert reports["port"].keys() == {"ref", "flow"}
    for tag in ("ref", "flow"):
        assert reports["port"][tag]["matched"] == reports["jax"][tag]["matched"]
        assert reports["port"][tag]["unmatched"] == reports["jax"][tag]["unmatched"]
    assert assert_merged_as_jax(merged, jmerged, ours) == len(arg) + len(aux) - 1 + 1
    assert capsys.readouterr().out.count("pretrained_flow is set") == 2
