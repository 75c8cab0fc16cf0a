"""The port's config (``accel_tpu_torch/config``) against ``accel_tpu.config``
and PyYAML: the YAML-subset reader gives ``yaml.safe_load``'s dict on every
experiment cfg, ``load_config`` the reference's config, and
``build_model(cfg)`` takes the cfg's defaults."""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from accel_tpu.config import load_config as j_load_config
from accel_tpu_torch.config import default_config, load_config, safe_load
from accel_tpu_torch.models.accel import build_model
from accel_tpu_torch.models.resnet import BatchNorm, FrozenBatchNorm

torch.set_num_threads(2)
CFGS = sorted((Path(__file__).resolve().parents[1] / "experiments" / "cfgs").glob("*.yaml"))


def _plain(x):
    """Config -> nested dicts and lists."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


@pytest.mark.parametrize("path", CFGS, ids=lambda p: p.name)
def test_reader_and_loader_match_the_reference(path):
    text = path.read_text()
    got, want = safe_load(text), yaml.safe_load(text)
    assert got == want and repr(got) == repr(want)
    assert _plain(load_config(str(path))) == _plain(j_load_config(str(path)))


def test_strict_merge_raises_on_an_unknown_key(tmp_path):
    path = tmp_path / "typo.yaml"
    path.write_text("network:\n  ref_dpeth: 50\n")
    with pytest.raises(KeyError, match="network.ref_dpeth"):
        j_load_config(str(path))
    with pytest.raises(KeyError, match="network.ref_dpeth"):
        load_config(str(path))
    assert load_config(str(path), strict=False).network.ref_dpeth == 50


# YAML 1.1 scalars as PyYAML resolves them: a quoted number stays a str, a
# float needs a '.', and its exponent a sign; yes/on are bools
SCALARS = [
    'a: "3.333"', "a: '1'", "a: 0.00005", "a: 5e-5", "a: 1.0e+5", "a: 1.0e5", "a: 1.",
    "a: .5", "a: -.5", "a: +12", "a: -0", "a: 1_000", "a: 0x1F", "a: 010", "a: 08",
    "a: 0b101", "a: 1e3", "a: .inf", "a: -.Inf", "a: yes", "a: No", "a: On", "a: OFF",
    "a: true", "a: TRUE", "a: tRue", "a: null", "a: ~", "a: Null", "a:", "a: x y",
    "a: 'it''s'", 'a: "tab\\tand \\u00e9"', "a: b # comment", "a: [1, [2, 3], '4', x y, ]",
    "a: []", "a: [[1024, 2048]]", "1: x", "a:\n  b:\n    c: 1\n  d: 2\ne: 3",
    "# only a comment\n", "",
]


@pytest.mark.parametrize("text", SCALARS)
def test_scalars_resolve_as_pyyaml(text):
    got, want = safe_load(text), yaml.safe_load(text)
    assert repr(got) == repr(want)


OUTSIDE = [
    "a: &x 1\nb: *x", "a: *x", "a: |\n  x", "a: >\n  x", "---\na: 1", "a: 1\n---\nb: 2",
    "%YAML 1.1\na: 1", "a: !!str 1", "a: {b: 1}", "a:\n  - 1", "- 1", "a: 1:30",
    "a: 2001-12-14", "<<: {}", "a: x\n  y", "a: [1,\n 2]", 'a: "x', "a:\tb", "a: b: c",
]


@pytest.mark.parametrize("text", OUTSIDE)
def test_outside_the_subset_raises(text):
    with pytest.raises(ValueError, match="outside the subset"):
        safe_load(text)


def test_build_model_takes_the_cfg_defaults():
    """``build_model(cfg)`` builds the norm, stem, scale-field norm and
    cascade of the cfg defaults (groupnorm, conv7, mean1, last), as
    ``accel_tpu``'s ``build_model(cfg)`` does, not ``AccelNet``'s
    (frozenbn, none), and takes the class count from the dataset."""
    cfg = default_config()
    cfg.network.update(ref_depth=18, head_channels=32, dtype="float32", scale_cascade="product")
    cfg.dataset.NUM_CLASSES = 11
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    norms = {type(m).__name__ for m in model.modules()
             if isinstance(m, (FrozenBatchNorm, torch.nn.GroupNorm))}
    assert norms and not any(m for m in model.modules() if isinstance(m, FrozenBatchNorm))
    assert model.ref_net.backbone.stem == "conv7" and model.update_net.backbone.stem == "conv7"
    assert model.scale_field_norm == "mean1" and model.scale_cascade == "product"
    assert model.num_classes == 11 and model.dtype == torch.float32
    assert model.fusion.weight.shape[0] == 11
    # a bare mapping keeps AccelNet's defaults
    bare = build_model(dict(ref_depth=18, head_channels=32, dtype="float32"), device="cpu",
                       generator=torch.Generator().manual_seed(0))
    assert bare.scale_field_norm == "none" and bare.num_classes == 19
    assert any(isinstance(m, FrozenBatchNorm) for m in bare.modules())


def test_cfg_values_not_ported_raise():
    """Every value of these keys that ``accel_tpu``'s ``build_model`` takes
    builds a model here; ``use_scale_field: false`` (a FlowNet without the
    DFF scale field) is the value the port still refuses."""
    norms = {"batchnorm": BatchNorm, "frozenbn": FrozenBatchNorm, "groupnorm": torch.nn.GroupNorm}
    for key, value in [("norm", "batchnorm"), ("norm", "frozenbn"), ("stem", "s2d"),
                       ("stem", "fused7"), ("quantize_ref", True), ("quantize_update", True),
                       ("fold_flow_downscale", True), ("fold_update_downscale", True),
                       ("dilated_conv", "s2b"), ("dilated_conv", "shift1x1"),
                       ("dilated_conv", "pallas"), ("dilated_conv", "pallas_fc6")]:
        cfg = default_config()
        cfg.network.update(ref_depth=18, update_depth=18, head_channels=32, dtype="float32",
                           update_input_downscale=2)
        if value == "fused7":
            cfg.network.norm = "frozenbn"
        cfg.network[key] = value
        model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        assert model.ref_net.backbone.stem == cfg.network.stem, (key, value)
        assert isinstance(model.ref_net.backbone.bn, norms[cfg.network.norm]), (key, value)
    cfg.network.use_scale_field = False
    with pytest.raises(NotImplementedError, match="use_scale_field"):
        build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))


def test_config_clone_is_deep():
    cfg = default_config()
    other = cfg.clone()
    other.SCALES[0][0] = 1
    other.network.name = "dff"
    assert cfg.SCALES == [[1024, 2048]] and cfg.network.name == "accel"
    assert np.asarray(other.SCALES).shape == (1, 2)
