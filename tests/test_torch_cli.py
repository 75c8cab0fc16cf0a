"""The port's eval entry point helpers (``accel_tpu_torch/experiments/test.py``,
``core/checkpoint.py``) against the reference's on every case of
``tests/test_cli.py``, and over the whole grid of provenance and eval
semantics."""

import importlib.util
import itertools
import os

import pytest
import torch

from accel_tpu.core import checkpoint as jck
from accel_tpu_torch.core import checkpoint as tck
from accel_tpu_torch.experiments import test as t_entry

_SPEC = importlib.util.spec_from_file_location(
    "experiments_test_entry",
    os.path.join(os.path.dirname(__file__), "..", "experiments", "test.py"))
j_entry = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(j_entry)
REPO = os.path.join(os.path.dirname(__file__), "..")


def _same(fn_ref, fn_port, *args, **kwargs):
    """Both give the same value, or raise the same type with the same
    message."""
    outcomes = []
    for fn in (fn_ref, fn_port):
        try:
            outcomes.append(("ok", fn(*args, **kwargs)))
        except Exception as e:  # noqa: BLE001 - the exception is what is compared
            outcomes.append((type(e).__name__, str(e)))
    assert outcomes[0] == outcomes[1], outcomes
    return outcomes[1]


OFFSET_CASES = [
    ((5,), dict(ann_offsets="3,4")), ((10,), dict(ann_offsets="8")),
    ((5,), dict(ann_offsets="0")), ((5,), dict(offsets="0,1")),
    ((5,), dict(ann_offsets="4", offsets="4")), ((5,), dict(offset_sweep=True)),
    ((5,), dict(default_key_offset=2)), ((5,), dict(ann_offsets="8")),
    ((5,), dict(offsets="5")), ((5,), dict(ann_offsets="-1")),
    ((3,), dict(default_key_offset=4)), ((5,), dict(default_key_offset=4)),
]


@pytest.mark.parametrize("args,kwargs", OFFSET_CASES)
def test_resolve_key_offsets_matches(args, kwargs):
    _same(j_entry.resolve_key_offsets, t_entry.resolve_key_offsets, *args, **kwargs)


def _prov(objective="clip", propagate="direct", cascade="product", norm="mean1"):
    return {"objective": objective, "propagate": propagate, "scale_cascade": cascade,
            "scale_field_norm": norm, "family": "accel"}


def _net(cascade="product", norm="mean1"):
    return {"scale_cascade": cascade, "scale_field_norm": norm}


# (provenance, eval propagate, eval network, force): tests/test_cli.py's cases
SEMANTICS_CASES = {
    "clip_direct_under_incremental": (_prov("clip", "direct"), "incremental", _net(), False),
    "clip_direct_under_incremental_forced": (_prov("clip", "direct"), "incremental", _net(),
                                             True),
    "pair_under_incremental": (_prov("pair", "direct"), "incremental", _net(), False),
    "pair_under_composed": (_prov("pair", "direct"), "composed", _net(), False),
    "matched_direct": (_prov("clip", "direct"), "direct", _net(), False),
    "matched_incremental": (_prov("clip", "incremental"), "incremental", _net(), False),
    "no_provenance": (None, "incremental", _net(), False),
    "incremental_under_direct": (_prov("clip", "incremental"), "direct", _net(), False),
    "product_trained_last_eval": (_prov("clip", "incremental", cascade="product"),
                                  "incremental", _net(cascade="last"), False),
    "last_trained_product_eval": (_prov("clip", "incremental", cascade="last"),
                                  "incremental", _net(cascade="product"), False),
    "last_trained_last_eval": (_prov("clip", "incremental", cascade="last"), "incremental",
                               _net(cascade="last"), False),
    "cascade_mismatch_under_direct": (_prov("clip", "incremental", cascade="product"),
                                      "direct", _net(cascade="last"), False),
}


@pytest.mark.parametrize("case", list(SEMANTICS_CASES))
def test_check_eval_semantics_matches(case):
    prov, propagate, net, force = SEMANTICS_CASES[case]
    _same(jck.check_eval_semantics, tck.check_eval_semantics, prov, propagate, net, force=force)


def test_check_eval_semantics_grid_matches():
    """Every combination of trained objective, propagation, cascade and
    norm against every eval propagation, cascade and norm, forced or not."""
    n = 0
    for obj, prop, casc, norm in itertools.product(("clip", "pair", None),
                                                   ("direct", "incremental", None),
                                                   ("last", "product", "mean1", None),
                                                   ("mean1", "none", None)):
        prov = {k: v for k, v in dict(objective=obj, propagate=prop, scale_cascade=casc,
                                      scale_field_norm=norm).items() if v is not None}
        for eprop, ecasc, enorm, force in itertools.product(
                ("direct", "incremental", "composed"), ("last", "product", "clamp", None),
                ("mean1", "none", None), (False, True)):
            _same(jck.check_eval_semantics, tck.check_eval_semantics, prov, eprop,
                  {"scale_cascade": ecasc, "scale_field_norm": enorm}, force=force)
            n += 1
    assert n == 3 * 3 * 4 * 3 * 3 * 4 * 3 * 2
    assert issubclass(tck.EvalSemanticsError, ValueError)


def test_provenance_roundtrip_and_format(tmp_path):
    """The port writes and reads ``provenance.json`` as the reference does:
    either package reads the other's."""
    d = str(tmp_path / "prefix")
    assert tck.load_provenance(d) is None
    tck.save_provenance(d, _prov())
    assert jck.load_provenance(d) == _prov()
    jck.save_provenance(d, _prov("pair"))
    assert tck.load_provenance(d) == _prov("pair")


def test_provenance_from_cfg_matches():
    from accel_tpu.config import load_config as jload
    from accel_tpu_torch.config import load_config

    path = os.path.join(REPO, "experiments", "cfgs", "accel18_cityscapes.yaml")
    assert tck.provenance_from_cfg(load_config(path)) == jck.provenance_from_cfg(jload(path))


def test_checkpoints_roundtrip(tmp_path):
    prefix = str(tmp_path / "ckpt")
    assert tck.saved_epochs(prefix) == []
    state = {"model": {"w": torch.arange(6.0).view(2, 3)}}
    for epoch in (4, 0, 11):
        tck.save_checkpoint(prefix, epoch, state)
    tck.save_checkpoint(prefix, 4, {"model": {"w": torch.ones(2)}})  # replaces epoch 4
    assert tck.saved_epochs(prefix) == [0, 4, 11]
    assert torch.equal(tck.load_checkpoint(prefix, 11)["model"]["w"], state["model"]["w"])
    assert torch.equal(tck.load_checkpoint(prefix, 4)["model"]["w"], torch.ones(2))
    assert sorted(os.listdir(prefix)) == ["0.pt", "11.pt", "4.pt"]


@pytest.mark.parametrize("value,want", [
    ("true", True), ("FALSE", False), ("4", 4), ("-2", -2), ("0.5", 0.5), ("1e-3", 1e-3),
    ("native", "native"), ("onehot", "onehot"), ("08", 8)])
def test_set_network_values_parse_as_the_reference(value, want):
    got = t_entry.parse_network_value(value)
    assert got == want and type(got) is type(want)


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = os.path.join(REPO, "experiments", "cfgs", "smoke_tiny_cpu.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_entry.main(["--cfg", cfg, "--random-weights"])


QUANT_CFG = """\
output_path: {out}
SCALES: [[128, 256]]
network:
  name: accel
  ref_depth: 18
  update_depth: 18
  head_channels: 32
  dtype: float32
  propagate: direct
dataset:
  dataset: CityScape
  dataset_path: {data}
  root_path: {root}
  image_set: leftImg8bit_train
  test_image_set: leftImg8bit_val
TEST:
  KEY_FRAME_INTERVAL: 3
"""


def test_quantize_is_not_ported_yet(tmp_path, monkeypatch):
    """``--quantize`` serves both branches through the int8 convs (it sets
    ``quantize_ref`` and ``quantize_update``, as the reference's flag
    does): the eval runs end to end on the CPU with every block conv and
    fc6 of both branches quantized."""
    from torch_parity import write_cityscapes_tree

    from accel_tpu_torch.models.resnet import Int8Conv2d

    data = write_cityscapes_tree(tmp_path, 128, 256, snippets=1, cities=("aachen",))
    path = tmp_path / "quant.yaml"
    path.write_text(QUANT_CFG.format(out=tmp_path / "out", data=data, root=tmp_path))
    built = []

    def recording_build(*args, **kwargs):
        built.append(t_entry_build(*args, **kwargs))
        return built[-1]

    t_entry_build = t_entry.build_model
    monkeypatch.setattr(t_entry, "build_model", recording_build)
    (result,) = t_entry.main(["--cfg", str(path), "--random-weights", "--quantize",
                              "--device", "cpu", "--max-items", "1"])
    assert 0.0 <= result["miou"] <= 1.0 and result["stats"]["frames"] == 3
    (model,) = built
    for branch in (model.ref_net, model.update_net):
        assert sum(isinstance(m, Int8Conv2d) for m in branch.modules()) == 20


# ---- the demo, export and train_test entry points --------------------------------

TINY_CFG = """\
output_path: {out}
SCALES: [[128, 256]]
network:
  name: accel
  ref_depth: 18
  update_depth: 18
  head_channels: 32
  flow_width_mult: 0.25
  norm: frozenbn
  dtype: float32
  propagate: direct
dataset:
  dataset: CityScape
  dataset_path: {data}
  root_path: {root}
  image_set: leftImg8bit_train
  test_image_set: leftImg8bit_val
TRAIN:
  objective: pair
  lr: 0.002
  lr_step: "100"
  warmup: false
  end_epoch: 1
  BATCH_IMAGES: 2
  CROP_SIZE: [128, 128]
  MIN_OFFSET: -2
  MAX_OFFSET: 0
  model_prefix: tiny
TEST:
  KEY_FRAME_INTERVAL: 2
  test_epoch: 1
"""


def _tiny_cfg(tmp_path, data="", name="tiny") -> str:
    path = tmp_path / f"{name}.yaml"
    path.write_text(TINY_CFG.format(out=tmp_path / "out", data=data, root=tmp_path))
    return str(path)


def test_demo_writes_maps_in_the_reference_palette(tmp_path):
    """``demo --synthetic --device cpu`` writes 2k noise frames, then one
    ``*_seg.png`` map a frame, each the port's class map of the clip in
    JAX's ``CITYSCAPES_PALETTE`` (BGR)."""
    import cv2
    import numpy as np

    from accel_tpu_torch.config import load_config
    from accel_tpu_torch.core.pipeline import clip_predictions
    from accel_tpu_torch.data.image import transform
    from accel_tpu_torch.experiments import demo
    from accel_tpu_torch.models.accel import build_model

    spec = importlib.util.spec_from_file_location(
        "experiments_demo", os.path.join(REPO, "experiments", "demo.py"))
    j_demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(j_demo)
    assert np.array_equal(demo.CITYSCAPES_PALETTE, j_demo.CITYSCAPES_PALETTE)

    cfg_path = _tiny_cfg(tmp_path)
    frames, out = tmp_path / "frames", tmp_path / "maps"
    written = demo.main(["--cfg", cfg_path, "--frames", str(frames), "--out", str(out),
                         "--synthetic", "--device", "cpu"])
    assert sorted(os.listdir(out)) == [f"frame_{i:04d}_seg.png" for i in range(4)]
    cfg = load_config(cfg_path)
    clip = np.stack([transform(cv2.imread(str(frames / f"frame_{i:04d}.png")),
                               cfg.network.PIXEL_MEANS, cfg.network.PIXEL_STDS)[0]
                     for i in range(4)])[None]
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    pred = clip_predictions(model, torch.from_numpy(clip), 2, "direct")[0].numpy()
    for i, path in enumerate(written):
        assert np.array_equal(cv2.imread(path), j_demo.colorize(pred[i]))


def test_export_entry_point_writes_a_served_artifact(tmp_path, capsys):
    """``export --random-weights --device cpu``: the artifact serves a clip
    at any batch as the seeded model's ``clip_predictions`` does."""
    from accel_tpu_torch.config import load_config
    from accel_tpu_torch.core.export import load_serving
    from accel_tpu_torch.core.pipeline import clip_predictions
    from accel_tpu_torch.experiments import export
    from accel_tpu_torch.models.accel import build_model

    cfg_path, out = _tiny_cfg(tmp_path), str(tmp_path / "tiny.pt2")
    export.main(["--cfg", cfg_path, "--out", out, "--height", "128", "--width", "128",
                 "--random-weights", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"wrote {out}: ") and line.endswith(
        "MB, clip=(b,2,128,128,3), propagate=direct, params embedded")
    clip = torch.randn((1, 2, 128, 128, 3), generator=torch.Generator().manual_seed(1))
    model = build_model(load_config(cfg_path), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(load_serving(out)(clip), clip_predictions(model, clip, 2, "direct"))


def test_train_test_trains_then_tests(tmp_path, capfd, monkeypatch):
    """``train_test`` runs the train entry point and then the eval entry
    point, each in its own process, with the same arguments: the eval
    restores the checkpoint the training wrote."""
    from torch_parity import write_cityscapes_tree

    from accel_tpu_torch.core.checkpoint import saved_epochs
    from accel_tpu_torch.experiments import train_test

    data = write_cityscapes_tree(tmp_path, 128, 256, snippets=2, split="train", seed=3,
                                 cities=("aachen",))
    write_cityscapes_tree(tmp_path, 128, 256, snippets=1, split="val", seed=4,
                          cities=("aachen",))
    monkeypatch.chdir(REPO)
    assert train_test.main(["--cfg", _tiny_cfg(tmp_path, data), "--device", "cpu"]) == 0
    assert saved_epochs(str(tmp_path / "out" / "tiny" / "leftImg8bit_train" / "tiny")) == [0]
    err = capfd.readouterr().err
    assert "training done" in err and "restored" in err and "meanIU" in err
    assert err.index("training done") < err.index("meanIU")


def test_train_test_stops_on_a_failing_train(monkeypatch):
    from accel_tpu_torch.experiments import train_test

    calls = []
    monkeypatch.setattr(train_test.subprocess, "call", lambda cmd: calls.append(cmd) or 3)
    assert train_test.main(["--cfg", "x.yaml"]) == 3
    (cmd,) = calls
    assert cmd[1:] == ["-m", "accel_tpu_torch.experiments.train", "--cfg", "x.yaml"]
