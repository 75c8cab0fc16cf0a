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


def test_quantize_is_not_ported_yet():
    cfg = os.path.join(REPO, "experiments", "cfgs", "smoke_tiny_cpu.yaml")
    with pytest.raises(NotImplementedError, match="quantize_ref"):
        t_entry.main(["--cfg", cfg, "--random-weights", "--quantize", "--device", "cpu"])
