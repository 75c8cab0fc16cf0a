"""The port's train loaders, training checkpoints and train entry point.

``TrainPairLoader`` and ``TrainClipLoader`` give ``accel_tpu``'s batches bit
for bit (NCHW where the reference's are NHWC) on a Cityscapes-layout tree
written by ``torch_parity.write_cityscapes_tree``, across an epoch's end
(the order is drawn again) with crops and flips drawn. A checkpoint of the
train state resumes it exactly. ``python3 -m
accel_tpu_torch.experiments.train --device cpu`` trains a tiny model
(R18 / R18, head 32, f32, 128x128 crops) for an epoch, its checkpoint is
evaluated by the port's eval entry point, and ``TRAIN.RESUME`` carries it
on from there; a cfg that names pretrained weights (an MXNet ``.params``)
starts from them.
"""

import json

import numpy as np
import pytest
import torch
from torch_parity import write_cityscapes_tree

from accel_tpu.config import load_config as j_load_config
from accel_tpu.data import loader as jloader
from accel_tpu.data.cityscapes import Cityscape as JCityscape
from accel_tpu_torch.config import load_config
from accel_tpu_torch.core import checkpoint as tck
from accel_tpu_torch.core import trainer as ttrainer
from accel_tpu_torch.data import loader as tloader
from accel_tpu_torch.data.cityscapes import Cityscape
from accel_tpu_torch.experiments import test as t_test
from accel_tpu_torch.experiments import train as t_train
from accel_tpu_torch.models.accel import build_model

torch.set_num_threads(2)
H, W = 128, 256
CFG = """\
output_path: {out}
SCALES: [[{h}, {w}]]
network:
  name: accel
  ref_depth: 18
  update_depth: 18
  head_channels: 32
  dtype: float32
  propagate: {propagate}
  PIXEL_STDS: [60.0, 60.0, 60.0]
  pretrained: "{pretrained}"
dataset:
  dataset: CityScape
  dataset_path: {data}
  root_path: {root}
  image_set: leftImg8bit_train
  test_image_set: leftImg8bit_val
TRAIN:
  objective: {objective}
  CLIP_LENGTH: 3
  lr: 0.002
  lr_step: "100"
  warmup: false
  end_epoch: {end_epoch}
  RESUME: {resume}
  BATCH_IMAGES: 2
  CROP_SIZE: [128, 128]
  MIN_OFFSET: -2
  MAX_OFFSET: 0
  aux_loss_weight: 0.5
  model_prefix: tiny
TEST:
  KEY_FRAME_INTERVAL: 3
  test_epoch: 1
"""


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("train")
    data = write_cityscapes_tree(root, H, W, split="train", seed=3)
    write_cityscapes_tree(root, H, W, snippets=1, split="val", seed=4, cities=("aachen",))
    return root, data


def write_cfg(tree, name: str, objective: str = "clip", end_epoch: int = 1,
              resume: bool = False, pretrained: str = "") -> str:
    root, data = tree
    path = root / f"{name}.yaml"
    path.write_text(CFG.format(
        out=root / "out", h=H, w=W, data=data, root=root / name, objective=objective,
        propagate="incremental" if objective == "clip" else "direct", end_epoch=end_epoch,
        resume=str(resume).lower(), pretrained=pretrained))
    return str(path)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.movedim(-3, -1).numpy()


@pytest.mark.parametrize("objective", ["pair", "clip"])
def test_train_loaders_match_jax(tree, objective):
    path = write_cfg(tree, f"loader_{objective}", objective)
    root, data = tree
    name = "TrainClipLoader" if objective == "clip" else "TrainPairLoader"
    jcfg, cfg = j_load_config(path), load_config(path)
    jl = getattr(jloader, name)(JCityscape(jcfg.dataset.image_set, f"{root}/j", str(data)), jcfg,
                                seed=7)
    tl = getattr(tloader, name)(Cityscape(cfg.dataset.image_set, f"{root}/t", str(data)), cfg,
                                seed=7)
    assert tl.epoch_size == jl.epoch_size == 2
    frames = ("clip",) if objective == "clip" else ("data", "data_ref")
    for want, got in zip([b for _, b in zip(range(3), jl)], [b for _, b in zip(range(3), tl)]):
        assert set(got) == set(want)
        for key, ref in want.items():
            ours = got[key]
            assert isinstance(ours, torch.Tensor)
            if key in frames:
                assert ours.dtype == torch.float32 and ours.shape[-3] == 3
                ours = nhwc(ours)
            else:
                ours = ours.numpy()
            assert ours.dtype == ref.dtype and ours.shape == ref.shape, key
            np.testing.assert_array_equal(ours, ref, err_msg=key)
    assert got["label"].shape[-2:] == (128, 128)


def _step_state(cfg, seed: int):
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(seed))
    tx, _ = ttrainer.make_optimizer(cfg, 2, model)
    step = ttrainer.make_train_step(tx, 19, aux_weight=0.5, objective="pair")
    return ttrainer.init_train_state(model, tx), step


def test_checkpoint_resumes_the_train_state_exactly(tree, tmp_path):
    """Save after a step, restore into another model's state: the master
    weights, the momentum, the step and the model are the saved ones, and
    the next step from either gives the same weights."""
    path = write_cfg(tree, "ckpt", "pair")
    cfg = load_config(path)
    root, data = tree
    loader = iter(tloader.TrainPairLoader(Cityscape(cfg.dataset.image_set, f"{root}/c", str(data)),
                                          cfg))
    b0, b1 = next(loader), next(loader)
    state, step = _step_state(cfg, seed=0)
    state, _ = step(state, b0)
    prefix = str(tmp_path / "prefix")
    tck.save_checkpoint(prefix, 0, tck.train_checkpoint(state, 0))
    assert tck.latest_epoch(prefix) == 0 and tck.latest_epoch(str(tmp_path / "none")) is None
    ckpt = tck.load_checkpoint(prefix, 0)
    assert (ckpt["epoch"], ckpt["step"], ckpt["optimizer"]["count"]) == (0, 1, 1)

    other, other_step = _step_state(cfg, seed=1)
    tck.restore_train_state(other, ckpt)
    assert other.step == 1 and other.opt_state["count"] == 1
    for name in state.master:
        assert torch.equal(other.master[name], state.master[name]), name
        assert torch.equal(other.opt_state["trace"][name], state.opt_state["trace"][name]), name
    for (name, a), b in zip(state.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(a, b), name
    state, _ = step(state, b1)
    other, _ = other_step(other, b1)
    for name in state.master:
        assert torch.equal(other.master[name], state.master[name]), name


def test_train_entry_point_trains_and_its_checkpoint_evaluates(tree):
    root, _ = tree
    path = write_cfg(tree, "entry")
    state = t_train.main(["--cfg", path, "--device", "cpu", "--frequent", "1"])
    prefix = root / "out" / "entry" / "leftImg8bit_train" / "tiny"
    assert state.step == 2 and tck.saved_epochs(str(prefix)) == [0]
    prov = json.loads((prefix / "provenance.json").read_text())
    assert prov["objective"] == "clip" and prov["propagate"] == "incremental"
    metrics = root / "out" / "entry" / "leftImg8bit_train" / "metrics.jsonl"
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [r["step"] for r in rows] == [1, 2] and all(np.isfinite(r["loss"]) for r in rows)
    ckpt = tck.load_checkpoint(str(prefix), 0)
    for name, p in state.master.items():
        assert torch.equal(ckpt["model"][name], p), name

    (result,) = t_test.main(["--cfg", path, "--device", "cpu", "--max-items", "1"])
    assert 0.0 <= result["miou"] <= 1.0 and result["stats"]["frames"] == 3

    # TRAIN.RESUME: epoch 1 from the checkpoint of epoch 0
    resumed = t_train.main(["--cfg", write_cfg(tree, "entry", end_epoch=2, resume=True),
                            "--device", "cpu"])
    assert resumed.step == 4 and tck.saved_epochs(str(prefix)) == [0, 1]
    assert tck.load_checkpoint(str(prefix), 1)["optimizer"]["count"] == 4


def test_train_entry_point_refuses_what_is_not_ported(tree, monkeypatch):
    """``network.pretrained`` names an MXNet ``.params`` by its prefix
    (``{prefix}-{epoch:04d}.params``): its Caffe-named conv1 and stem norm
    scale start the reference backbone (the f32 master copy and the model
    take them exactly), the moving mean, which a groupnorm model has no
    place for, is reported unmatched, and the model trains from there. A
    missing pretrained file, an unknown flag and a missing card are
    refused."""
    from tests.test_convert import _write_mxnet_params

    root, _ = tree
    rng = np.random.default_rng(7)
    conv1 = rng.standard_normal((64, 3, 7, 7)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    _write_mxnet_params(str(root / "r18-0000.params"),
                        {"arg:conv1_weight": conv1, "arg:bn_conv1_gamma": gamma,
                         "aux:bn_conv1_moving_mean": np.zeros(64, np.float32)})
    path = write_cfg(tree, "pretrained", objective="pair", pretrained=str(root / "r18"))
    starts = []

    def recording_init(model, tx, params=None):
        state = ttrainer.init_train_state(model, tx, params)
        starts.append({k: v.clone() for k, v in state.master.items()})
        return state

    monkeypatch.setattr(t_train, "init_train_state", recording_init)
    state = t_train.main(["--cfg", path, "--device", "cpu"])
    (start,) = starts
    np.testing.assert_array_equal(start["ref_net.backbone.conv1.weight"].numpy(), conv1)
    np.testing.assert_array_equal(start["ref_net.backbone.bn.weight"].numpy(), gamma)
    assert state.step == 2 and not torch.equal(state.master["ref_net.backbone.conv1.weight"],
                                               start["ref_net.backbone.conv1.weight"])
    prefix = root / "out" / "pretrained" / "leftImg8bit_train" / "tiny"
    assert tck.saved_epochs(str(prefix)) == [0]

    with pytest.raises(FileNotFoundError, match="flownet"):
        t_train.main(["--cfg", write_cfg(tree, "flow"), "--device", "cpu",
                      "--set-network", f"pretrained_flow={root / 'flownet'}"])
    with pytest.raises(SystemExit):
        t_train.main(["--cfg", path, "--device", "cpu", "--no-such-flag"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_train.main(["--cfg", write_cfg(tree, "nocard")])


def test_fit_logs_a_speedometer_line_every_frequent_steps(monkeypatch):
    """fit's Speedometer line and metrics row every ``frequent`` steps and
    at each epoch's end, and the epoch callback after each epoch."""
    lines, rows, ends = [], [], []

    class Log:
        info = staticmethod(lines.append)

    class Rows:
        @staticmethod
        def write(step, **values):
            rows.append((step, values))

    def step(state, batch):
        state.step += 1
        return state, {"loss": torch.tensor(0.5 * state.step)}

    # the clock moves a second a reading: each line times the steps since
    # the last one in 1 s
    clock = iter(range(100))
    monkeypatch.setattr("accel_tpu_torch.core.trainer.time.time", lambda: float(next(clock)))
    state = ttrainer.TrainState(step=0, model=torch.nn.Linear(1, 1), master={}, opt_state={})
    batches = iter([{"data": torch.zeros(4, 3, 2, 2)}] * 10)
    state = ttrainer.fit(state, step, batches, epochs=2, epoch_size=5, logger=Log, frequent=2,
                         epoch_end_callback=lambda e, s: ends.append((e, s.step)),
                         metrics_writer=Rows())
    assert state.step == 10 and ends == [(0, 5), (1, 10)]
    assert lines[:3] == ["Epoch[0] Batch [2/5]\tSpeed: 8.00 samples/sec\tFCNLogLoss=1.00000",
                         "Epoch[0] Batch [4/5]\tSpeed: 8.00 samples/sec\tFCNLogLoss=2.00000",
                         "Epoch[0] Batch [5/5]\tSpeed: 4.00 samples/sec\tFCNLogLoss=2.50000"]
    assert len(lines) == 6 and lines[5].startswith("Epoch[1] Batch [5/5]")
    assert [r[0] for r in rows] == [2, 4, 5, 7, 9, 10]
    assert rows[2][1] == dict(loss=2.5, samples_per_sec=4.0, epoch=0)
