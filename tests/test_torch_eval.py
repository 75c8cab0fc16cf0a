"""Video eval through the port (``core.predictor.pred_eval_clips`` and
``pred_eval``, ``experiments.test.main``) against ``accel_tpu``'s on a
Cityscapes-layout tree the test writes.

Both packages build a tiny f32 Accel model (R18 / R18, head 32; the cfg
defaults otherwise: groupnorm, conv7, scale_field_norm mean1, cascade
last) from one YAML file. On seeded random weights, bridged to the port,
their confusion matrices agree within an L1 of 2e-3 of the valid pixels
(class maps >= 0.999, the f32 bar of the parity tests) and their mIoU
within 1e-3, under incremental and direct propagation and when SCALES
resizes the frames (scoring at the annotation's own resolution).

Then the trained-weights check: the model trained a few tens of steps by
``accel_tpu``'s ``make_train_step``, saved by its ``save_checkpoint`` and
``save_provenance``, restored by ``load_checkpoint`` and bridged into a
port checkpoint, gives the same mIoU (1e-3) through ``accel_tpu``'s
``pred_eval_clips`` and the port's ``main`` (confusion L1 <= 2e-4 of the
valid pixels): trained margins leave no near-ties for f32 rounding to
flip.

The JAX package's CPU warp does not clamp the flow; the port clamps it to
``warp_max_disp`` as the TPU kernel does, so the tests hold the flow under
that bound. The JAX side's resize, normalize and LUT run its own C++
(``torch_parity.jax_native_ops``), as the port's do, so both packages'
batches are the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (
    jax_native_ops,
    port_checkpoint_from_jax,
    seeded_variables,
    write_cityscapes_tree,
)

from accel_tpu.config import load_config as j_load_config
from accel_tpu.core import checkpoint as jck
from accel_tpu.core import metrics as jm
from accel_tpu.core import predictor as jpred
from accel_tpu.data.cityscapes import Cityscape as JCityscape
from accel_tpu.data.loader import TestClipLoader as JTestClipLoader
from accel_tpu.data.loader import TrainPairLoader
from accel_tpu.models.accel import build_model as j_build_model
from accel_tpu_torch.config import load_config
from accel_tpu_torch.convert import load_flax_variables
from accel_tpu_torch.core import predictor as tpred
from accel_tpu_torch.core.checkpoint import EvalSemanticsError, save_provenance
from accel_tpu_torch.core.metrics import SegConfusionAccumulator
from accel_tpu_torch.data.cityscapes import Cityscape
from accel_tpu_torch.data.loader import TestClipLoader
from accel_tpu_torch.experiments import test as t_entry
from accel_tpu_torch.models.accel import build_model

torch.set_num_threads(2)
H, W = 128, 256
INTERVAL = 3
CFG = """\
output_path: {out}
SCALES: [[{h}, {w}]]
network:
  name: accel
  ref_depth: 18
  update_depth: 18
  head_channels: 32
  dtype: float32
  use_pallas_warp: false
  propagate: {propagate}
  PIXEL_STDS: [60.0, 60.0, 60.0]
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
  BATCH_IMAGES: 2
  CROP_SIZE: [128, 128]
  MIN_OFFSET: -2
  MAX_OFFSET: 0
  aux_loss_weight: 0.5
  model_prefix: tiny
TEST:
  KEY_FRAME_INTERVAL: {interval}
  test_epoch: 1
"""


@pytest.fixture(scope="module", autouse=True)
def jax_side_native(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        jax_native_ops(mp, tmp_path_factory.mktemp("jax_native"))
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    data = write_cityscapes_tree(root, H, W, split="val")
    write_cityscapes_tree(root, H, W, split="train", seed=1, cities=("aachen",))
    return root, data


def write_cfg(root, data, name: str, propagate: str = "incremental", hw=(H, W)) -> str:
    path = root / f"{name}.yaml"
    path.write_text(CFG.format(out=root / "out", h=hw[0], w=hw[1], propagate=propagate,
                               data=data, root=root / name, interval=INTERVAL))
    return str(path)


def seeded_with_live_flow(jmodel, path, seed: int, target: float = 3.0):
    """``seeded_variables`` with the flow head rescaled (the flow is linear
    in it) so that the largest flow between the first clip's first two
    frames is ``target`` feature pixels, well inside the port's clamp."""
    cur = jnp.zeros((1, 128, 128, 3))
    variables = seeded_variables(jmodel, cur, cur, jnp.ones((1,)), train=False, seed=seed)
    clip = next(iter(_loaders(path)[0]))["clip"]

    flow_of = jax.jit(lambda v, cur, anchor: jmodel.apply(v, cur, anchor, method="flow")[0])

    def max_flow():
        flow = flow_of(variables, jnp.asarray(clip[:, 1]), jnp.asarray(clip[:, 0]))
        return float(np.abs(np.asarray(flow)).max())

    head = variables["params"]["flownet"]["predict_flow2"]
    gain = target / max_flow()
    for name in ("kernel", "bias"):
        head[name] = head[name] * gain
    assert abs(max_flow() - target) < 1e-3 * target
    return variables


@pytest.fixture(scope="module")
def models(tree):
    """Both packages' models from one cfg file, with the same seeded
    weights: (jax model, its variables, torch model, cfg path)."""
    root, data = tree
    path = write_cfg(root, data, "random")
    jmodel = j_build_model(j_load_config(path))
    variables = seeded_with_live_flow(jmodel, path, seed=81)
    tmodel = build_model(load_config(path), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    load_flax_variables(tmodel, variables)
    return jmodel, variables, tmodel, path


@pytest.fixture
def jax_confusion(monkeypatch):
    """The confusion matrices ``accel_tpu``'s eval loops accumulate."""
    made = []

    class Recording(jm.SegConfusionAccumulator):
        def __init__(self, num_classes):
            super().__init__(num_classes)
            made.append(self)

    monkeypatch.setattr(jpred, "SegConfusionAccumulator", Recording)
    return made


def assert_same_eval(cm, jcm, miou, jmiou, l1_share: float) -> None:
    valid = float(jcm.sum())
    assert valid > 0 and float(cm.sum()) == valid
    l1 = float(np.abs(cm - jcm).sum())
    assert l1 <= l1_share * valid, f"confusion L1 {l1} of {valid} valid pixels"
    assert abs(miou - jmiou) <= 1e-3, (miou, jmiou)


def _loaders(path, scales=None, batch_clips=2):
    """The eval loader of each package for the cfg at ``path``."""
    out = []
    for load, imdb_cls, loader_cls, sub in ((j_load_config, JCityscape, JTestClipLoader, "j"),
                                            (load_config, Cityscape, TestClipLoader, "t")):
        cfg = load(path)
        if scales is not None:
            cfg.SCALES = scales
        imdb = imdb_cls(cfg.dataset.test_image_set, f"{cfg.dataset.root_path}/{sub}",
                        cfg.dataset.dataset_path)
        out.append(loader_cls(imdb, cfg, batch_clips=batch_clips))
    return out


@pytest.mark.parametrize("propagate,scales", [("incremental", None), ("direct", None),
                                              ("direct", [[64, 128]])],
                         ids=["incremental", "direct", "native_gt"])
def test_pred_eval_clips_matches(models, jax_confusion, propagate, scales):
    jmodel, variables, tmodel, path = models
    jl, tl = _loaders(path, scales)
    jmiou, jiou, _ = jpred.pred_eval_clips(jmodel, variables, iter(jl), 19, INTERVAL, propagate)
    seen = []
    miou, iou, stats = tpred.pred_eval_clips(tmodel, iter(tl), 19, INTERVAL, propagate,
                                             on_preds=lambda item, p: seen.append((item, p)))
    assert ("label_native" in next(iter(tl))) == (scales is not None)
    assert stats["frames"] == 4 * INTERVAL and stats["confusion"].shape == (19, 19)
    # on_preds is handed each batch's class maps, the ones that were scored
    assert sum(p.shape[0] * p.shape[1] for _, p in seen) == stats["frames"]
    for item, p in seen:
        assert p.dtype == torch.uint8 and p.shape == item["clip"].shape[:4]
    if scales is None:
        acc = SegConfusionAccumulator(19)
        for item, p in seen:
            acc.update(p, torch.as_tensor(item["label"]))
        np.testing.assert_array_equal(acc.cm, stats["confusion"])
    assert_same_eval(stats["confusion"], jax_confusion[0].cm, miou, jmiou, 2e-3)
    np.testing.assert_allclose(iou, jiou, atol=1e-2)


def test_pred_eval_matches(models, jax_confusion):
    """The per-frame loop (key/cur predictors, incremental + last) on the
    loader's clips, one frame at a time, the annotated frame scored."""
    jmodel, variables, tmodel, path = models
    jl, _ = _loaders(path, batch_clips=1)

    def frames():
        for item in jl:
            for f in range(INTERVAL):
                yield {"data": item["clip"][:, f], "is_key": f == 0,
                       "label": item["label"][:, f] if f == item["ann_pos"] else None}

    jkey, jcur = jpred.make_key_cur_predictors(jmodel, variables, propagate="incremental")
    jmiou, _, jstats = jpred.pred_eval(jkey, jcur, frames(), 19, INTERVAL)
    key, cur = tpred.make_key_cur_predictors(tmodel, propagate="incremental")
    acc = []
    orig = tpred.SegConfusionAccumulator

    class Recording(orig):
        def __init__(self, n):
            super().__init__(n)
            acc.append(self)

    tpred.SegConfusionAccumulator = Recording
    try:
        miou, _, stats = tpred.pred_eval(key, cur, frames(), 19, INTERVAL)
    finally:
        tpred.SegConfusionAccumulator = orig
    assert stats["frames"] == jstats["frames"] == 4 * INTERVAL
    assert_same_eval(acc[0].cm, jax_confusion[0].cm, miou, jmiou, 2e-3)


def _train_jax(path, variables, steps: int):
    """``steps`` pair-objective steps of ``accel_tpu``'s train step from
    ``variables`` on the tree's train split; returns (state, cfg, losses)."""
    from accel_tpu.core.trainer import init_train_state, make_optimizer, make_train_step

    cfg = j_load_config(path)
    model = j_build_model(cfg)
    imdb = JCityscape(cfg.dataset.image_set, f"{cfg.dataset.root_path}/j",
                      cfg.dataset.dataset_path)
    loader = iter(TrainPairLoader(imdb, cfg, seed=0))
    tx, _ = make_optimizer(cfg, 10)
    # fresh device arrays: the step donates its state's buffers
    state = init_train_state(model, jax.tree.map(jnp.asarray, variables), tx)
    step = make_train_step(model, tx, 19, objective="pair",
                           aux_weight=float(cfg.TRAIN.aux_loss_weight))
    losses = []
    for _ in range(steps):
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in next(loader).items()})
        losses.append(float(metrics["loss"]))
    return state, cfg, losses


def test_trained_checkpoint_gives_the_same_miou(models, tree, tmp_path, jax_confusion):
    """Trained from the seeded weights of ``models`` (the same
    architecture; this cfg evaluates direct, as the pair objective
    requires)."""
    jmodel, variables, _, _ = models
    root, data = tree
    path = write_cfg(root, data, "trained", propagate="direct")
    state, cfg, losses = _train_jax(path, variables, steps=12)
    assert losses[-1] < 0.5 * losses[0], losses

    # the JAX checkpoint, with its provenance, restored as a user's would be
    jax_prefix = str(tmp_path / "jax_ckpt")
    jck.save_checkpoint(jax_prefix, 0, jax.device_get(state))
    jck.save_provenance(jax_prefix, jck.provenance_from_cfg(cfg))
    restored = jck.load_checkpoint(jax_prefix, 0, jax.device_get(state))
    # into the port's checkpoint directory for this cfg
    prefix = f"{root}/out/trained/{cfg.dataset.image_set}/{cfg.TRAIN.model_prefix}"
    port_checkpoint_from_jax(restored.variables, prefix, 0)
    save_provenance(prefix, jck.load_provenance(jax_prefix))

    jl, _ = _loaders(path)
    jmiou, _, _ = jpred.pred_eval_clips(jmodel, restored.variables, iter(jl), 19, INTERVAL,
                                        "direct")
    (result,) = t_entry.main(["--cfg", path, "--device", "cpu"])
    assert result["interval"] == INTERVAL and result["ann_offset"] == INTERVAL - 1
    assert jmiou > 0.5, jmiou
    assert_same_eval(result["stats"]["confusion"], jax_confusion[0].cm, result["miou"], jmiou,
                     2e-4)
    # the checkpoint's provenance (pair objective) refuses cascading eval
    with pytest.raises(EvalSemanticsError, match="pair"):
        t_entry.main(["--cfg", path, "--device", "cpu", "--propagate", "incremental"])
