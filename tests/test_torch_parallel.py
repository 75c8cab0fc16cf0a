"""Data parallelism (``accel_tpu_torch/parallel/mesh.py``) against the JAX
package's mesh, on the CPU.

One spawn of two gloo ranks (``torch_dp_worker.py``, a ``file://``
rendezvous under the test's temporary directory) runs every case of this
file and hands back its results; the JAX side runs here meanwhile, on the
8-device virtual CPU mesh of ``conftest.py``.

- Train steps: a tiny f32 Accel model (R18 / R18, head 32), the same
  seeded weights in both packages (the flow head rescaled so the largest
  flow stays inside the port's warp clamp), a global batch of two split
  1 + 1 over the ranks, against ``accel_tpu``'s ``make_train_step(mesh=
  make_mesh(data=2))`` on the whole batch: the pair objective with
  frozenbn; with ``norm: batchnorm`` (``mutable_stats``) and OHEM 0.25;
  and the clip objective, incremental, with remat and aux 0.5. The losses
  and the updated masters (and the running statistics) within rel 1e-4,
  the SGD-step tolerance of ``test_torch_train.py``; the two ranks'
  masters bit-equal.
- Uneven valid pixels: the batchnorm pair step on a batch whose first row
  (rank 0's) holds every labelled pixel and whose second (rank 1's) none,
  against the one-process port step. An average of per-rank means halves
  it; statistics reduced without their gradient lose rank 1's share of the
  gradient, which reaches rank 1's inputs only through them.
- A group of one rank: the step through the all-reduce is bit-equal to the
  step with no group.
- Sharded eval: ``pred_eval_clips`` on two ranks gives the one-process
  confusion matrix exactly and the JAX ``pred_eval_clips(mesh=
  make_mesh(data=2))`` mIoU within 1e-3; the eval entry point under
  ``torchrun``'s variables with ``TEST.BATCH_IMAGES: 3`` warns, splits over
  gcd(3, 2) = 1 rank and gives the one-process result.
- int8 on the data axis: a tiny f32 int8 Accel's ``clip_logits`` on each
  rank's clips under the world's scale group against the one-process port
  on the global batch (every int8 call's scale equal, logits within 1e-4
  * (1 + max)), for a batch of one chunk and for B=12 x 5 frames, whose
  chunks of 20 straddle the ranks, and together against ``jax.jit(
  clip_logits)`` on ``make_mesh(data=2)``; a clamped split's eval (one
  clip a batch: rank 1 runs stand-ins) gives the one-process confusion.
- The train entry point under ``torchrun``'s variables: an epoch of the
  clip cfg on a tree (global batch 2, one row a rank, the loaders' rows of
  the one-process batches) gives the one-process entry point's masters
  within the SGD-step tolerance, bit-equal on both ranks; only rank 0
  writes the metrics and the checkpoint.
- In this process: the refusals of ``mesh_from_cfg``, ``batch_rows``,
  ``shard_batch`` and the train loaders' rows of the global batch.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (Ranks, assert_close, bridged_models, free_port, nchw, nhwc,
                          seeded_variables, write_cityscapes_tree)

from accel_tpu.config import load_config as j_load_config
from accel_tpu.core import pipeline as jpipe
from accel_tpu.core import predictor as jpred
from accel_tpu.core import trainer as jtrainer
from accel_tpu.models.accel import build_model as j_build_model
from accel_tpu.parallel.mesh import batch_sharding, make_mesh, replicated, shard_batch
from accel_tpu_torch.config import load_config
from accel_tpu_torch.convert import flax_to_torch, load_flax_variables
from accel_tpu_torch.core import predictor as tpred
from accel_tpu_torch.core import trainer as ttrainer
from accel_tpu_torch.data import loader as tloader
from accel_tpu_torch.data.cityscapes import Cityscape
from accel_tpu_torch.core import checkpoint as tck
from accel_tpu_torch.core import pipeline as tpipe
from accel_tpu_torch.ops import quant
from accel_tpu_torch.experiments import test as t_entry
from accel_tpu_torch.experiments import train as t_train
from accel_tpu_torch.models.accel import build_model
from accel_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)
HW = 128
CFG = """\
network:
  name: accel
  ref_depth: 18
  update_depth: 18
  head_channels: 32
  dtype: float32
  norm: {norm}
  propagate: {propagate}
TRAIN:
  objective: {objective}
  CLIP_LENGTH: 3
  BATCH_IMAGES: 2
  remat: {remat}
  lr: 0.01
  lr_step: "1"
  lr_factor: 0.5
  warmup: false
  wd: 0.0005
  aux_loss_weight: 0.5
  ohem_fraction: {ohem}
TEST:
  KEY_FRAME_INTERVAL: 3
"""
CASES = {
    "pair_frozenbn": dict(objective="pair", norm="frozenbn", ohem=0.0, remat="false"),
    "pair_batchnorm_ohem": dict(objective="pair", norm="batchnorm", ohem=0.25, remat="false"),
    "clip_remat": dict(objective="clip", norm="groupnorm", ohem=0.0, remat="true"),
}
# the uneven batch: the batchnorm pair model's step without OHEM
UNEVEN = dict(objective="pair", norm="batchnorm", ohem=0.0, remat="false")
EVAL_BATCHES, EVAL_B = 2, 2
# a tiny f32 int8 Accel on 64x64 frames (FlowNet at input downscale 1 and a
# quarter of its width), incremental, k=5, and its global clip batches: 10
# frames (one chunk over both ranks) and B=12 (60 frames, chunks of 20 of
# which the second straddles the ranks: frames 20-29 on rank 0, 30-39 on 1)
INT8 = dict(family="accel", ref_depth=18, update_depth=18, head_channels=32,
            quantize_ref=True, quantize_update=True, flow_input_downscale=1,
            flow_width_mult=0.25)
INT8_HW, INT8_K = 64, 5
INT8_CLIPS = {"one_chunk": 2, "straddling_chunks": 12}
# the int8 model against the JAX package at ``test_torch_quant.py``'s
# end-to-end tolerance: logits within a relative L2 error of 5e-2, class
# maps on >= 0.95 of the pixels
INT8_REL_L2, INT8_AGREE = 5e-2, 0.95


def write_cfg(root: Path, name: str, objective, norm, ohem, remat) -> str:
    path = root / f"{name}.yaml"
    path.write_text(CFG.format(objective=objective, norm=norm, ohem=ohem, remat=remat,
                               propagate="incremental" if objective == "clip" else "direct"))
    return str(path)


def batch_arrays(objective: str, seed: int, uneven: bool = False) -> dict:
    """A global numpy batch of two (NHWC frames, int32 labels): a clip of 3
    frames annotated once (frames 1 and 2), or a pair with eq_flag [1, 0].
    ``uneven``: every labelled pixel in the first row."""
    rng = np.random.default_rng(seed)
    label = rng.integers(0, 19, (2, HW, HW)).astype(np.int32)
    label[:, :8] = 255
    if uneven:
        label[1] = 255
    if objective == "clip":
        full = np.full((2, 3, HW, HW), 255, np.int32)
        full[0, 1], full[1, 2] = label[0], label[1]
        return {"clip": (rng.standard_normal((2, 3, HW, HW, 3)) * 0.5).astype(np.float32),
                "label": full}
    data = (rng.standard_normal((2, HW, HW, 3)) * 0.5).astype(np.float32)
    ref = data.copy()
    ref[1] = np.roll(data[1], 4, axis=1)
    return {"data": data, "data_ref": ref, "eq_flag": np.asarray([1.0, 0.0], np.float32),
            "label": label}


def port_batch(arrays: dict) -> dict:
    return {k: nchw(v) if k in ("clip", "data", "data_ref") else torch.from_numpy(v)
            for k, v in arrays.items()}


def weights(path: str, arrays: dict, seed: int):
    """Seeded flax variables of the cfg's model, the flow head rescaled so
    the port's largest flow on the batch is 3 feature pixels, and the port
    model holding them."""
    jmodel = j_build_model(j_load_config(path))
    cur = jnp.zeros((1, HW, HW, 3))
    variables = seeded_variables(jmodel, cur, cur, jnp.ones((1,)), train=False, seed=seed)
    model = build_model(load_config(path), device="cpu", generator=torch.Generator().manual_seed(0))
    load_flax_variables(model, variables)
    frames = arrays["clip"][:, :2] if "clip" in arrays else np.stack(
        [arrays["data_ref"], arrays["data"]], 1)
    with torch.no_grad():
        flow, _ = model.flow(nchw(frames[:, 1]), nchw(frames[:, 0]))
    head = variables["params"]["flownet"]["predict_flow2"]
    gain = np.float32(3.0 / float(flow.abs().max()))
    head["kernel"], head["bias"] = head["kernel"] * gain, head["bias"] * gain
    load_flax_variables(model, variables)
    return jmodel, variables, model


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Writes every case, starts the two ranks and returns what the JAX
    side and the checks need: {'train': {name: (path, variables, arrays,
    jmodel)} (``CASES`` and 'uneven'), 'eval', 'entry', 'train_entry',
    'ranks'}."""
    root = tmp_path_factory.mktemp("dp")
    train, spec_train = {}, []
    for i, (name, knobs) in enumerate(CASES.items()):
        path = write_cfg(root, name, **knobs)
        arrays = batch_arrays(knobs["objective"], seed=30 + i)
        jmodel, variables, model = weights(path, arrays, seed=40 + i)
        train[name] = (path, variables, arrays, jmodel)
        spec_train.append({"name": name, "cfg": path, "state_dict": model.state_dict(),
                           "batch": port_batch(arrays), "steps": 1})
    # the uneven batch on the batchnorm model's weights, without OHEM
    path = write_cfg(root, "uneven", **UNEVEN)
    arrays = batch_arrays("pair", seed=35, uneven=True)
    bn = spec_train[list(CASES).index("pair_batchnorm_ohem")]
    train["uneven"] = (path, None, arrays, None)
    spec_train.append({"name": "uneven", "cfg": path, "state_dict": bn["state_dict"],
                       "batch": port_batch(arrays), "steps": 1})

    # eval: the clip case's model on global batches of two 3-frame clips
    path, variables, _, jmodel = train["clip_remat"]
    rng = np.random.default_rng(60)
    items = []
    for _ in range(EVAL_BATCHES):
        label = np.full((EVAL_B, 3, HW, HW), 255, np.int32)
        label[:, 2] = rng.integers(0, 19, (EVAL_B, HW, HW))
        items.append({"clip": (rng.standard_normal((EVAL_B, 3, HW, HW, 3)) * 0.5)
                      .astype(np.float32), "label": label})
    clip_case = spec_train[list(CASES).index("clip_remat")]
    eval_spec = {"cfg": path, "state_dict": clip_case["state_dict"], "items": items}

    # the eval entry point on a tree, TEST.BATCH_IMAGES 3 over 2 ranks
    data = write_cityscapes_tree(root, HW, 2 * HW, snippets=2, seed=61)
    entry_cfg = root / "entry.yaml"
    entry_cfg.write_text(
        CFG.format(objective="clip", norm="groupnorm", ohem=0.0, remat="false",
                   propagate="incremental").replace("  BATCH_IMAGES: 2\n", "")
        .replace("TEST:\n", "TEST:\n  BATCH_IMAGES: 3\n")
        + f"output_path: {root / 'out'}\nSCALES: [[{HW}, {2 * HW}]]\n"
        + f"dataset:\n  dataset: CityScape\n  dataset_path: {data}\n"
        + f"  root_path: {root / 'entry'}\n  test_image_set: leftImg8bit_val\n")
    entry_argv = ["--cfg", str(entry_cfg), "--device", "cpu", "--random-weights",
                  "--max-items", "3"]

    # the train entry point: the clip cfg, one epoch of 2 steps on a train tree
    train_data = write_cityscapes_tree(root / "train_tree", HW, 2 * HW, snippets=2, seed=63,
                                       split="train")
    train_text = (CFG.format(objective="clip", norm="groupnorm", ohem=0.0, remat="false",
                             propagate="incremental")
                  + f"output_path: {root / 'out'}\nSCALES: [[{HW}, {2 * HW}]]\n"
                  + f"dataset:\n  dataset: CityScape\n  dataset_path: {train_data}\n"
                  + f"  root_path: {root / 'train_root'}\n  image_set: leftImg8bit_train\n")
    train_text = train_text.replace("TRAIN:\n", "TRAIN:\n  CROP_SIZE: [128, 128]\n"
                                    "  end_epoch: 1\n  model_prefix: tiny\n")
    train_cfgs = {}
    for name in ("train_dp", "train_one"):
        train_cfgs[name] = root / f"{name}.yaml"
        train_cfgs[name].write_text(train_text)

    # the int8 model: global clip batches and, for the clamped split, two
    # one-clip eval batches
    jm8, variables8, tm8 = bridged_models(INT8, INT8_HW, seed=70)
    rng = np.random.default_rng(71)
    int8_clips = {name: (rng.standard_normal((b, INT8_K, INT8_HW, INT8_HW, 3)) * 0.5)
                  .astype(np.float32) for name, b in INT8_CLIPS.items()}
    first = int8_clips["one_chunk"]
    with torch.no_grad():
        flow, _ = tm8.flow(nchw(first[:, 1]), nchw(first[:, 0]))
    head = variables8["params"]["flownet"]["predict_flow2"]
    gain = np.float32(3.0 / float(flow.abs().max()))
    head["kernel"], head["bias"] = head["kernel"] * gain, head["bias"] * gain
    load_flax_variables(tm8, variables8)
    int8_items = []
    for _ in range(2):
        label = np.full((1, INT8_K, INT8_HW, INT8_HW), 255, np.int32)
        label[:, INT8_K - 1] = rng.integers(0, 19, (1, INT8_HW, INT8_HW))
        int8_items.append({"clip": (rng.standard_normal((1, INT8_K, INT8_HW, INT8_HW, 3)) * 0.5)
                           .astype(np.float32), "label": label})
    int8_spec = {"knobs": INT8, "state_dict": tm8.eval().state_dict(),
                 "clips": {k: torch.from_numpy(v) for k, v in int8_clips.items()},
                 "items": int8_items, "interval": INT8_K, "propagate": "incremental"}

    spec_path = root / "spec.pt"
    torch.save({"init": f"file://{root / 'rendezvous'}", "train": spec_train,
                "subgroup": spec_train[0], "eval": eval_spec, "int8": int8_spec,
                "entry": {"argv": entry_argv, "port": free_port()},
                "train_entry": {"argv": ["--cfg", str(train_cfgs["train_dp"]), "--device", "cpu",
                                         "--frequent", "1"], "port": free_port()}}, spec_path)
    ranks = Ranks(spec_path)
    try:
        yield {"train": train, "eval": (jmodel, variables, items, eval_spec),
               "entry": (entry_cfg, entry_argv), "train_entry": train_cfgs, "ranks": ranks,
               "int8": (jm8, variables8, tm8, int8_clips, int8_items)}
    finally:
        ranks.close()


def assert_update_close(after: dict, before: dict, want_after: dict, rel: float = 1e-3) -> None:
    """Each parameter's update (after - before) within ``rel`` of the
    reference update's largest entry plus 1e-7: the SGD step's own
    tolerance in ``test_torch_train.py``, tight where the weights are not."""
    for key, p in after.items():
        delta = p.numpy() - before[key].numpy()
        ref = want_after[key].numpy() - before[key].numpy()
        err = float(np.abs(delta - ref).max())
        assert err <= rel * float(np.abs(ref).max()) + 1e-7, (key, err)


@pytest.fixture(scope="module")
def jax_refs(dp):
    """Every JAX reference, computed while the ranks run: each case's mesh
    step and the eval's mIoU over a mesh of two."""
    steps = {name: jax_mesh_step(*dp["train"][name][:3]) for name in CASES}
    jmodel, variables, items, _ = dp["eval"]
    jmiou, _, jstats = jpred.pred_eval_clips(jmodel, variables, iter(items), 19, 3, "direct",
                                              mesh=make_mesh(data=2))
    # the int8 model's clip_logits under jit on the global batch split over the data axis
    jm8, variables8, _, clips, _ = dp["int8"]
    mesh = make_mesh(data=2)
    run = jax.jit(lambda v, c: jpipe.clip_logits(jm8, v, c, INT8_K, "incremental"))
    v8 = jax.device_put(variables8, replicated(mesh))
    int8 = {name: np.asarray(run(v8, jax.device_put(jnp.asarray(clip), batch_sharding(mesh))))
            for name, clip in clips.items()}
    return steps, (jmiou, jstats), int8


def jax_mesh_step(path: str, variables, arrays: dict):
    """One step of ``accel_tpu``'s ``make_train_step`` over a mesh of two
    on the global batch: (loss, variables after)."""
    cfg = j_load_config(path)
    model = j_build_model(cfg)
    tx, _ = jtrainer.make_optimizer(cfg, 2)
    mesh = make_mesh(data=2)
    # a copy: the step donates its state
    state = jtrainer.init_train_state(model, jax.tree.map(jnp.array, variables), tx)
    state = jax.device_put(state, replicated(mesh))
    tr = cfg.TRAIN
    step = jtrainer.make_train_step(
        model, tx, 19, mesh=mesh, ohem_fraction=float(tr.ohem_fraction) or None,
        aux_weight=float(tr.aux_loss_weight), objective=str(tr.objective),
        propagate=str(cfg.network.propagate), remat=bool(tr.remat))
    state, metrics = step(state, shard_batch(mesh, {k: jnp.asarray(v) for k, v in arrays.items()}))
    return float(metrics["loss"]), flax_to_torch(jax.device_get(state.variables))


@pytest.mark.parametrize("name", list(CASES))
def test_dp_train_step_matches_the_jax_mesh(dp, jax_refs, name):
    variables = dp["train"][name][1]
    want_loss, want = jax_refs[0][name]
    ranks = dp["ranks"].results()
    assert ranks[0]["backend"] == "gloo"
    for r, out in enumerate(ranks):
        got = out[name]
        assert got["rows"] == 1 and got["masters_equal_rank0"], (r, name)
        np.testing.assert_allclose(got["losses"][0], want_loss, rtol=1e-4)
    got = ranks[0][name]
    assert set(got["master"]) <= set(want)
    for key, p in got["master"].items():
        assert_close(p.numpy(), want[key].numpy())
    assert_update_close(got["master"], flax_to_torch(variables), want)
    assert bool(got["stats"]) == (name == "pair_batchnorm_ohem")
    for key, value in got["stats"].items():
        assert torch.equal(value, ranks[1][name]["stats"][key]), key
        assert_close(value.numpy(), want[key].numpy())


def test_uneven_valid_pixels_match_the_one_process_step(dp):
    """Rank 0 holds every labelled pixel, rank 1 none; the two-rank step
    against the one-process port step on the whole batch."""
    path, _, arrays, _ = dp["train"]["uneven"]
    spec = torch.load(dp["ranks"].spec_path, weights_only=False)
    case = next(c for c in spec["train"] if c["name"] == "uneven")
    cfg = load_config(path)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(case["state_dict"])
    tx, _ = ttrainer.make_optimizer(cfg, 2, model)
    state = ttrainer.init_train_state(model, tx)
    step = ttrainer.make_train_step(tx, 19, aux_weight=0.5, objective="pair")
    state, metrics = step(state, port_batch(arrays))
    ranks = dp["ranks"].results()
    assert all(out["uneven"]["masters_equal_rank0"] for out in ranks)
    got = ranks[0]["uneven"]
    np.testing.assert_allclose(got["losses"][0], float(metrics["loss"]), rtol=1e-4)
    assert_update_close(got["master"], case["state_dict"], state.master)
    stats = {k: v for k, v in model.state_dict().items() if k.endswith(("_mean", "_var"))}
    assert stats and stats.keys() == got["stats"].keys()
    for key, value in stats.items():
        assert_close(got["stats"][key].numpy(), value.numpy())


def test_a_group_of_one_is_bit_equal_to_no_group(dp):
    out = dp["ranks"].results()[0]["subgroup"]
    assert out["group"]["losses"] == out["none"]["losses"]
    for key, p in out["none"]["master"].items():
        assert torch.equal(out["group"]["master"][key], p), key


def test_sharded_eval_gives_the_one_process_confusion(dp, jax_refs):
    _, _, items, spec = dp["eval"]
    jmiou, jstats = jax_refs[1]
    model = build_model(load_config(spec["cfg"]), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    model.load_state_dict(spec["state_dict"])
    miou, _, stats = tpred.pred_eval_clips(model, iter(items), 19, 3, "direct")
    for out in dp["ranks"].results():
        got = out["eval"]
        np.testing.assert_array_equal(got["stats"]["confusion"], stats["confusion"])
        assert got["miou"] == miou and got["stats"]["frames"] == stats["frames"] == 12
    assert jstats["frames"] == 12 and abs(miou - jmiou) <= 1e-3, (miou, jmiou)


@pytest.mark.parametrize("name", list(INT8_CLIPS))
def test_int8_scales_are_the_global_calls(dp, jax_refs, name):
    """Each rank's int8 ``clip_logits`` on its clips of the global batch
    against the one-process port on the whole batch: every int8 call's
    activation scale equal on both ranks and to the one process's (the
    max over every frame of the call, as the reference's ``jit`` takes
    it), and the logits within 1e-4 * (1 + max) (a scale over the rank's
    frames alone moves them by ~7e-2 of their norm); the ranks' logits
    together against ``jax.jit(clip_logits)`` on ``make_mesh(data=2)``."""
    _, _, tm, clips, _ = dp["int8"]
    clip = nchw(clips[name])
    with quant.scales_recorded() as one_scales:
        one = tpipe.clip_logits(tm, clip, INT8_K, "incremental")
    ranks = dp["ranks"].results()
    half = len(clip) // 2
    for r, out in enumerate(ranks):
        got = out["int8"][name]
        assert len(got["scales"]) == len(one_scales) > 0
        assert all(map(torch.equal, got["scales"], one_scales)), r
        assert_close(got["logits"].numpy(), one[r * half:(r + 1) * half].numpy())
    port = nhwc(torch.cat([out["int8"][name]["logits"] for out in ranks]))
    want = jax_refs[2][name]
    assert port.shape == want.shape
    assert np.linalg.norm(port - want) <= INT8_REL_L2 * np.linalg.norm(want)
    assert (port.argmax(-1) == want.argmax(-1)).mean() >= INT8_AGREE


def test_int8_clamped_split_gives_the_one_process_confusion(dp):
    """One-clip batches over two ranks (``TEST.BATCH_IMAGES: 1``, clamped):
    rank 1 holds no rows and runs stand-ins that meet rank 0's scale
    all-reduces; both finish with the one-process confusion matrix."""
    _, _, tm, _, items = dp["int8"]
    miou, _, stats = tpred.pred_eval_clips(tm, iter(items), 19, INT8_K, "incremental")
    for r, out in enumerate(dp["ranks"].results()):
        got = out["int8"]["clamped_eval"]
        assert got["rows"] == (1 if r == 0 else 0)
        np.testing.assert_array_equal(got["stats"]["confusion"], stats["confusion"])
        assert got["miou"] == miou and got["stats"]["frames"] == stats["frames"] == 2 * INT8_K


def test_eval_entry_point_splits_an_indivisible_batch_over_the_gcd(dp):
    """``TEST.BATCH_IMAGES: 3`` on two ranks: rank 0 logs the warning and
    runs every clip, rank 1 idles and joins the reductions; both return
    the one-process result."""
    cfg_path, argv = dp["entry"]
    (want,) = t_entry.main(argv)
    ranks = dp["ranks"].results()
    for out in ranks:
        got = out["entry"]
        np.testing.assert_array_equal(got["stats"]["confusion"], want["stats"]["confusion"])
        assert got["miou"] == want["miou"] and got["stats"]["frames"] == 9
    logs = list((cfg_path.parent / "out" / "entry" / "leftImg8bit_val").glob("*.log"))
    text = "".join(p.read_text() for p in logs)
    assert "TEST.BATCH_IMAGES=3 not divisible by the 2 ranks; splitting each batch over 1" in text


def test_mesh_refusals_and_rows(tmp_path):
    path = write_cfg(tmp_path, "m", **CASES["clip_remat"])
    cfg = load_config(path)
    cfg.tpu.mesh.spatial = 2
    with pytest.raises(ValueError, match="tpu.mesh.spatial=2 does not divide the world of 1 "):
        tmesh.mesh_from_cfg(cfg, device="cpu")
    cfg.tpu.mesh.spatial = 3
    with pytest.raises(ValueError, match="tpu.mesh.spatial=3 does not divide the world of 2 "):
        tmesh.mesh_from_cfg(cfg, device="cpu", init_method=f"file://{tmp_path / 'x'}", rank=0,
                            world_size=2)
    # the train entry point and the train step take the spatial axis
    # (``test_torch_spatial_train.py`` runs both on two ranks against one
    # process): in one process the entry point stops only at the mesh, whose
    # two spatial ranks need a world of two, and the step is built
    spatial_cfg = tmp_path / "spatial.yaml"
    spatial_cfg.write_text(Path(path).read_text() + "tpu:\n  mesh:\n    spatial: 2\n")
    with pytest.raises(ValueError, match="tpu.mesh.spatial=2 does not divide the world of 1 "):
        t_train.main(["--cfg", str(spatial_cfg), "--device", "cpu"])
    split = tmesh.Mesh(data=1, spatial=2, rank=0, local_rank=0, device=torch.device("cpu"))
    assert callable(ttrainer.make_train_step(None, 19, mesh=split))
    assert split.loss_group is None and tmesh.Mesh(
        data=1, spatial=2, rank=0, local_rank=0, device=torch.device("cpu"),
        group="world").loss_group == "world"
    cfg.tpu.mesh.spatial, cfg.tpu.mesh.data = 1, 4
    with pytest.raises(ValueError, match="tpu.mesh.data=4 but the world has 2 ranks"):
        tmesh.mesh_from_cfg(cfg, device="cpu", init_method=f"file://{tmp_path / 'x'}", rank=0,
                            world_size=2)
    cfg.tpu.mesh.data = -1
    one = tmesh.mesh_from_cfg(cfg, device="cpu")
    assert (one.data, one.rank, one.group, one.loss_group) == (1, 0, None, None)
    assert tmesh.batch_rows(one, 3) == slice(0, 3)
    ranks = [tmesh.Mesh(data=2, spatial=1, rank=r, local_rank=r, device=torch.device("cpu"))
             for r in range(2)]
    assert [tmesh.batch_rows(m, 4) for m in ranks] == [slice(0, 2), slice(2, 4)]
    with pytest.raises(ValueError, match="batch 3 does not divide by the 2 ranks"):
        tmesh.batch_rows(ranks[0], 3)
    assert [tmesh.batch_rows(m, 3, clamp=True) for m in ranks] == [slice(0, 3), slice(0, 0)]
    # data x spatial: the rows go by data index, rank r = data index * spatial + spatial index
    grid = [tmesh.Mesh(data=2, spatial=2, rank=r, local_rank=r, device=torch.device("cpu"))
            for r in range(4)]
    assert [(m.data_index, m.spatial_index) for m in grid] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [tmesh.batch_rows(m, 4) for m in grid] == [slice(0, 2)] * 2 + [slice(2, 4)] * 2
    assert [tmesh.batch_rows(m, 3, clamp=True) for m in grid] == [slice(0, 3)] * 2 + [
        slice(0, 0)] * 2
    # cards: gpus lists one for each local rank, else every card in turn
    def cards(gpus: str, world: int) -> list[int]:
        return [tmesh._device({"gpus": gpus}, r, world, None).index for r in range(world)]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "device_count", lambda: 4)
        assert cards("0", 1) == [0] and cards("0", 4) == [0, 1, 2, 3]
        assert cards("2,3", 2) == [2, 3] and cards("1,7", 2) == [0, 1]
        mp.setattr(torch.cuda, "device_count", lambda: 1)
        assert cards("0", 2) == [0, 0]
    assert tmesh._device({"gpus": "0"}, 1, 2, "cpu").type == "cpu"
    batch = {"clip": torch.arange(4 * 2).reshape(4, 2), "label": np.arange(4), "ann_pos": 2,
             "label_native": [None, "a", None, "b"]}
    half = tmesh.shard_batch(ranks[1], batch)
    assert half["clip"].tolist() == [[4, 5], [6, 7]] and half["label"].tolist() == [2, 3]
    assert half["ann_pos"] == 2 and half["label_native"] == [None, "b"]


@pytest.mark.parametrize("objective", ["pair", "clip"])
def test_train_loader_rows_are_the_global_batch_rows(tmp_path, objective):
    """Each rank's loader (``rows``) yields its rows of the batches the
    one-process loader with the same seed yields."""
    data = write_cityscapes_tree(tmp_path, HW, 2 * HW, snippets=2, seed=62, split="train")
    path = tmp_path / "rows.yaml"
    path.write_text(CFG.format(objective=objective, norm="groupnorm", ohem=0.0, remat="false",
                               propagate="direct")
                    + f"SCALES: [[{HW}, {2 * HW}]]\ndataset:\n  dataset: CityScape\n"
                    + f"  dataset_path: {data}\n  root_path: {tmp_path}\n"
                    + "  image_set: leftImg8bit_train\n")
    cfg = load_config(str(path))
    cfg.TRAIN.CROP_SIZE, cfg.TRAIN.FLIP = [HW, HW], True
    imdb = Cityscape(cfg.dataset.image_set, str(tmp_path / "c"), str(data))
    cls = tloader.TrainClipLoader if objective == "clip" else tloader.TrainPairLoader
    whole = cls(imdb, cfg, seed=3)
    parts = [cls(imdb, cfg, seed=3, rows=slice(r, r + 1)) for r in range(2)]
    for _, batch, *halves in zip(range(3), whole, *parts):
        for r, half in enumerate(halves):
            assert half.keys() == batch.keys()
            for key, value in batch.items():
                assert torch.equal(half[key], value[r:r + 1]), (r, key)


def test_train_entry_point_under_torchrun_matches_one_process(dp):
    cfgs = dp["train_entry"]
    want = t_train.main(["--cfg", str(cfgs["train_one"]), "--device", "cpu", "--frequent", "1"])
    start = build_model(load_config(str(cfgs["train_one"])), device="cpu",
                        generator=torch.Generator().manual_seed(0)).state_dict()
    ranks = dp["ranks"].results()
    got = [out["train_entry"] for out in ranks]
    assert want.step == got[0]["step"] == got[1]["step"] == 2
    for key, p in got[0]["master"].items():
        assert torch.equal(p, got[1]["master"][key]), key
    assert_update_close(got[0]["master"], start, want.master)
    out = cfgs["train_dp"].parent / "out"
    rows = (out / "train_dp" / "leftImg8bit_train" / "metrics.jsonl").read_text().splitlines()
    want_rows = (out / "train_one" / "leftImg8bit_train" / "metrics.jsonl").read_text()
    assert len(rows) == 2 == len(want_rows.splitlines())
    prefix = out / "train_dp" / "leftImg8bit_train" / "tiny"
    assert tck.saved_epochs(str(prefix)) == [0]
    ckpt = tck.load_checkpoint(str(prefix), 0)
    for key, p in got[0]["master"].items():
        assert torch.equal(ckpt["model"][key], p), key
