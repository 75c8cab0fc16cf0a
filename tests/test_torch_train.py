"""The port's training against ``accel_tpu``'s: the learning-rate schedule,
two SGD steps of ``core.trainer.make_train_step`` against the JAX package's
``make_train_step(mesh=None)`` for the clip and the pair objectives, the
remat form of the clip objective, and the f32 master weights of a bf16
model.

The models are tiny Accel models (R18 / R18, head 32, f32) built by each
package from one cfg (the flagship defaults: groupnorm, conv7, mean1 scale
field, cascade 'last'), with the same seeded weights, the flow head
rescaled so the largest flow is 3 feature pixels: inside the port's warp
clamp (D=8), where it equals the JAX CPU path's unclamped warp. On 128x128
inputs from a numpy seed, both take two steps. The loss of each step
(the objective's value, ``clip_loss_and_stats`` / ``pair_loss_and_stats``
on the same weights) and every f32 parameter after the two steps agree
within rel 1e-4 (``assert_close``); each parameter's two-step update, a
difference of nearby numbers, within 1e-3 of its largest entry plus 1e-7
(f32 sums taken in another order on the two sides, through two steps of
backward). Two recipes per objective: the cfg's (aux loss 0.5, OHEM off,
no clipping; the clip objective under remat) and a second with aux off,
OHEM 0.25, the global norm clipped and ``FIXED_PARAMS`` set (the clip
objective's batched form).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, nchw, seeded_variables

from accel_tpu.config import load_config as j_load_config
from accel_tpu.core import lr_schedule as jlr
from accel_tpu.core import trainer as jtrainer
from accel_tpu.models.accel import build_model as j_build_model
from accel_tpu_torch.config import load_config
from accel_tpu_torch.convert import load_flax_variables
from accel_tpu_torch.core import lr_schedule as tlr
from accel_tpu_torch.core import pipeline as tpipe
from accel_tpu_torch.core import trainer as ttrainer
from accel_tpu_torch.models.accel import build_model
from accel_tpu_torch.models.resnet import DilatedConv3x3
from accel_tpu_torch.ops.dilated_cuda import pack_dilated_weight

torch.set_num_threads(2)
HW = 128
CFG = """\
network:
  name: accel
  ref_depth: 18
  update_depth: 18
  head_channels: 32
  dtype: {dtype}
  propagate: {propagate}
  FIXED_PARAMS: {fixed}
TRAIN:
  objective: {objective}
  CLIP_LENGTH: 3
  remat: {remat}
  lr: 0.01
  lr_step: "1"
  lr_factor: 0.5
  warmup: true
  warmup_lr: 0.002
  warmup_step: 1
  wd: 0.0005
  aux_loss_weight: {aux}
  ohem_fraction: {ohem}
  grad_clip: {grad_clip}
"""
# the second recipe freezes every norm named bn1 and the fusion conv
# (substrings of the flax paths, as FIXED_PARAMS matches them)
RECIPES = {
    "cfg": dict(aux=0.5, ohem=0.0, grad_clip=0.0, fixed="[]", remat="true"),
    "clip_fixed_ohem": dict(aux=0.0, ohem=0.25, grad_clip=0.5,
                            fixed="[bn1, fusion]",
                            remat="false"),
}


def write_cfg(tmp_path, objective: str, recipe: str, dtype="float32") -> str:
    path = tmp_path / f"{objective}_{recipe}_{dtype}.yaml"
    path.write_text(CFG.format(objective=objective, dtype=dtype,
                               propagate="incremental" if objective == "clip" else "direct",
                               **RECIPES[recipe]))
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Seeded flax variables of the tiny model, the flow head rescaled so
    the port's largest flow between two batch frames is 3 feature pixels."""
    path = write_cfg(tmp_path_factory.mktemp("cfg"), "clip", "cfg")
    jmodel = j_build_model(j_load_config(path))
    cur = jnp.zeros((1, HW, HW, 3))
    variables = seeded_variables(jmodel, cur, cur, jnp.ones((1,)), train=False, seed=21)
    tmodel = build_model(load_config(path), device="cpu",
                         generator=torch.Generator().manual_seed(0))
    load_flax_variables(tmodel, variables)
    clip = torch.from_numpy(batch_arrays("clip")["clip"])
    with torch.no_grad():
        flow, _ = tmodel.flow(nchw(clip[:, 1]), nchw(clip[:, 0]))
    head = variables["params"]["flownet"]["predict_flow2"]
    gain = 3.0 / float(flow.abs().max())
    for name in ("kernel", "bias"):
        head[name] = head[name] * np.float32(gain)
    return variables


def batch_arrays(objective: str) -> dict:
    """A numpy batch of two examples (NHWC frames, int32 labels): a clip of
    3 frames annotated once per clip (frames 1 and 2), or a pair with
    eq_flag [1, 0]."""
    rng = np.random.default_rng(5)
    label = rng.integers(0, 19, (2, HW, HW)).astype(np.int32)
    label[:, :8] = 255
    if objective == "clip":
        clip = (rng.standard_normal((2, 3, HW, HW, 3)) * 0.5).astype(np.float32)
        full = np.full((2, 3, HW, HW), 255, np.int32)
        full[0, 1], full[1, 2] = label[0], label[1]
        return {"clip": clip, "label": full}
    data = (rng.standard_normal((2, HW, HW, 3)) * 0.5).astype(np.float32)
    ref = data.copy()
    ref[1] = np.roll(data[1], 4, axis=1)
    return {"data": data, "data_ref": ref, "eq_flag": np.asarray([1.0, 0.0], np.float32),
            "label": label}


def port_batch(arrays: dict) -> dict:
    """The batch as the port's loaders give it: frames NCHW."""
    return {k: nchw(v) if k in ("clip", "data", "data_ref") else torch.from_numpy(v)
            for k, v in arrays.items()}


def jax_steps(path: str, variables, arrays: dict, steps: int = 2):
    cfg = j_load_config(path)
    model = j_build_model(cfg)
    tx, _ = jtrainer.make_optimizer(cfg, 2)
    state = jtrainer.init_train_state(model, jax.tree.map(jnp.asarray, variables), tx)
    tr = cfg.TRAIN
    step = jtrainer.make_train_step(
        model, tx, 19, mesh=None, ohem_fraction=float(tr.ohem_fraction) or None,
        aux_weight=float(tr.aux_loss_weight), objective=str(tr.objective),
        propagate=str(cfg.network.propagate), remat=bool(tr.remat))
    batch = {k: jnp.asarray(v) for k, v in arrays.items()}
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, jax.device_get(state.variables)


def port_state(path: str, variables, **network):
    """The port's cfg, optimizer and train state from the cfg at ``path``
    (``network`` overriding cfg.network keys) with ``variables``."""
    cfg = load_config(path)
    cfg.network.update(network)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    load_flax_variables(model, variables)
    tx, _ = ttrainer.make_optimizer(cfg, 2, model)
    return cfg, tx, ttrainer.init_train_state(model, tx)


def port_steps(path: str, variables, arrays: dict, steps: int = 2):
    """Two port steps; returns the losses, the state, the optimizer and
    the global norm of each step's gradients."""
    cfg, tx, state = port_state(path, variables)
    norms, update = [], tx.update

    def recording_update(grads, opt_state, params):
        norms.append(float(torch.sqrt(sum((g * g).sum() for g in grads.values()))))
        update(grads, opt_state, params)

    tx.update = recording_update
    tr = cfg.TRAIN
    step = ttrainer.make_train_step(
        tx, 19, ohem_fraction=float(tr.ohem_fraction) or None,
        aux_weight=float(tr.aux_loss_weight), objective=str(tr.objective),
        propagate=str(cfg.network.propagate), remat=bool(tr.remat))
    batch = port_batch(arrays)
    losses = []
    for _ in range(steps):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return losses, state, tx, norms


def test_lr_schedule_matches_jax():
    """The same f32 rate at every step from 0 to 3x warmup, across the
    warmup's end and each decay boundary, with and without warmup."""
    steps = tlr.lr_steps_from_epochs("1.5,2.25, 3", 40, begin_epoch=1)
    assert steps == jlr.lr_steps_from_epochs("1.5,2.25, 3", 40, begin_epoch=1) == [60, 90, 120]
    for warmup in (True, False):
        args = dict(base_lr=5e-4, steps=steps, factor=0.1, warmup=warmup, warmup_lr=5e-5,
                    warmup_steps=50)
        ours, ref = tlr.warmup_multifactor_schedule(**args), jlr.warmup_multifactor_schedule(**args)
        for s in range(0, 3 * 50 + 1):
            assert abs(ours(s) - float(ref(s))) <= 1e-12, (warmup, s, ours(s), float(ref(s)))


@pytest.mark.parametrize("objective,recipe", [("clip", "cfg"), ("clip", "clip_fixed_ohem"),
                                              ("pair", "cfg"), ("pair", "clip_fixed_ohem")])
def test_two_sgd_steps_match_jax(weights, tmp_path, objective, recipe):
    path = write_cfg(tmp_path, objective, recipe)
    arrays = batch_arrays(objective)
    want_losses, want = jax_steps(path, weights, arrays)
    losses, state, tx, norms = port_steps(path, weights, arrays)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert losses[1] != losses[0]
    # the second recipe's clip is active at both steps
    assert min(norms) > 2 * tx.grad_clip

    ref_after = ttrainer_state_dict(want)
    ref_before = ttrainer_state_dict(weights)
    paths = ttrainer.flax_param_paths(state.model)
    assert set(state.master) == set(paths)
    frozen = 0
    for name, p in state.master.items():
        assert_close(p.numpy(), ref_after[name], rel=1e-4)
        delta = p.numpy() - ref_before[name]
        ref_delta = ref_after[name] - ref_before[name]
        if name in tx.frozen:
            frozen += 1
            assert not delta.any() and not ref_delta.any(), name
            continue
        err = float(np.abs(delta - ref_delta).max())
        assert err <= 1e-3 * float(np.abs(ref_delta).max()) + 1e-7, (name, err)
    if recipe == "cfg":
        assert frozen == 0
    else:
        want_frozen = {n for n, path in paths.items() if "bn1" in path or "fusion" in path}
        assert tx.frozen == want_frozen and frozen == len(want_frozen) > 2


def ttrainer_state_dict(variables) -> dict:
    """flax variables -> the port's state_dict as numpy."""
    from accel_tpu_torch.convert import flax_to_torch

    return {k: v.numpy() for k, v in flax_to_torch(jax.device_get(variables)).items()}


@pytest.mark.parametrize("propagate", ["incremental", "direct", "composed"])
def test_remat_matches_the_batched_form(weights, tmp_path, propagate):
    """``clip_loss_and_stats(remat=True)`` (the sequential step, each
    frame's work under ``torch.utils.checkpoint``) gives the loss and the
    gradients of the batched form (``accel_tpu``'s remat test)."""
    _, _, state = port_state(write_cfg(tmp_path, "clip", "cfg"), weights)
    model = state.model
    batch = port_batch(batch_arrays("clip"))
    out = []
    for remat in (False, True):
        model.zero_grad(set_to_none=True)
        loss, _ = tpipe.clip_loss_and_stats(model, batch, 19, propagate=propagate,
                                            aux_weight=0.5, remat=remat)
        loss.backward()
        out.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    (l0, g0), (l1, g1) = out
    assert abs(l0 - l1) <= 1e-6 * abs(l0)
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], rtol=1e-4, atol=1e-6)


def test_bf16_model_takes_the_rounded_master_weights(weights, tmp_path):
    """After a step, each bf16 weight is its f32 master rounded once, and
    the dilated convs' packed-weight caches hold the packing of the new
    weights: the trainer writes with ``copy_``, which bumps the versions
    the caches key on (a write through ``.data`` does not, and the cache
    would keep the first step's packing)."""
    path = write_cfg(tmp_path, "pair", "cfg", dtype="bfloat16")
    cfg, tx, state = port_state(path, weights, dilated_conv="pallas")
    model = state.model
    convs = [m for m in model.modules() if isinstance(m, DilatedConv3x3)]
    assert len(convs) == 5 + 5 and any(p.dtype == torch.bfloat16 for p in model.parameters())
    before = [m.packed_weight().clone() for m in convs]
    step = ttrainer.make_train_step(tx, 19, aux_weight=0.5, objective="pair")
    state, metrics = step(state, port_batch(batch_arrays("pair")))
    assert np.isfinite(float(metrics["loss"]))
    for name, p in model.named_parameters():
        assert torch.equal(p, state.master[name].to(p.dtype)), name
    for m, old in zip(convs, before):
        assert torch.equal(m.packed_weight(), pack_dilated_weight(m.weight))
        assert not torch.equal(m.packed_weight(), old)
    # the trap the trainer avoids
    m = convs[0]
    packed = m.packed_weight()
    m.weight.data.copy_(m.weight.data * 2)
    assert m.packed_weight() is packed
