"""The port's s2d stem and running-stat BatchNorm against ``accel_tpu``'s.

s2d: ``space_to_depth`` and ``embed_conv7_as_s2d`` equal the JAX ones
exactly (the layout bridged: NCHW/OIHW here); a tiny R18 with ``stem: s2d``
holds its own seeded weights against JAX's, and, with its ``conv1_s2d``
embedded from a conv7 stem, equals the conv7 model on both sides.

BatchNorm: the port's ``BatchNorm`` (flax's ``nn.BatchNorm(momentum=0.9,
epsilon=1e-5)``, not ``nn.BatchNorm2d``) in eval and train mode against
flax's, outputs and updated running statistics; a tiny R18 with ``norm:
batchnorm`` in eval; and two SGD steps of the pair objective (aux loss 0.5,
whose auxiliary passes read the running statistics the step started from)
of a tiny Accel model against ``accel_tpu``'s ``make_train_step``, which
threads ``batch_stats`` (``mutable_stats`` auto-detected on both sides);
a training checkpoint then holds the running statistics.

f32 outputs and statistics agree within 1e-5 * (1 + max|ref|) for single
layers and 1e-4 for models and train steps (f32 sums in another order),
bf16 outputs within one bf16 ulp of flax's plus that f32 noise.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, nchw, nhwc, seeded_variables

from accel_tpu.config import load_config as j_load_config
from accel_tpu.core import trainer as jtrainer
from accel_tpu.models import resnet as jresnet
from accel_tpu.models.accel import build_model as j_build_model
from accel_tpu_torch.config import load_config
from accel_tpu_torch.convert import flax_to_torch, load_flax_variables
from accel_tpu_torch.core import checkpoint as tck
from accel_tpu_torch.core import pipeline as tpipe
from accel_tpu_torch.core import trainer as ttrainer
from accel_tpu_torch.models import resnet as tresnet
from accel_tpu_torch.models.accel import build_model

torch.set_num_threads(2)


def _backbones(seed: int, **knobs):
    """A tiny f32 R18 of each package with ``knobs`` and the same seeded
    weights, and a 64x64 input: (jax module, variables, torch module, x)."""
    jm = jresnet.DilatedResNet(depth=18, dtype=jnp.float32, **knobs)
    x = (np.random.default_rng(seed).standard_normal((2, 64, 64, 3))).astype(np.float32)
    v = seeded_variables(jm, jnp.asarray(x), seed=seed)
    tm = tresnet.DilatedResNet(18, device="cpu", dtype=torch.float32, **knobs).eval()
    load_flax_variables(tm, v)
    return jm, v, tm, x


def test_space_to_depth_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 12, 3)).astype(np.float32)
    want = np.asarray(jresnet.space_to_depth(jnp.asarray(x), 2))
    got = tresnet.space_to_depth(nchw(x), 2)
    np.testing.assert_array_equal(nhwc(got), want)


def test_embed_conv7_as_s2d_matches_jax():
    w7 = np.random.default_rng(1).standard_normal((7, 7, 3, 8)).astype(np.float32)
    want = np.asarray(jresnet.embed_conv7_as_s2d(jnp.asarray(w7)))
    got = tresnet.embed_conv7_as_s2d(torch.from_numpy(w7).permute(3, 2, 0, 1))
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)


def test_s2d_stem_with_its_own_weights_matches_jax():
    jm, v, tm, x = _backbones(2, stem="s2d")
    assert tuple(tm.conv1_s2d.weight.shape) == (64, 12, 4, 4) and not hasattr(tm, "conv1")
    want = np.asarray(jm.apply(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(nchw(x))
    assert_close(nhwc(got), want)


def test_s2d_stem_embedded_from_conv7_is_the_conv7_model():
    jm7, v7, tm7, x = _backbones(3, stem="conv7")
    jms = jresnet.DilatedResNet(depth=18, dtype=jnp.float32, stem="s2d")
    params = dict(v7["params"])
    params["conv1_s2d"] = {"kernel": jresnet.embed_conv7_as_s2d(params.pop("conv1")["kernel"])}
    jwant = np.asarray(jm7.apply(v7, jnp.asarray(x)))
    np.testing.assert_allclose(np.asarray(jms.apply({**v7, "params": params}, jnp.asarray(x))),
                               jwant, rtol=1e-4, atol=1e-4 * np.abs(jwant).max())
    tms = tresnet.DilatedResNet(18, stem="s2d", device="cpu", dtype=torch.float32)
    state = tm7.state_dict()
    state["conv1_s2d.weight"] = tresnet.embed_conv7_as_s2d(state.pop("conv1.weight"))
    tms.load_state_dict(state)
    with torch.no_grad():
        got = tms(nchw(x))
        ref = tm7(nchw(x))
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))
    assert_close(nhwc(got), jwant)


def _bn_arrays(seed: int, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((3, 6, 10, 16)) * 2 + 0.5).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, 16).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(16)).astype(np.float32)}
    stats = {"mean": (0.1 * rng.standard_normal(16)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 16).astype(np.float32)}
    bn = tresnet.BatchNorm(16)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
    jdt = getattr(jnp, dtype)
    return (x, {"params": params, "batch_stats": stats}, bn, jnp.asarray(x, jdt),
            nchw(x).to(getattr(torch, dtype)))


def _assert_within(got: torch.Tensor, want, dtype: str, rel: float = 1e-5):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(nhwc(got.float()) - want)
    bound = rel * (1 + np.abs(want).max())
    if dtype == "bfloat16":  # one bf16 ulp of the value
        t = torch.from_numpy(np.abs(want)).to(torch.bfloat16)
        bound = bound + (torch.nextafter(t, t + 1) - t).float().numpy()
    assert (err <= bound).all(), float(err.max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_eval_matches_flax(dtype):
    x, v, bn, jx, tx = _bn_arrays(4, dtype)
    flax_bn = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5,
                            dtype=getattr(jnp, dtype))
    want = flax_bn.apply(v, jx)
    got = bn.eval()(tx)
    assert got.dtype == tx.dtype
    _assert_within(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_matches_flax_and_its_running_stats(dtype):
    """Batch statistics (f32, biased variance) normalize the output; the
    running statistics move only at ``commit``, by flax's momentum."""
    x, v, bn, jx, tx = _bn_arrays(5, dtype)
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                            dtype=getattr(jnp, dtype))
    want, new = flax_bn.apply(v, jx, mutable=["batch_stats"])
    before = bn.running_mean.clone()
    got = bn.train()(tx)
    _assert_within(got, want, dtype)
    assert torch.equal(bn.running_mean, before)
    bn.commit()
    for stat, key in (("mean", "running_mean"), ("var", "running_var")):
        assert_close(getattr(bn, key).numpy(), np.asarray(new["batch_stats"][stat]), rel=1e-5)
    bn.commit()  # nothing kept since: no change
    assert_close(bn.running_mean.numpy(), np.asarray(new["batch_stats"]["mean"]), rel=1e-5)


def test_batchnorm_backbone_eval_matches_jax():
    jm, v, tm, x = _backbones(6, norm="batchnorm")
    assert sum(isinstance(m, tresnet.BatchNorm) for m in tm.modules()) == 1 + 8 * 2 + 3
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(nchw(x))
    assert_close(nhwc(got), want)


HW = 128
CFG = """\
network:
  name: accel
  ref_depth: 18
  update_depth: 18
  head_channels: 32
  dtype: float32
  norm: batchnorm
  stem: conv7
  propagate: direct
  FIXED_PARAMS: []
TRAIN:
  objective: pair
  lr: 0.01
  lr_step: "1"
  lr_factor: 0.5
  warmup: false
  wd: 0.0005
  aux_loss_weight: 0.5
  ohem_fraction: 0.0
  grad_clip: 0.0
"""


def _pair_batch():
    rng = np.random.default_rng(8)
    data = (rng.standard_normal((2, HW, HW, 3)) * 0.5).astype(np.float32)
    ref = data.copy()
    ref[1] = np.roll(data[1], 4, axis=1)
    label = rng.integers(0, 19, (2, HW, HW)).astype(np.int32)
    label[:, :8] = 255
    return {"data": data, "data_ref": ref, "eq_flag": np.asarray([1.0, 0.0], np.float32),
            "label": label}


def test_two_pair_steps_with_batchnorm_match_jax(tmp_path):
    path = tmp_path / "bn_pair.yaml"
    path.write_text(CFG)
    arrays = _pair_batch()
    jcfg = j_load_config(str(path))
    jmodel = j_build_model(jcfg)
    cur = jnp.zeros((1, HW, HW, 3))
    variables = seeded_variables(jmodel, cur, cur, jnp.ones((1,)), train=False, seed=9)
    assert "batch_stats" in variables and jmodel.norm == "batchnorm"

    cfg = load_config(str(path))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    load_flax_variables(model, variables)
    # the flow head rescaled so the largest flow is 3 feature pixels:
    # inside the port's warp clamp, where it equals the JAX CPU warp
    with torch.no_grad():
        flow, _ = model.flow(nchw(arrays["data"]), nchw(arrays["data_ref"]))
    head = variables["params"]["flownet"]["predict_flow2"]
    gain = np.float32(3.0 / float(flow.abs().max()))
    head["kernel"], head["bias"] = head["kernel"] * gain, head["bias"] * gain
    load_flax_variables(model, variables)

    tx, _ = jtrainer.make_optimizer(jcfg, 2)
    state = jtrainer.init_train_state(jmodel, jax.tree.map(jnp.asarray, variables), tx)
    jstep = jtrainer.make_train_step(jmodel, tx, 19, mesh=None, aux_weight=0.5)
    jbatch = {k: jnp.asarray(a) for k, a in arrays.items()}
    ttx, _ = ttrainer.make_optimizer(cfg, 2, model)
    tstate = ttrainer.init_train_state(model, ttx)
    tstep = ttrainer.make_train_step(ttx, 19, aux_weight=0.5)
    tbatch = {k: nchw(a) if k in ("data", "data_ref") else torch.from_numpy(a)
              for k, a in arrays.items()}
    before = {k: v.clone() for k, v in tpipe.running_stats(model).items()}
    for _ in range(2):
        state, jm = jstep(state, jbatch)
        tstate, tm = tstep(tstate, tbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
    assert not model.training
    want = flax_to_torch(jax.device_get(state.variables))
    stats = tpipe.running_stats(model)
    assert len(stats) == 2 * 2 * (1 + 8 * 2 + 3)
    for key, value in stats.items():
        assert not torch.equal(value, before[key]), key
        assert_close(value.numpy(), want[key].numpy())
    for name, p in tstate.master.items():
        assert_close(p.numpy(), want[name].numpy())
    # a training checkpoint holds the running statistics beside the masters
    ckpt = tck.train_checkpoint(tstate, 0)
    for key, value in stats.items():
        assert torch.equal(ckpt["model"][key], value), key


def test_running_stat_models_need_mutable_stats():
    model = build_model(dict(ref_depth=18, head_channels=32, dtype="float32", norm="batchnorm"),
                        device="cpu", generator=torch.Generator().manual_seed(0))
    batch = {k: nchw(a) if k in ("data", "data_ref") else torch.from_numpy(a)
             for k, a in _pair_batch().items()}
    with pytest.raises(ValueError, match="mutable_stats"):
        tpipe.pair_loss_and_stats(model, batch, 19)
    clip = {"clip": torch.zeros(1, 2, 3, HW, HW), "label": torch.zeros(1, 2, HW, HW).long()}
    with pytest.raises(NotImplementedError, match="running-stat"):
        tpipe.clip_loss_and_stats(model, clip, 19, mutable_stats=True)
