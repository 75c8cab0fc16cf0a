"""Training under the spatial axis (``accel_tpu_torch/parallel/spatial.py``:
the halo exchange's and the group sums' backward) against the unsharded
ops' autograd and the JAX package's ``spatial`` mesh, on the CPU.

- The ops' backward, in this process: S threads (S = 2 and 4) stand for
  the ranks of a spatial group (``ThreadShard`` of ``test_torch_spatial.py``,
  whose two collectives run under the shard's own autograd Functions).
  Each thread runs an op on its rows and differentiates its share of a
  weighted sum of the outputs; its input gradients, put together, and its
  weight gradients, summed over the threads, against the unsharded op's
  autograd at f32 atol and rtol 1e-5 (the weight gradients, sums taken in
  another order, at 1e-5 of their largest entry: ``assert_grads_close``). Convs
  of k 1/3/5/7, strides 1 and 2, dilation 2; max pool; the x2 upscale and the antialiased x2 and x4
  downscales; the plain versions of #1 (at S=4 its halo is taller than a
  shard), the unbounded warp, #3 (the fused stem's weights), #4 and #5;
  GroupNorm and ``spatial.mean``; the s2d stem and the folded 7x7/2 conv
  at f=2 and 4. Then remat's recompute with the
  backward in a fresh ``contextvars.Context()`` (autograd's device thread
  on the card sees no shard): the recompute still runs under the shard.
- Whole objectives, in one spawn of two gloo ranks (``torch_dp_worker.py``,
  1 data x 2 spatial; the JAX side runs here meanwhile), tiny f32 models
  with bridged weights (the flow heads rescaled so the largest flow stays
  inside the port's warp clamp), each rank on its rows of a global batch,
  its loss share and gradients summed over the ranks, against
  ``jax.value_and_grad`` of ``accel_tpu``'s ``clip_loss_and_stats`` /
  ``pair_loss_and_stats`` on the batch sharded over ``make_mesh(data=1,
  spatial=2)`` (``shard_batch(..., spatial=True)``): the shipped clip
  recipe (incremental, remat, aux 0.5; its first clip's aux frame is the
  top rows' most valid frame but not the whole frame's), clip through
  direct without remat (the batched group step), the pair objective with ``norm: batchnorm`` (the running
  statistics too), DeepLab with ``dilated_conv: pallas`` and OHEM 0.25,
  and the shipped recipe with the s2d stem and FlowNet's fold (256 rows:
  FlowNet at input downscale 2). The loss at rtol 1e-5; the gradients each at cosine >= 0.99999
  and all of them within a relative L2 error of 1e-3 (``assert_agree``:
  two f32 summation orders flip ReLUs whose input lies within rounding of
  0, such as 1.25e-6 in the update branch's layer3 here, which moves a
  few entries of a gradient by up to 1.4% of its largest; a halo or group
  sum fault moves a boundary row of every map). The shipped case again with its
  backward in a fresh context: bit-equal, the recompute's exchanges
  counted. One ``make_train_step`` step against ``accel_tpu``'s
  ``make_train_step(mesh=make_mesh(data=1, spatial=2))``: the masters
  within rel 1e-4 and bit-equal on both ranks. The train entry point
  under ``torchrun``'s variables with ``tpu.mesh.spatial: 2``: two steps,
  its checkpoint against the one-process entry point's within rel 1e-4.
- One spawn of four gloo ranks (2 data x 2 spatial): one clip step against
  the one-process port step; an Accel-18/18 with both branches int8
  through ``pred_eval_clips`` on a batch of two clips and then one (which
  data index 1 does not hold: it runs a stand-in), against the
  one-process port on the global batches: every int8 call's scale equal
  on the four ranks and within rtol 1e-6 of the one process's, the class
  maps and the confusion equal. It runs FrozenBN, whose shards compute
  the one process's activations bit for bit: GroupNorm's sums over a
  shard's rows run in another order, and one f32 ulp at a rounding
  boundary flips an int8 step (input noise of 1e-7 moves the shipped
  recipe's int8 scales by 1.4% and its class maps to 0.979 in one
  process).
- In this process: the entry point's crop split check, the folded
  models' row stride included.
"""

import concurrent.futures
import contextvars

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_torch_spatial import FEAT, FLOW, _conv, _gain, _seeded, run_sharded
from torch import nn
from torch.utils.checkpoint import CheckpointError, checkpoint
from torch_dp_worker import spatial_model, train_case
from torch_parity import (Ranks, assert_close, bridged_models, free_port, nchw,
                          write_cityscapes_tree)

from accel_tpu.config import load_config as j_load_config
from accel_tpu.core import pipeline as jpipe
from accel_tpu.core import trainer as jtrainer
from accel_tpu.models.accel import build_model as j_build_model
from accel_tpu.parallel.mesh import make_mesh, replicated, shard_batch
from accel_tpu_torch.config import load_config
from accel_tpu_torch.convert import flax_to_torch, load_flax_variables
from accel_tpu_torch.core import checkpoint as tck
from accel_tpu_torch.core import pipeline as tpipe
from accel_tpu_torch.core import predictor as tpred
from accel_tpu_torch.experiments import train as t_train
from accel_tpu_torch.models.accel import AccelNet, build_model, init_weights
from accel_tpu_torch.models.resnet import (S2D_STEM_HALO, DilatedConv3x3, DilatedResNet,
                                           GroupNorm16)
from accel_tpu_torch.ops import quant
from accel_tpu_torch.ops.fold_downscale import fold_downscale_conv
from accel_tpu_torch.ops.fused_stem import fused_stem
from accel_tpu_torch.ops.upsample import bilinear_upsample, resize_bilinear
from accel_tpu_torch.ops.warp import bilinear_warp
from accel_tpu_torch.ops.warp_onehot import warp_onehot
from accel_tpu_torch.parallel import spatial

torch.set_num_threads(2)
SPATIAL = 2


# ---- the ops' backward on S threads ---------------------------------------------


def _stem():
    w, inv, shift = (_seeded(64, 3, 7, 7, seed=3, scale=0.1), _seeded(64, seed=4),
                     _seeded(64, seed=5))
    params = [p.requires_grad_() for p in (w, inv, shift)]
    return (lambda x: spatial.windowed(lambda t: fused_stem(t, *params, plain=True), x, 7, 2),
            params)


def _s2d_stem():
    """The s2d stem as ``DilatedResNet.forward`` runs it, on one extended
    shard; its weights are ``conv1_s2d``'s."""
    torch.manual_seed(17)
    trunk = DilatedResNet(18, stem="s2d", dtype=torch.float32, use_kernels=False)
    return (lambda x: spatial.halo_apply(trunk._s2d_stem, x, *S2D_STEM_HALO, stride=2),
            [trunk.conv1_s2d.weight])


def _fold(f):
    """A 7x7/2 conv with the factor-f downscale folded in; its weights are
    the unfolded kernel, composed at every call."""
    w = _seeded(8, 3, 7, 7, seed=18 + f, scale=0.1).requires_grad_()
    return lambda x: fold_downscale_conv(x, w, f, 2, 3), [w]


def _module(m):
    return m, list(m.parameters())


def _fn(fn):
    return fn, []


# name -> op factory: (fn or module, its weights)
GRAD_OPS = {
    "conv_k1": lambda: _module(_conv(1)),
    "conv_k1_s2": lambda: _module(_conv(1, 2)),
    "conv_k3": lambda: _module(_conv(3)),
    "conv_k3_s2": lambda: _module(_conv(3, 2)),
    "conv_k3_d2": lambda: _module(_conv(3, 1, 2)),
    "conv_k5_s2": lambda: _module(_conv(5, 2)),
    "conv_k7_s2": lambda: _module(_conv(7, 2)),
    "max_pool": lambda: _fn(lambda x: spatial.windowed(
        lambda t: F.max_pool2d(t, 3, stride=2, padding=1), x, 3, 2)),
    "upsample_x2": lambda: _fn(lambda x: bilinear_upsample(x, 2)),
    "downscale_x2": lambda: _fn(lambda x: resize_bilinear(x, (x.shape[-2] // 2,
                                                              x.shape[-1] // 2))),
    "downscale_x4": lambda: _fn(lambda x: resize_bilinear(x, (x.shape[-2] // 4,
                                                              x.shape[-1] // 4))),
    # #1's plain version with flow past the clamp D; at D=10 the halo of 11
    # rows is taller than the 8-row shards at S=4 (rows of the rank after next)
    "warp_1_d6": lambda: _fn(lambda f, fl: bilinear_warp(f, fl, True, 6, plain=True)),
    "warp_1_d10": lambda: _fn(lambda f, fl: bilinear_warp(f, fl, True, 10, plain=True)),
    "warp_unbounded": lambda: _fn(lambda f, fl: bilinear_warp(f, fl, False, 6)),
    "fused_stem_3": _stem,
    "warp_onehot_4": lambda: _fn(lambda f, fl, s: warp_onehot(
        f, fl, s, 4, _gain(), weights_dtype=torch.float32, plain=True)),
    "dilated_conv_5": lambda: _module(DilatedConv3x3(8, 8, 2, use_kernels=False)),
    "group_norm": lambda: _module(GroupNorm16(32)),
    # mean1's renormalization: a per-sample mean over the whole frame
    "mean": lambda: _fn(lambda x: x * spatial.mean(x, (1, 2, 3), keepdim=True)),
    # the s2d stem and the folds (the update stem at f=2, FlowNet's conv1
    # halves at 2 and 4): their own padding, on one extended shard
    "s2d_stem": _s2d_stem,
    "fold_f2": lambda: _fold(2),
    "fold_f4": lambda: _fold(4),
}
GRAD_INPUTS = {
    "warp_1_d6": ((FEAT, 1.0), (FLOW, 4.0)),
    "warp_1_d10": ((FEAT, 1.0), (FLOW, 6.0)),
    "warp_unbounded": (((2, 80, 32, 12), 1.0), (FLOW, 4.0)),
    "fused_stem_3": (((2, 3, 64, 16), 1.0),),
    "warp_onehot_4": ((FEAT, 1.0), (FLOW, 3.0), (FEAT, 1.0)),
    "dilated_conv_5": (((2, 8, 32, 12), 1.0),),
    "group_norm": (((2, 32, 32, 12), 1.0),),
    "s2d_stem": (((2, 3, 64, 16), 1.0),),
    "fold_f2": (((2, 3, 64, 24), 1.0),),
    "fold_f4": (((2, 3, 64, 40), 1.0),),
}


def assert_grads_close(got_inputs: list, got_params: list, want: tuple) -> None:
    """The input gradients within f32 atol 1e-5 and rtol 1e-5 of the
    unsharded op's (a warp's sample coordinates are the extended shard's
    rows, which round by an ulp otherwise); each weight gradient within
    1e-5 * (1 + its largest entry): it sums hundreds of products (up to ~40
    here) whose partial sums the threads take in another order, where
    nearly cancelling entries move by a few 1e-5."""
    n = len(got_inputs)
    for got, ref in zip(got_inputs, want[:n], strict=True):
        assert got.shape == ref.shape
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    for got, ref in zip(got_params, want[n:], strict=True):
        assert got.shape == ref.shape
        assert_close(got.numpy(), ref.numpy(), rel=1e-5)


def sharded_grads(fn, params: list, inputs: tuple, weight: torch.Tensor, size: int,
                  module: nn.Module | None, backward=None):
    """Each of ``size`` threads differentiates ``(fn(its rows) * its rows
    of weight).sum()`` with respect to its rows of ``inputs`` and to
    ``params`` (``backward``: how the thread calls ``torch.autograd.grad``);
    returns the input gradients put together, the weight gradients summed
    over the threads and each thread's shard counters."""
    backward = backward or (lambda loss, wrt: torch.autograd.grad(loss, wrt))

    def one(*mine):
        *xs, w = mine
        leaves = [x.clone().requires_grad_() for x in xs]
        grads = backward((fn(*leaves) * w).sum(), [*leaves, *params])
        return grads, spatial.active().counters()

    with torch.enable_grad():
        outs = run_sharded(one, (*inputs, weight), size, module, rows_out=False)
    n = len(inputs)
    got_inputs = [torch.cat([o[0][i] for o in outs], dim=-2) for i in range(n)]
    got_params = [sum(o[0][n + j] for o in outs) for j in range(len(params))]
    return got_inputs, got_params, [o[1] for o in outs]


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", list(GRAD_OPS))
def test_halo_op_gradients_match_the_unsharded_op(name, size):
    fn, params = GRAD_OPS[name]()
    module = fn if isinstance(fn, nn.Module) else None
    inputs = tuple(_seeded(*shape, seed=i, scale=scale)
                   for i, (shape, scale) in enumerate(GRAD_INPUTS.get(name, ((FEAT, 1.0),))))
    leaves = [x.clone().requires_grad_() for x in inputs]
    out = fn(*leaves)
    weight = _seeded(*out.shape, seed=20)
    want = torch.autograd.grad((out * weight).sum(), [*leaves, *params])
    got_inputs, got_params, counters = sharded_grads(fn, params, inputs, weight, size, module)
    assert_grads_close(got_inputs, got_params, want)
    # every exchange and sum of the forward ran its backward on every thread
    for c in counters:
        assert c["exchanges_backward"] == c["exchanges"], c
        assert c["reductions_backward"] == c["reductions"], c
        assert (c["exchanges"] + c["reductions"] > 0) == (name not in ("conv_k1", "conv_k1_s2"))


def _remat_net():
    torch.manual_seed(11)
    return nn.Sequential(nn.Conv2d(4, 16, 3, padding=1), nn.ReLU(), GroupNorm16(16),
                         nn.Conv2d(16, 6, 5, stride=2, padding=4, dilation=2))


@pytest.mark.parametrize("size", [2, 4])
def test_remat_recompute_runs_under_the_shard_in_a_fresh_context(size):
    """``pipeline._remat`` on S threads, each thread's backward in a fresh
    ``contextvars.Context()`` (the context autograd's device thread has on
    the card): the recompute still exchanges halos and sums over the group,
    and the gradients are the unsharded ones. A bare checkpoint fails
    there: its recompute runs the convs on the bare shard."""
    net = _remat_net()
    params = list(net.parameters())
    x = _seeded(*FEAT, seed=12)
    leaf = x.clone().requires_grad_()
    out = net(leaf)
    weight = _seeded(*out.shape, seed=13)
    want = torch.autograd.grad((out * weight).sum(), [leaf, *params])

    def fresh(loss, wrt):
        return contextvars.Context().run(torch.autograd.grad, loss, wrt)

    got_inputs, got_params, counters = sharded_grads(tpipe._remat(net), params, (x,), weight,
                                                     size, net, fresh)
    assert_grads_close(got_inputs, got_params, want)
    # the backward runs the forward's exchanges and sums, and the recompute's
    # forward again; the recomputed graph is not differentiated
    for c in counters:
        assert c["exchanges"] == c["exchanges_recomputed"] == c["exchanges_backward"] == 2, c
        assert c["reductions"] == c["reductions_recomputed"] == c["reductions_backward"] == 1, c
    bare = lambda t: checkpoint(net, t, use_reentrant=False)  # noqa: E731
    with pytest.raises(CheckpointError):
        sharded_grads(bare, params, (x,), weight, size, net, fresh)


# ---- whole objectives on two gloo ranks against the JAX spatial mesh -------------

# the frames: H/S divisible by the models' row stride (FlowNet's 64 at
# flow_input_downscale 1), W by 64. At W = 64 (4-column score maps) the
# one-process port's clip gradients already differ from the JAX package's
# (ROADMAP.md Queue 3); at 128 they agree to ~5e-6
H, W, B, F_CLIP = 128, 128, 2, 2
# FlowNet at a quarter of its width: the weights the ranks load and return
# stay near 25M parameters a model
SHIPPED = dict(family="accel", ref_depth=18, update_depth=18, head_channels=32, norm="groupnorm",
               scale_field_norm="mean1", scale_cascade="last", flow_input_downscale=1,
               flow_width_mult=0.25)
OBJECTIVES = {
    # the shipped recipe: clip objective through incremental propagation, remat, aux 0.5
    "clip_incremental_remat": (SHIPPED, dict(objective="clip", propagate="incremental",
                                             remat=True, ohem=0.0, aux=0.5)),
    # the batched group step (no remat)
    "clip_direct": (SHIPPED, dict(objective="clip", propagate="direct", remat=False, ohem=0.0,
                                  aux=0.5)),
    # batch statistics over the world, which holds every rank's rows
    "pair_batchnorm": (dict(SHIPPED, norm="batchnorm"), dict(
        objective="pair", propagate="direct", remat=False, ohem=0.0, aux=0.5)),
    # per-frame DeepLab, every dilated conv through #5's plain version; OHEM's
    # global threshold over the ranks' rows
    "deeplab_pallas_ohem": (dict(family="deeplab", ref_depth=18, head_channels=32,
                                 norm="groupnorm", dilated_conv="pallas"), dict(
        objective="clip", propagate="direct", remat=True, ohem=0.25, aux=0.5)),
    # the s2d stem in both branches and FlowNet's folded downscale (f=2) under
    # the shipped recipe; FlowNet at input downscale 2 needs 128 | H/S
    "clip_s2d_foldflow": (dict(SHIPPED, stem="s2d", fold_flow_downscale=True,
                               flow_input_downscale=2), dict(
        objective="clip", propagate="incremental", remat=True, ohem=0.0, aux=0.5)),
}
# the int8 serving case of the 2 x 2 ranks (module docstring: FrozenBN)
INT8 = dict(family="accel", ref_depth=18, update_depth=18, head_channels=32,
            flow_input_downscale=1, flow_width_mult=0.25, quantize_ref=True,
            quantize_update=True)
# the frames of a case whose row stride 128 needs more rows than H
FRAMES = {"clip_s2d_foldflow": (256, W)}
FRESH = "clip_incremental_remat"
CFG = """\
network:
  name: accel
  ref_depth: 18
  update_depth: 18
  head_channels: 32
  dtype: float32
  norm: groupnorm
  propagate: incremental
  flow_input_downscale: 1
  flow_width_mult: 0.25
TRAIN:
  objective: clip
  CLIP_LENGTH: 2
  BATCH_IMAGES: 2
  remat: true
  lr: 0.01
  lr_step: "1"
  lr_factor: 0.5
  warmup: false
  wd: 0.0005
  aux_loss_weight: 0.5
TEST:
  KEY_FRAME_INTERVAL: 2
tpu:
  mesh:
    spatial: {spatial}
"""


def clip_arrays(seed: int, h: int = H, w: int = W) -> dict:
    """A global clip batch (NHWC frames, int32 labels). Clip 0: frame 0 valid
    on rows 0-59, frame 1 on rows 0-9 and 64-127 (to the last row), so the
    top shard alone would pick frame 0 as the aux frame where the whole
    frame picks frame 1; clip 1: frame 1 annotated, its first 8 rows
    ignored."""
    rng = np.random.default_rng(seed)
    label = np.full((B, F_CLIP, h, w), 255, np.int32)
    label[0, 0, :60] = rng.integers(0, 19, (60, w))
    label[0, 1, :10] = rng.integers(0, 19, (10, w))
    label[0, 1, 64:] = rng.integers(0, 19, (h - 64, w))
    label[1, 1, 8:] = rng.integers(0, 19, (h - 8, w))
    return {"clip": (rng.standard_normal((B, F_CLIP, h, w, 3)) * 0.5).astype(np.float32),
            "label": label}


def pair_arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    label = rng.integers(0, 19, (B, H, W)).astype(np.int32)
    label[:, :8] = 255
    data = (rng.standard_normal((B, H, W, 3)) * 0.5).astype(np.float32)
    ref = data.copy()
    ref[1] = np.roll(data[1], 4, axis=1)
    return {"data": data, "data_ref": ref, "eq_flag": np.asarray([1.0, 0.0], np.float32),
            "label": label}


def eval_batches(seed: int) -> list[dict]:
    """Global eval batches of two clips and then one, 2 frames each (NHWC
    frames; the last frame annotated, its first 8 rows ignored)."""
    rng = np.random.default_rng(seed)
    batches = []
    for b in (2, 1):
        label = np.full((b, F_CLIP, H, W), 255, np.int64)
        label[:, -1, 8:] = rng.integers(0, 19, (b, H - 8, W))
        batches.append({"clip": torch.from_numpy(
            (rng.standard_normal((b, F_CLIP, H, W, 3)) * 0.5).astype(np.float32)),
            "label": torch.from_numpy(label)})
    return batches


def port_batch(arrays: dict) -> dict:
    return {k: nchw(v) if k in ("clip", "data", "data_ref") else torch.from_numpy(v)
            for k, v in arrays.items()}


def live_flow(tm, variables, arrays: dict) -> None:
    """Both packages' flow heads rescaled so that the port's largest flow on
    the batch's first pair of frames is 3 feature pixels: inside the port's
    warp clamp, where it equals the JAX CPU path's unclamped warp."""
    if not hasattr(tm, "flownet"):
        return
    cur, ref = ((arrays["clip"][:, 1], arrays["clip"][:, 0]) if "clip" in arrays
                else (arrays["data"], arrays["data_ref"]))
    with torch.no_grad():
        flow, _ = tm.flow(nchw(cur), nchw(ref))
    head = variables["params"]["flownet"]["predict_flow2"]
    gain = np.float32(3.0 / float(flow.abs().max()))
    head["kernel"], head["bias"] = head["kernel"] * gain, head["bias"] * gain
    load_flax_variables(tm, variables)


def jax_loss_and_grads(jm, variables, arrays: dict, recipe: dict):
    """``jax.value_and_grad`` of the recipe's objective on the batch sharded
    on H over ``make_mesh(data=1, spatial=2)``: (loss, gradients and
    running statistics by ``state_dict`` key)."""
    mesh = make_mesh(data=1, spatial=SPATIAL)

    def loss_fn(params, batch):
        v = dict(variables, params=params)
        kw = dict(ohem_fraction=recipe["ohem"] or None, aux_weight=recipe["aux"])
        if recipe["objective"] == "clip":
            return jpipe.clip_loss_and_stats(jm, v, batch, 19, propagate=recipe["propagate"],
                                             remat=recipe["remat"], **kw)
        return jpipe.pair_loss_and_stats(jm, v, batch, 19, mutable_stats=jm.norm == "batchnorm",
                                         **kw)

    run = jax.jit(jax.value_and_grad(loss_fn, has_aux=True), out_shardings=replicated(mesh))
    (loss, stats), grads = run(jax.device_put(variables["params"], replicated(mesh)),
                               shard_batch(mesh, {k: jnp.asarray(v) for k, v in arrays.items()},
                                           spatial=True))
    out = flax_to_torch({"params": jax.device_get(grads)})
    if stats is not None:
        out.update(flax_to_torch({"batch_stats": jax.device_get(stats)}))
    return float(loss), out


def jax_step(path: str, variables, arrays: dict):
    """One step of ``accel_tpu``'s ``make_train_step(mesh=make_mesh(data=1,
    spatial=2))`` on the batch sharded on H: the variables after it."""
    cfg = j_load_config(path)
    model = j_build_model(cfg)
    tx, _ = jtrainer.make_optimizer(cfg, 2)
    mesh = make_mesh(data=1, spatial=SPATIAL)
    # a copy: the step donates its state
    state = jax.device_put(jtrainer.init_train_state(model, jax.tree.map(jnp.array, variables),
                                                     tx), replicated(mesh))
    step = jtrainer.make_train_step(model, tx, 19, mesh=mesh, aux_weight=0.5, objective="clip",
                                    propagate="incremental", remat=True)
    state, _ = step(state, shard_batch(mesh, {k: jnp.asarray(v) for k, v in arrays.items()},
                                       spatial=True))
    return flax_to_torch(jax.device_get(state.variables))


def train_tree_cfg(root, data, spatial_ranks: int, name: str) -> str:
    """The shipped clip cfg on the train tree: one epoch of two steps (4
    annotated frames, a global batch of 2) at a 128 x 128 crop."""
    text = (CFG.format(spatial=spatial_ranks)
            .replace("TRAIN:\n", "TRAIN:\n  CROP_SIZE: [128, 128]\n  end_epoch: 1\n"
                                 "  model_prefix: tiny\n")
            + f"output_path: {root / 'out'}\nSCALES: [[128, 256]]\n"
            + f"dataset:\n  dataset: CityScape\n  dataset_path: {data}\n"
            + f"  root_path: {root / 'train_root'}\n  image_set: leftImg8bit_train\n")
    path = root / f"{name}.yaml"
    path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """Writes every case, starts the two ranks (1 x 2) and the four (2 x 2)
    and returns what the JAX side and the checks need."""
    root = tmp_path_factory.mktemp("spatial_train")
    objectives, spec_objectives, made = {}, {}, {}
    for i, (name, (knobs, recipe)) in enumerate(OBJECTIVES.items()):
        # one set of weights and one batch per model: the spec and the ranks'
        # results hold each once
        key = (tuple(sorted(knobs.items())), recipe["objective"])
        if key not in made:
            arrays = (clip_arrays(100 + i, *FRAMES.get(name, (H, W)))
                      if recipe["objective"] == "clip" else pair_arrays(100 + i))
            # weights made for a frame FlowNet takes
            jm, variables, tm = bridged_models(knobs, 64 * knobs.get("flow_input_downscale", 1),
                                               seed=110 + i)
            live_flow(tm, variables, arrays)
            made[key] = (jm, variables, arrays, tm.state_dict(), port_batch(arrays))
        jm, variables, arrays, state_dict, batch = made[key]
        objectives[name] = (jm, variables, arrays, recipe)
        spec_objectives[name] = {"knobs": knobs, "state_dict": state_dict, "recipe": recipe,
                                 "batch": batch}
    cfgs = {s: root / f"shipped_s{s}.yaml" for s in (1, SPATIAL)}
    for s, path in cfgs.items():
        path.write_text(CFG.format(spatial=s))
    # the train steps: the shipped cfg's model (the shipped case's knobs) on
    # the shipped case's weights and batch
    _, step_variables, step_arrays, state_dict, batch = made[
        (tuple(sorted(SHIPPED.items())), "clip")]
    step_case = {"cfg": str(cfgs[SPATIAL]), "state_dict": state_dict, "batch": batch, "steps": 1}
    int8 = AccelNet(**INT8, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        init_weights(int8, torch.Generator().manual_seed(150))
    serving_case = {"knobs": INT8, "state_dict": int8.state_dict(), "batches": eval_batches(151),
                    "interval": 2, "propagate": "incremental"}

    data = write_cityscapes_tree(root / "train_tree", 128, 256, snippets=2, seed=140,
                                 split="train")
    entry = {s: train_tree_cfg(root, data, s, f"entry_s{s}") for s in (1, SPATIAL)}
    spec_path, grid_path = root / "spec.pt", root / "grid.pt"
    torch.save({"spatial_train": True, "init": f"file://{root / 'rendezvous'}",
                "cfg": str(cfgs[SPATIAL]), "objectives": spec_objectives, "fresh": FRESH,
                "steps": {"shipped_step": step_case},
                "train_entry": {"argv": ["--cfg", entry[SPATIAL], "--device", "cpu",
                                         "--frequent", "1"], "port": free_port()}}, spec_path)
    torch.save({"spatial_train": True, "init": f"file://{root / 'grid_rendezvous'}",
                "cfg": str(cfgs[SPATIAL]), "steps": {"grid_step": step_case},
                "serving": {"grid_int8": serving_case}}, grid_path)
    ranks, grid = Ranks(spec_path, SPATIAL), Ranks(grid_path, 2 * SPATIAL)
    try:
        yield {"objectives": objectives, "ranks": ranks, "grid": grid, "grid_case": step_case,
               "grid_serving": serving_case,
               "step": (str(cfgs[SPATIAL]), step_variables, step_arrays, step_case),
               "entry": entry, "root": root}
    finally:
        ranks.close()
        grid.close()


@pytest.fixture(scope="module")
def jax_refs(sp):
    """The JAX side, while the ranks run: each objective's loss and
    gradients on the spatially sharded batch, and the mesh step."""
    # XLA compiles with the GIL released: three programs at a time
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        grads = {name: pool.submit(jax_loss_and_grads, jm, variables, arrays, recipe)
                 for name, (jm, variables, arrays, recipe) in sp["objectives"].items()}
        path, variables, arrays, _ = sp["step"]
        step = pool.submit(jax_step, path, variables, arrays)
        return {name: f.result() for name, f in grads.items()}, step.result()


@pytest.mark.parametrize("name", list(OBJECTIVES))
def test_sharded_objective_matches_jax_value_and_grad(sp, jax_refs, name):
    want_loss, want = jax_refs[0][name]
    ranks = sp["ranks"].results()
    assert ranks[0]["backend"] == "gloo"
    for r, out in enumerate(ranks):
        assert out["mesh"] == (1, SPATIAL, 0, r)
        got = out[name]
        batch_key = "clip" if OBJECTIVES[name][1]["objective"] == "clip" else "data"
        h, w = FRAMES.get(name, (H, W))
        assert got["rows"][-2:] == [h // SPATIAL, w], got["rows"]
        assert batch_key and got["loss"] == ranks[0][name]["loss"]
        np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
        c = got["counters"]
        # the exchanges of tensors that need no gradient (the frames) have no backward
        assert 0 < c["exchanges_backward"] <= c["exchanges"], c
        assert c["reductions_backward"] > 0, c
        assert got["grads_digest"] == ranks[0][name]["grads_digest"]
    got = ranks[0][name]
    assert set(got["grads"]) <= set(want)
    assert_agree(got["grads"], want)
    assert bool(got["stats"]) == (name == "pair_batchnorm")
    for key, value in got["stats"].items():
        assert torch.equal(value, ranks[1][name]["stats"][key]), key
        assert_close(value.numpy(), want[key].numpy())


def test_remat_backward_in_a_fresh_context_matches(sp):
    """The shipped case's backward in a fresh ``contextvars.Context()``: the
    recompute ran its exchanges under the shard, and every gradient is the
    one of the backward in the caller's context, bit for bit."""
    for out in sp["ranks"].results():
        fresh, normal = out["fresh"], out[FRESH]
        assert fresh["loss_equal"] and fresh["grads_equal"]
        assert fresh["counters"] == normal["counters"]
        forward = fresh["forward_counters"]
        assert forward["exchanges_recomputed"] == 0 < fresh["counters"]["exchanges_recomputed"]
        assert fresh["counters"]["reductions_recomputed"] > 0


def assert_agree(got: dict, want: dict, cosine: float = 0.99999, rel_l2: float = 1e-3) -> None:
    """Each tensor of ``got`` at cosine >= ``cosine`` with ``want``'s (both
    zero where ``want``'s is), and all of them as one vector within a
    relative L2 error of ``rel_l2`` (module docstring: ReLU flips)."""
    num = den = 0.0
    for key, g in got.items():
        a, b = g.double().flatten(), want[key].double().flatten()
        num += float((a - b).square().sum())
        den += float(b.square().sum())
        if float(b.norm()) == 0.0:
            assert float(a.norm()) <= 1e-12, key
            continue
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos >= cosine, (key, cos)
    assert (num / den) ** 0.5 <= rel_l2, (num / den) ** 0.5


def assert_update_close(after: dict, before: dict, want_after: dict) -> None:
    """The parameters' updates (after - before) agree with the reference's
    (``assert_agree``, each at cosine >= 0.999: the f32 masters round an
    update of 1e-5 to an ulp of its weight, ~1%)."""
    assert_agree({k: p - before[k] for k, p in after.items()},
                 {k: want_after[k] - before[k] for k in after}, cosine=0.999)


def test_train_step_matches_the_jax_spatial_mesh(sp, jax_refs):
    want = jax_refs[1]
    case = sp["step"][3]
    ranks = sp["ranks"].results()
    for out in ranks:
        assert out["shipped_step"]["masters_equal_rank0"]
        assert out["shipped_step"]["rows"] == B
    np.testing.assert_allclose(ranks[0]["shipped_step"]["losses"][0], jax_refs[0][FRESH][0],
                               rtol=1e-5)
    got = ranks[0]["shipped_step"]["master"]
    assert set(got) <= set(want)
    for key, p in got.items():
        assert_close(p.numpy(), want[key].numpy())
    assert_update_close(got, case["state_dict"], want)


def test_two_by_two_ranks_match_the_one_process_step(sp):
    """2 data x 2 spatial ranks, one clip a data index, against the
    one-process port step on the whole batch."""
    case = sp["grid_case"]
    want = train_case(case, None)
    ranks = sp["grid"].results()
    assert [out["mesh"] for out in ranks] == [(2, 2, 0, 0), (2, 2, 0, 1), (2, 2, 1, 0),
                                              (2, 2, 1, 1)]
    for out in ranks:
        got = out["grid_step"]
        assert got["masters_equal_rank0"] and got["rows"] == 1
        np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=1e-5)
    got = ranks[0]["grid_step"]["master"]
    for key, p in got.items():
        assert_close(p.numpy(), want["master"][key].numpy())
    assert_update_close(got, case["state_dict"], want["master"])


def test_two_by_two_ranks_serve_int8_as_one_process(sp):
    """The int8 model's eval on 2 data x 2 spatial ranks against the
    one-process port on the global batches (module docstring): each call's
    activation scale is the global call's on every rank, so the class maps
    are the one process's."""
    case = sp["grid_serving"]
    maps = []
    with quant.scales_recorded() as want_scales:
        miou, _, stats = tpred.pred_eval_clips(spatial_model(case), case["batches"], 19,
                                               case["interval"], case["propagate"],
                                               on_preds=lambda _, preds: maps.append(preds))
    want_scales = torch.stack(want_scales)
    ranks = [out["grid_int8"] for out in sp["grid"].results()]
    for r, got in enumerate(ranks):
        assert got["batches"] == (2 if r < SPATIAL else 1)
        scales = torch.stack(got["scales"])
        assert torch.equal(scales, torch.stack(ranks[0]["scales"])), r
        torch.testing.assert_close(scales, want_scales, rtol=1e-6, atol=0)
        np.testing.assert_array_equal(got["confusion"], stats["confusion"])
        assert got["miou"] == miou
        # data index 0 holds clip 0 of both batches, data index 1 clip 1 of the first
        want_maps = [maps[0][:1], maps[1]] if r < SPATIAL else [maps[0][1:]]
        assert len(got["maps"]) == len(want_maps)
        for g, w in zip(got["maps"], want_maps, strict=True):
            assert torch.equal(g, w), r


def test_train_entry_point_with_a_spatial_mesh_matches_one_process(sp):
    root = sp["root"]
    want = t_train.main(["--cfg", sp["entry"][1], "--device", "cpu", "--frequent", "1"])
    ranks = sp["ranks"].results()
    got = [out["train_entry"] for out in ranks]
    assert want.step == got[0]["step"] == got[1]["step"] == 2
    assert got[0]["master_digest"] == got[1]["master_digest"]
    prefix = root / "out" / f"entry_s{SPATIAL}" / "leftImg8bit_train" / "tiny"
    assert tck.saved_epochs(str(prefix)) == [0]
    ckpt = tck.load_checkpoint(str(prefix), 0)["model"]
    one = tck.load_checkpoint(str(root / "out" / "entry_s1" / "leftImg8bit_train" / "tiny"),
                              0)["model"]
    assert ckpt.keys() == one.keys()
    for key, p in one.items():
        assert_close(ckpt[key].numpy(), p.numpy())
    start = build_model(load_config(sp["entry"][1]), device="cpu",
                        generator=torch.Generator().manual_seed(0)).state_dict()
    assert_update_close({k: ckpt[k] for k in want.master}, start, want.master)
    metrics = root / "out" / f"entry_s{SPATIAL}" / "leftImg8bit_train" / "metrics.jsonl"
    assert len(metrics.read_text().splitlines()) == 2


# ---- in this process ----------------------------------------------------------


def test_entry_point_checks_the_crop_split():
    """The crop's rows over the spatial ranks must give shards that divide
    by the model's row stride: 768 over 4 ranks gives 192, against 128."""
    model = AccelNet(ref_depth=18, update_depth=18, device="meta", dtype=torch.float32)
    assert model.row_stride == 128
    t_train.check_split(768, 2, model)
    with pytest.raises(ValueError, match="rows 768 over tpu.mesh.spatial=4 ranks give shards of "
                                         "192 rows.*row stride 128"):
        t_train.check_split(768, 4, model)
    with pytest.raises(ValueError, match="shards of 255.5 rows"):
        t_train.check_split(511, 2, model)
    # the folds keep the row stride of the unfolded model (FlowNet's 64 *
    # flow_input_downscale, the update branch's feat stride * its input
    # downscale): the flagship's 768 rows split over 2 ranks at input
    # downscale 2, not at the fast row's 4, which the check names
    folded = AccelNet(ref_depth=18, update_depth=18, fold_flow_downscale=True,
                      update_input_downscale=2, fold_update_downscale=True, device="meta",
                      dtype=torch.float32)
    assert folded.row_stride == 128
    t_train.check_split(768, 2, folded)
    fast = AccelNet(ref_depth=18, update_depth=18, fold_flow_downscale=True,
                    flow_input_downscale=4, device="meta", dtype=torch.float32)
    with pytest.raises(ValueError, match="shards of 384 rows.*accel model's row stride 256"):
        t_train.check_split(768, 2, fast)
