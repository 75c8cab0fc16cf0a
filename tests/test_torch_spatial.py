"""The spatial axis (``accel_tpu_torch/parallel/spatial.py``: each frame's
rows split over ranks, with halo exchanges) against the unsharded ops and
the JAX package's ``spatial`` mesh, on the CPU.

- The halo ops, in this process: S threads (S = 2 and 4) stand for the
  ranks of a spatial group (``ThreadShard``: the all-gather and the
  all-reduce through a barrier), each running an op on its rows inside
  ``SpatialShard.serving``; the rows, put together, against the op on the
  whole input at f32 atol 1e-5. Convs of k 1/3/5/7, strides 1 and 2,
  dilation 2; max pool; the x2 upscale and the antialiased x2 and x4
  downscales; the plain versions of #1 (with the flow past its clamp and,
  at S=4, its halo taller than a shard), the unbounded plain warp, #2,
  #3, #4 (scale and gain) and #5; GroupNorm and mean1's mean; int8
  convs (each thread's scale the unsharded call's, the output bit-equal);
  the s2d stem and the folded 7x7/2 conv at f=2 and 4 (their hand
  padding on one extended shard); whole ResNet-18 trunks. The halo
  arithmetic of each op, and the row-stride refusal (a gradient through
  the exchange runs: it matches the unsharded conv's).
- Whole models, in one spawn of two gloo ranks (``torch_dp_worker.py``,
  a spec with ``spatial``; the JAX side runs here meanwhile): tiny f32
  Accel (groupnorm + mean1, incremental, cascade mean1; frozenbn + fused7,
  direct), DFF (the one-hot warp with mean1's gain fused, f32 tap weights
  on both sides as in ``test_torch_dff.py``), DeepLab (``dilated_conv:
  pallas``), Accel in int8 with the s2d stem and FlowNet's fold, and
  Accel with the update branch's fold, at the smallest frames the row
  rule admits, each rank running
  ``clip_logits`` and
  ``clip_predictions`` on its rows under a ``tpu.mesh.spatial: 2`` mesh,
  against ``jax.jit(clip_logits)`` on a ``make_mesh(data=1, spatial=2)``
  clip sharded on H: logits within 1e-4 * (1 + max), class maps equal to
  the one-process port's and to the JAX logits' argmax through the JAX
  upsample (int8: every call's scale equal on both ranks and within f32
  rounding of the one process's, the class maps the one process's, and
  against JAX ``test_torch_quant.py``'s end-to-end tolerance). ``pred_eval_clips`` under the spatial mesh: the one-process
  confusion matrix and the mIoU of ``accel_tpu``'s
  ``pred_eval_clips(mesh=make_mesh(1, 2), shard_spatial=True)``. The eval entry point under ``torchrun``'s
  variables with ``tpu.mesh.spatial: 2``: the one-process confusion
  matrix exactly.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch_parity import (Ranks, assert_close, bridged_models, f32_tap_weights, free_port,  # noqa: F401
                          nchw, nhwc, write_cityscapes_tree)

import accel_tpu.ops.warp_onehot as jwo
from accel_tpu.core import pipeline as jpipe
from accel_tpu.core import predictor as jpred
from accel_tpu.ops.upsample import resize_bilinear as j_resize
from accel_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
from accel_tpu_torch.convert import load_flax_variables
from accel_tpu_torch.core import pipeline as tpipe
from accel_tpu_torch.core import predictor as tpred
from accel_tpu_torch.experiments import test as t_entry
from accel_tpu_torch.models.accel import AccelNet
from accel_tpu_torch.models.resnet import (S2D_STEM_HALO, STEM_POOL_HALO, DilatedConv3x3,
                                           DilatedResNet, GroupNorm16, Int8Conv2d)
from accel_tpu_torch.ops import quant
from accel_tpu_torch.ops.fold_downscale import fold_downscale_conv, fold_halo
from accel_tpu_torch.ops.fused_stem import fused_stem
from accel_tpu_torch.ops.upsample import bilinear_upsample, resize_bilinear, resize_halo
from accel_tpu_torch.ops.upsample_argmax import upsample_argmax
from accel_tpu_torch.ops.warp import bilinear_warp
from accel_tpu_torch.ops.warp_onehot import warp_onehot
from accel_tpu_torch.parallel import spatial

torch.set_num_threads(2)
HW = (256, 128)   # FlowNet at flow_input_downscale 2 needs 128 | H/S and 128 | W
SPATIAL = 2


# ---- the halo ops on S threads ------------------------------------------------


class Board:
    """The S threads' meeting place: each posts a tensor and reads all S."""

    def __init__(self, size: int):
        self.barrier = threading.Barrier(size, timeout=120)
        self.slots: list = [None] * size

    def exchange(self, index: int, t: torch.Tensor) -> list[torch.Tensor]:
        self.slots[index] = t.clone()
        self.barrier.wait()
        out = list(self.slots)
        self.barrier.wait()
        return out


class ThreadShard(spatial.SpatialShard):
    """A spatial shard whose group is the threads of a ``Board``: its two
    collectives stand in for the process group's, under the shard's own
    autograd Functions (the exchange's and the sum's backward)."""

    def __init__(self, board: Board, size: int, index: int):
        super().__init__(None, size, index)
        self.board = board

    def _all_gather(self, t):
        return self.board.exchange(self.index, t.detach())

    def _all_reduce(self, t):
        return torch.stack(self.board.exchange(self.index, t.detach())).sum(0)

    def reduce_max(self, t):
        """The threads' max of ``t``: the int8 calls' scale group."""
        return torch.stack(self.board.exchange(self.index, t.detach())).amax(0)


def run_sharded(fn, inputs: tuple, size: int, module: nn.Module | None = None,
                rows_out: bool = True):
    """``fn`` on each of ``size`` threads' rows of ``inputs`` (dim -2, each
    input split by its own rows), inside its ``ThreadShard.serving(module)``,
    the threads as the int8 calls' scale group, and the caller's grad mode:
    the outputs put together along dim -2 (``rows_out``), or each thread's
    own."""
    board = Board(size)
    outs, errors = [None] * size, []
    grad = torch.is_grad_enabled()

    def one(i):
        try:
            mine = tuple(x[..., i * (x.shape[-2] // size):(i + 1) * (x.shape[-2] // size), :]
                         for x in inputs)
            shard = ThreadShard(board, size, i)
            with (torch.set_grad_enabled(grad), shard.serving(module or nn.Identity()),
                  quant.sharing(quant.ScaleGroup(shard.reduce_max))):
                # every thread's hooks are on before any runs, and on until all ran
                board.barrier.wait()
                try:
                    outs[i] = fn(*mine)
                finally:
                    board.barrier.wait()
        except BaseException as e:  # re-raised below, in the test's thread
            errors.append(e)
            board.barrier.abort()

    threads = [threading.Thread(target=one, args=(i,)) for i in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return torch.cat(outs, dim=-2) if rows_out else outs


def _seeded(*shape, seed=0, scale=1.0):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * scale


def _conv(k, stride=1, dilation=1):
    torch.manual_seed(k * 10 + stride + dilation)
    return nn.Conv2d(4, 6, k, stride=stride, padding=dilation * (k // 2), dilation=dilation)


def _trunk(**kw):
    torch.manual_seed(7)
    return DilatedResNet(18, dtype=torch.float32, use_kernels=False, **kw).eval()


def _stem():
    w, inv, shift = _seeded(64, 3, 7, 7, seed=3, scale=0.1), _seeded(64, seed=4), _seeded(64, seed=5)
    return lambda x: spatial.windowed(lambda t: fused_stem(t, w, inv, shift, plain=True), x, 7, 2)


def _gain():
    return torch.tensor([0.7, 1.3])


def _int8(k, stride=1, dilation=1):
    torch.manual_seed(k * 10 + stride + dilation)
    return Int8Conv2d(4, 6, k, stride=stride, padding=dilation * (k // 2), dilation=dilation,
                      bias=True)


def _s2d_stem():
    """The s2d stem as ``DilatedResNet.forward`` runs it: space-to-depth,
    padding and ``conv1_s2d`` on one extended shard (the conv's own hooks,
    which the module's ``serving`` registers, stay off inside it)."""
    torch.manual_seed(17)
    trunk = DilatedResNet(18, stem="s2d", dtype=torch.float32, use_kernels=False)
    return trunk, lambda x: spatial.halo_apply(trunk._s2d_stem, x, *S2D_STEM_HALO, stride=2)


def _fold(f):
    """The 7x7/2 stem conv with a factor-f downscale folded in (the update
    stem at f=2; FlowNet's conv1 halves at f=2 and 4)."""
    w = _seeded(8, 3, 7, 7, seed=18 + f, scale=0.1)
    return lambda x: fold_downscale_conv(x, w, f, 2, 3)


# name -> (op factory: (fn, module or None), input shapes and scales, seed)
FEAT = (2, 4, 32, 12)
FLOW = (2, 2, 32, 12)
HALO_OPS = {
    "conv_k1": lambda: (_conv(1), None),
    "conv_k1_s2": lambda: (_conv(1, 2), None),
    "conv_k3": lambda: (_conv(3), None),
    "conv_k3_s2": lambda: (_conv(3, 2), None),
    "conv_k3_d2": lambda: (_conv(3, 1, 2), None),
    "conv_k5_s2": lambda: (_conv(5, 2), None),
    "conv_k7_s2": lambda: (_conv(7, 2), None),
    "max_pool": lambda: (None, lambda x: spatial.windowed(
        lambda t: F.max_pool2d(t, 3, stride=2, padding=1), x, 3, 2)),
    "upsample_x2": lambda: (None, lambda x: bilinear_upsample(x, 2)),
    "downscale_x2": lambda: (None, lambda x: resize_bilinear(
        x, (x.shape[-2] // 2, x.shape[-1] // 2))),
    "downscale_x4": lambda: (None, lambda x: resize_bilinear(
        x, (x.shape[-2] // 4, x.shape[-1] // 4))),
    # #1's plain version with flow past the clamp D; at D=10 the halo of 11
    # rows is taller than the 8-row shards at S=4 (rows of the rank after next)
    "warp_1_d6": lambda: (None, lambda f, fl: bilinear_warp(f, fl, True, 6, plain=True)),
    "warp_1_d10": lambda: (None, lambda f, fl: bilinear_warp(f, fl, True, 10, plain=True)),
    "warp_unbounded": lambda: (None, lambda f, fl: bilinear_warp(f, fl, False, 6)),
    "upsample_argmax_2": lambda: (None, lambda x: upsample_argmax(
        x, (16 * x.shape[-2], 16 * x.shape[-1]), plain=True)),
    "fused_stem_3": lambda: (None, _stem()),
    "warp_onehot_4": lambda: (None, lambda f, fl, s: warp_onehot(
        f, fl, s, 4, _gain(), weights_dtype=torch.float32, plain=True)),
    "dilated_conv_5": lambda: (DilatedConv3x3(8, 8, 2, use_kernels=False), None),
    "group_norm": lambda: (GroupNorm16(32), None),
    # int8 convs: the activation scale maxed over the group (S2D and folds below)
    "int8_conv_k3_s2": lambda: (_int8(3, 2), None),
    "int8_conv_k3_d2": lambda: (_int8(3, 1, 2), None),
    "int8_conv_k1": lambda: (_int8(1), None),
    "s2d_stem": _s2d_stem,
    "fold_f2": lambda: (None, _fold(2)),
    "fold_f4": lambda: (None, _fold(4)),
    "resnet18_fused7": lambda: (_trunk(stem="fused7", norm="frozenbn"), None),
    "resnet18_groupnorm_os8_pallas": lambda: (_trunk(output_stride=8, norm="groupnorm",
                                                     dilated_conv="pallas"), None),
}
INPUTS = {
    "s2d_stem": (((2, 3, 64, 16), 1.0),),
    "fold_f2": (((2, 3, 64, 24), 1.0),),
    "fold_f4": (((2, 3, 64, 40), 1.0),),
    "warp_1_d6": ((FEAT, 1.0), (FLOW, 4.0)),
    "warp_1_d10": ((FEAT, 1.0), (FLOW, 6.0)),
    "warp_unbounded": (((2, 80, 32, 12), 1.0), (FLOW, 4.0)),
    "upsample_argmax_2": (((2, 19, 32, 12), 1.0),),
    "fused_stem_3": (((2, 3, 64, 16), 1.0),),
    "warp_onehot_4": ((FEAT, 1.0), (FLOW, 3.0), (FEAT, 1.0)),
    "dilated_conv_5": (((2, 8, 32, 12), 1.0),),
    "group_norm": (((2, 32, 32, 12), 1.0),),
    "resnet18_fused7": (((1, 3, 64, 32), 1.0),),
    "resnet18_groupnorm_os8_pallas": (((1, 3, 64, 32), 1.0),),
}


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", list(HALO_OPS))
def test_halo_op_matches_the_unsharded_op(name, size):
    module, fn = HALO_OPS[name]()
    fn = fn or module
    inputs = tuple(_seeded(*shape, seed=i, scale=scale)
                   for i, (shape, scale) in enumerate(INPUTS.get(name, ((FEAT, 1.0),))))

    def recorded(*xs):
        with quant.scales_recorded() as scales:
            return fn(*xs), scales

    with torch.inference_mode():
        want, want_scales = recorded(*inputs)
        outs = run_sharded(recorded, inputs, size, module, rows_out=False)
    got = torch.cat([out for out, _ in outs], dim=-2)
    assert got.shape == want.shape and got.dtype == want.dtype
    if want.dtype == torch.uint8 or want_scales:
        # an int8 conv: every thread quantizes with the unsharded call's
        # scale, and its int32 accumulators are the unsharded call's, so
        # the output is too, bit for bit
        assert all(len(scales) == len(want_scales) and all(map(torch.equal, scales, want_scales))
                   for _, scales in outs)
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_mean_and_sums_cover_the_whole_frame():
    x = _seeded(2, 3, 32, 8, seed=9)
    with torch.inference_mode():
        for size in (2, 4):
            outs = run_sharded(lambda t: spatial.mean(t, (1, 2, 3), keepdim=True), (x,), size,
                               rows_out=False)
            for out in outs:
                torch.testing.assert_close(out, x.mean(dim=(1, 2, 3), keepdim=True),
                                           rtol=1e-6, atol=1e-7)


def test_halo_arithmetic():
    # 'same' convs: padding above, dilation*(k-1)-padding below, at the stride
    assert spatial.window_halo(1) == (0, 0) and spatial.window_halo(1, 2) == (0, 0)
    assert spatial.window_halo(3) == (1, 1) and spatial.window_halo(5, 2) == (2, 2)
    assert spatial.window_halo(3, 1, 6) == (6, 6)        # #5 at d: d / d
    assert spatial.window_halo(7, 2) == (4, 4)           # the stem, #3: 3 rounded up to 2
    assert spatial.window_halo(3, 2, padding=1) == (2, 2)  # the max pool
    # the fused stem and the max pool on one shard: input rows 4o-5..4o+5 at stride 4
    assert STEM_POOL_HALO == (8, 8)
    # the s2d stem: space-to-depth rows o-2..o+1 (2 rows of padding above, 1
    # below) are input rows 2o-4..2o+3: 4 above, 2 below the shard's last 2 rows
    assert S2D_STEM_HALO == (4, 2)
    # the folds of a 7x7/2 conv (padding 3): f=2, 16 taps at stride 4 from
    # row 4o-7; f=4, 32 taps at stride 8 from row 8o-14: lo rows above,
    # taps - lo - f*2 below; extend rounds both up to the stride
    assert fold_halo(2, 7, 2, 3) == (7, 5) and fold_halo(4, 7, 2, 3) == (14, 10)
    # each maps an extended shard of any whole number of strides onto
    # whole output rows (the crop's check): ext/4 and ext/8 rows
    for f, ext in ((2, 8 + 32 + 8), (4, 16 + 64 + 16)):
        y = fold_downscale_conv(torch.zeros(1, 3, ext, 8), torch.zeros(1, 3, 7, 7), f, 2, 3)
        assert y.shape[-2] == ext // (2 * f)
        t, h = 8 * (f // 2), 32 * (f // 2)
        assert spatial.crop(y, t, h, ext).shape[-2] == h // (2 * f)
    conv = nn.Conv2d(3, 8, 7, stride=2, padding=3)
    assert spatial.conv_halo(conv) == (4, 4, 2)
    assert spatial.conv_halo(DilatedConv3x3(8, 8, 4, use_kernels=False)) == (4, 4, 1)
    # resizes: the x2 (any integer) upscale a row each side; the antialiased
    # x2 downscale's taps -1..2, x4's -2..5, at the factor's stride
    assert resize_halo(8, 16) == (1, 1, 1) and resize_halo(4, 64) == (1, 1, 1)
    assert resize_halo(16, 8) == (1, 1, 2) and resize_halo(16, 4) == (2, 2, 4)
    assert resize_halo(8, 8) == (0, 0, 1)
    with pytest.raises(ValueError, match="integer factors"):
        resize_halo(12, 8)
    # a crop maps the shard onto whole output rows, or raises
    y = torch.arange(10.0).view(1, 10, 1)
    assert spatial.crop(y, 2, 4, 10).flatten().tolist() == [2, 3, 4, 5]
    with pytest.raises(RuntimeError, match="whole rows"):
        spatial.crop(y[:, :5], 1, 4, 10)


def test_refusals():
    meta = dict(device="meta", dtype=torch.float32)
    # frames: H/S must divide by the model's largest row stride (FlowNet's
    # 64 * flow_input_downscale), checked before any exchange
    model = AccelNet(ref_depth=18, update_depth=18, **meta)
    assert model.row_stride == 128
    assert AccelNet(family="dff", flow_input_downscale=4, ref_depth=18, **meta).row_stride == 256
    assert AccelNet(family="deeplab", ref_depth=18, **meta).row_stride == 16
    with ThreadShard(Board(1), 2, 0).serving(model):
        with pytest.raises(ValueError, match="shards of 64 rows.*row stride 128"):
            tpipe.clip_logits(model, torch.zeros((1, 2, 3, 64, 128), device="meta"), 2)
    # a gradient through the exchange (``test_torch_spatial_train.py`` holds
    # every op's): the threads' input gradients, put together, are the
    # unsharded conv's
    conv = _conv(3)
    x = _seeded(*FEAT).requires_grad_()
    (want,) = torch.autograd.grad(conv(x).square().sum(), x)

    def grad_of(t):
        t = t.clone().requires_grad_()
        return torch.autograd.grad(conv(t).square().sum(), t)[0]

    torch.testing.assert_close(run_sharded(grad_of, (x.detach(),), 2, conv), want,
                               rtol=0, atol=1e-5)
    # no spatial axis: nothing is hooked or exchanged
    with spatial.spatial_sharding(None, conv) as shard:
        assert shard is None and spatial.active() is None and not conv._forward_pre_hooks


# ---- whole models on two gloo ranks against the JAX spatial mesh ----------------

ACCEL = dict(family="accel", ref_depth=18, update_depth=18, head_channels=32)
# the smallest frames the row rule admits at S=2: H/S divisible by FlowNet's
# 64 * flow_input_downscale (16 for DeepLab), W by the same
SMALL = (128, 64)
MODELS = {
    # the flagship's norm: groupnorm, conv7, mean1 (the cascade's renormalization too)
    "accel_groupnorm_mean1": (dict(ACCEL, norm="groupnorm", scale_field_norm="mean1",
                                   scale_cascade="mean1"), 2, "incremental", 3.0, HW),
    # the bench row's norm and stem, frozenbn + fused7 (#3), at FlowNet input
    # downscale 1: the JAX fused stem runs in interpret mode, slowly
    "accel_frozenbn_fused7": (dict(ACCEL, stem="fused7", flow_input_downscale=1), 2,
                              "direct", 3.0, SMALL),
    # the DFF row's warp (#4, fused scale and mean1 gain), flow_y past D=4
    "dff_onehot": (dict(family="dff", ref_depth=18, head_channels=64, stem="fused7",
                        flow_input_downscale=1, flow_width_mult=0.5, warp_gather="onehot",
                        warp_dtype="native", warp_max_disp=4, scale_field_norm="mean1",
                        warp_gain_fold=True), 2, "direct", 6.0, SMALL),
    # per-frame DeepLab with every dilated conv through #5's plain version
    "deeplab_pallas": (dict(family="deeplab", ref_depth=18, head_channels=32,
                            dilated_conv="pallas"), 1, "direct", None, (64, 64)),
    # int8 in both branches (each call's scale maxed over the ranks), the
    # s2d stem and FlowNet's folded downscale (f=2: 16 taps at stride 4);
    # FlowNet at a quarter of its width here and below, to spare the CPU
    "accel_int8_s2d_foldflow": (dict(ACCEL, quantize_ref=True, quantize_update=True,
                                     stem="s2d", fold_flow_downscale=True,
                                     flow_width_mult=0.25), 2, "incremental", 3.0, HW),
    # the update branch on half-resolution frames, its downscale folded into
    # its conv7 stem (f=2)
    "accel_foldupdate": (dict(ACCEL, update_input_downscale=2, fold_update_downscale=True,
                              flow_input_downscale=1, flow_width_mult=0.25), 2, "direct",
                         3.0, SMALL),
}
# int8 models against the JAX package at ``test_torch_quant.py``'s end-to-end
# tolerance (one f32 ulp at a rounding boundary moves a whole int8 step):
# the logits within a relative L2 error of 5e-2, the class maps on >= 0.95
# of the pixels
INT8_REL_L2, INT8_AGREE = 5e-2, 0.95
EVAL_MODEL, EVAL_INTERVAL = "accel_groupnorm_mean1", 2
ENTRY_CFG = """\
network:
  name: accel
  ref_depth: 18
  update_depth: 18
  head_channels: 32
  dtype: float32
  norm: groupnorm
  propagate: incremental
TEST:
  KEY_FRAME_INTERVAL: 2
  BATCH_IMAGES: 1
tpu:
  mesh:
    spatial: {spatial}
output_path: {root}/out
SCALES: [[{h}, {h}]]
dataset:
  dataset: CityScape
  dataset_path: {data}
  root_path: {root}/entry
  test_image_set: leftImg8bit_val
"""


def _flow_scaled(tm, variables, clip, target):
    """The flow head of both packages' weights rescaled so that the largest
    flow between the clip's first two frames is ``target`` feature pixels
    (the JAX CPU warp is the unclamped oracle where the port clamps to D)."""
    if target is not None:
        with torch.no_grad():
            flow, _ = tm.flow(nchw(clip[:, 1]), nchw(clip[:, 0]))
        head = variables["params"]["flownet"]["predict_flow2"]
        gain = np.float32(target / float(flow.abs().max()))
        head["kernel"], head["bias"] = head["kernel"] * gain, head["bias"] * gain
        load_flax_variables(tm, variables)
    return tm.eval()


@pytest.fixture(scope="module")
def sp(tmp_path_factory):
    """The models, their clips, the eval batches and the entry point's
    tree; starts the two ranks."""
    root = tmp_path_factory.mktemp("spatial")
    models, spec_models = {}, {}
    for i, (name, (knobs, interval, propagate, flow, hw)) in enumerate(MODELS.items()):
        jm, variables, tm = bridged_models(knobs, hw[0], seed=70 + i)
        rng = np.random.default_rng(80 + i)
        clip = (rng.standard_normal((1, 2, *hw, 3)) * 0.5).astype(np.float32)
        tm = _flow_scaled(tm, variables, clip, flow)
        models[name] = (jm, variables, tm, clip, interval, propagate)
        spec_models[name] = {"knobs": knobs, "state_dict": tm.state_dict(),
                             "clip": torch.from_numpy(clip), "interval": interval,
                             "propagate": propagate}
    rng = np.random.default_rng(90)
    items = []
    for _ in range(2):
        label = np.full((1, 2, *HW), 255, np.int32)
        label[:, 1] = rng.integers(0, 19, (1, *HW))
        items.append({"clip": (rng.standard_normal((1, 2, *HW, 3)) * 0.5).astype(np.float32),
                      "label": label})
    data = write_cityscapes_tree(root, HW[0], HW[0], snippets=1, seed=91)
    cfgs = {}
    for name, s in (("entry_spatial", SPATIAL), ("entry_one", 1)):
        cfgs[name] = root / f"{name}.yaml"
        cfgs[name].write_text(ENTRY_CFG.format(spatial=s, root=root, h=HW[0], data=data))
    argv = ["--random-weights", "--max-items", "2", "--device", "cpu"]
    spec_path = root / "spec.pt"
    torch.save({"spatial": SPATIAL, "init": f"file://{root / 'rendezvous'}",
                "cfg": str(cfgs["entry_spatial"]), "f32_taps": True, "models": spec_models,
                "eval": {"model": EVAL_MODEL, "items": items, "interval": EVAL_INTERVAL,
                         "propagate": "incremental"},
                "entry": {"argv": ["--cfg", str(cfgs["entry_spatial"]), *argv],
                          "port": free_port()}}, spec_path)
    ranks = Ranks(spec_path, SPATIAL)
    try:
        yield {"models": models, "items": items, "ranks": ranks,
               "entry_one": ["--cfg", str(cfgs["entry_one"]), *argv]}
    finally:
        ranks.close()


@pytest.fixture(scope="module")
def jax_refs(sp):
    """The JAX side, while the ranks run: each model's ``clip_logits`` on a
    clip sharded on H over ``make_mesh(data=1, spatial=2)``, and the eval
    model's ``pred_eval_clips`` under that mesh with ``shard_spatial``."""
    mesh = make_mesh(data=1, spatial=SPATIAL)
    logits = {}
    with pytest.MonkeyPatch.context() as mp:
        # f32 tap weights in the JAX one-hot warp (``f32_tap_weights``)
        mp.setattr(jwo, "warp_onehot_fwd",
                   functools.partial(jwo.warp_onehot_fwd, weights_dtype=jnp.float32))
        for name, (jm, variables, _, clip, interval, propagate) in sp["models"].items():
            run = jax.jit(lambda v, c, jm=jm, k=interval, p=propagate:
                          jpipe.clip_logits(jm, v, c, k, p))
            logits[name] = np.asarray(run(jax.device_put(variables, replicated(mesh)),
                                          jax.device_put(jnp.asarray(clip),
                                                         batch_sharding(mesh, spatial_axis=2))))
    jm, variables = sp["models"][EVAL_MODEL][:2]
    miou, _, stats = jpred.pred_eval_clips(jm, variables, iter(sp["items"]), 19, EVAL_INTERVAL,
                                           "incremental", mesh=mesh, shard_spatial=True)
    return logits, (miou, stats)


@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_clip_matches_the_jax_spatial_mesh(sp, jax_refs, name, f32_tap_weights):  # noqa: F811
    _, _, tm, clip, interval, propagate = sp["models"][name]
    want = jax_refs[0][name]
    ranks = sp["ranks"].results()
    assert ranks[0]["backend"] == "gloo"
    got = np.concatenate([nhwc(r[name]["logits"]) for r in ranks], axis=-3)
    preds = torch.cat([r[name]["preds"] for r in ranks], dim=-2)
    with quant.scales_recorded() as one_scales:
        one = tpipe.clip_predictions(tm, torch.from_numpy(clip), interval, propagate)
    assert preds.shape == one.shape == (1, 2, *clip.shape[2:4])
    assert torch.equal(preds, one)
    j_full = np.asarray(j_resize(jnp.asarray(want[0]), clip.shape[2:4]))
    if one_scales:
        # each int8 call's scale the same on both ranks, and the one
        # process's within f32 rounding of its activations
        assert len(one_scales) == len(ranks[0][name]["scales"]) > 0
        for r in ranks:
            assert all(map(torch.equal, r[name]["scales"], ranks[0][name]["scales"]))
            torch.testing.assert_close(torch.stack(r[name]["scales"]), torch.stack(one_scales),
                                       rtol=1e-6, atol=0)
        assert np.linalg.norm(got - want) <= INT8_REL_L2 * np.linalg.norm(want)
        assert (preds[0].numpy() == j_full.argmax(-1)).mean() >= INT8_AGREE
    else:
        assert_close(got, want)
        np.testing.assert_array_equal(preds[0].numpy(), j_full.argmax(-1))
    # GroupNorm's and mean1's reductions over H, and only those
    knobs = MODELS[name][0]
    reduces = knobs.get("norm") == "groupnorm" or knobs.get("scale_field_norm") == "mean1"
    for r, out in enumerate(ranks):
        assert out[name]["halo"]["exchanges"] > 0, (r, out[name]["halo"])
        assert (out[name]["halo"]["reductions"] > 0) == reduces, out[name]["halo"]


def test_sharded_eval_matches_the_jax_spatial_mesh(sp, jax_refs):
    jmiou, jstats = jax_refs[1]
    tm = sp["models"][EVAL_MODEL][2]
    miou, _, stats = tpred.pred_eval_clips(tm, iter(sp["items"]), 19, EVAL_INTERVAL,
                                           "incremental")
    for out in sp["ranks"].results():
        got = out["eval"]
        np.testing.assert_array_equal(got["stats"]["confusion"], stats["confusion"])
        # the JAX package's IoU arithmetic rounds in f32 (~5e-10 here); one
        # pixel's class would move the mIoU by > 1e-6
        assert got["miou"] == miou and abs(miou - jmiou) <= 1e-7, (miou, jmiou)
        assert got["stats"]["frames"] == stats["frames"] == jstats["frames"] == 4
        assert got["stats"]["halo"]["gathers"] == 2


def test_eval_entry_point_with_a_spatial_mesh_gives_the_one_process_confusion(sp):
    (want,) = t_entry.main(sp["entry_one"])
    for out in sp["ranks"].results():
        got = out["entry"]
        np.testing.assert_array_equal(got["stats"]["confusion"], want["stats"]["confusion"])
        assert got["miou"] == want["miou"] and got["stats"]["frames"] == 4
        assert got["stats"]["halo"]["exchanges"] > 0
