"""PyTorch port models vs the JAX package, with the same seeded weights
moved across by the bridge (``accel_tpu_torch/convert.py``). f32 on both
sides; tolerance max|diff| <= 1e-4 * (1 + max|ref|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, nchw, nhwc, seeded_variables

from accel_tpu.models import accel as jaccel
from accel_tpu.models import deeplab as jdeeplab
from accel_tpu.models import flownet as jflownet
from accel_tpu.models import resnet as jresnet
from accel_tpu_torch.convert import load_flax_variables
from accel_tpu_torch.models.accel import AccelNet
from accel_tpu_torch.models.deeplab import DeepLab
from accel_tpu_torch.models.flownet import FlowNetS
from accel_tpu_torch.models.resnet import DilatedResNet

torch.set_num_threads(2)
F32 = dict(device="cpu", dtype=torch.float32)


def _image(seed, shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("depth,os_,norm,stem", [
    (18, 16, "frozenbn", "conv7"),
    (18, 16, "groupnorm", "conv7"),
    (18, 16, "frozenbn", "fused7"),
    (50, 8, "frozenbn", "conv7"),  # bottleneck plan, os8 dilations 2/4
])
def test_dilated_resnet(depth, os_, norm, stem):
    jm = jresnet.DilatedResNet(depth=depth, output_stride=os_, norm=norm, stem=stem,
                               dtype=jnp.float32)
    x = _image(0, (2, 64, 64, 3))
    v = seeded_variables(jm, jnp.asarray(x), train=False, seed=depth)
    tm = DilatedResNet(depth, os_, norm, stem, **F32)
    load_flax_variables(tm, v)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert got.shape == (2, 64 // os_, 64 // os_, 512 if depth == 18 else 2048)
    assert_close(got, want)


def test_bottleneck_plan():
    tm = DilatedResNet(101, 16, device="meta", dtype=torch.float32)
    assert len(tm.block_names) == 3 + 4 + 23 + 3
    last = getattr(tm, tm.block_names[-1])
    assert last.conv2.dilation == (2, 2) and last.conv3.out_channels == 2048
    assert getattr(tm, "layer3_block0").conv2.stride == (2, 2)
    assert getattr(tm, "layer4_block0").conv2.stride == (1, 1)


def test_fused7_needs_frozenbn():
    with pytest.raises(ValueError, match="frozenbn"):
        DilatedResNet(18, 16, "groupnorm", "fused7", device="meta")


def test_deeplab_modes():
    jm = jdeeplab.DeepLab(depth=18, head_channels=32, dtype=jnp.float32)
    x = _image(1, (2, 64, 64, 3))
    v = seeded_variables(jm, jnp.asarray(x), seed=1)
    tm = DeepLab(18, head_channels=32, **F32)
    load_flax_variables(tm, v)
    with torch.no_grad():
        for mode in ("full", "features"):
            want = np.asarray(jm.apply(v, jnp.asarray(x), mode=mode))
            assert_close(nhwc(tm(nchw(x), mode=mode)), want)
        feats = _image(2, (2, 4, 4, 32))
        want = np.asarray(jm.apply(v, jnp.asarray(feats), method="scores_from_features"))
        assert_close(nhwc(tm.scores_from_features(nchw(feats))), want)
        assert_close(nhwc(tm.head(nchw(feats), mode="scores")), want)


def test_flownet_perturbed_heads():
    jm = jflownet.FlowNetS(scale_channels=19, width_mult=0.5, dtype=jnp.float32)
    pair = _image(3, (2, 64, 64, 6))
    v = seeded_variables(jm, jnp.asarray(pair), seed=3)
    tm = FlowNetS(19, 0.5, **F32)
    load_flax_variables(tm, v)
    jflow, jscale = jm.apply(v, jnp.asarray(pair))
    with torch.no_grad():
        flow, scale = tm(nchw(pair))
    assert tuple(flow.shape) == (2, 2, 16, 16) and tuple(scale.shape) == (2, 19, 16, 16)
    assert np.abs(np.asarray(jflow)).max() > 0.1  # the heads are live
    assert_close(nhwc(flow), np.asarray(jflow))
    assert_close(nhwc(scale), np.asarray(jscale))


@pytest.fixture(scope="module")
def accel_pair():
    kw = dict(ref_depth=18, update_depth=18, head_channels=32, flow_width_mult=0.25)
    jm = jaccel.AccelNet(family="accel", dtype=jnp.float32, **kw)
    cur = jnp.zeros((1, 128, 128, 3))  # FlowNet input must divide by 64
    v = seeded_variables(jm, cur, cur, jnp.ones((1,)), train=False, seed=4)
    tm = AccelNet(**kw, **F32)
    load_flax_variables(tm, v)
    return jm, v, tm


@pytest.mark.parametrize("norm", ["none", "mean1"])
@pytest.mark.parametrize("normalize,modulate", [(True, True), (False, True), (True, False)])
def test_accel_warp(accel_pair, norm, normalize, modulate):
    jm, v, tm = accel_pair
    jm = jm.clone(scale_field_norm=norm)
    tm.scale_field_norm = norm
    rng = np.random.default_rng(5)
    prop = rng.standard_normal((2, 8, 12, 19)).astype(np.float32)
    flow = rng.uniform(-7.5, 7.5, (2, 8, 12, 2)).astype(np.float32)  # < D
    scale = rng.uniform(0.5, 1.5, (2, 8, 12, 19)).astype(np.float32)
    want = np.asarray(jm.apply(v, jnp.asarray(prop), jnp.asarray(flow), jnp.asarray(scale),
                               normalize_scale=normalize, modulate=modulate, method="warp"))
    got = tm.warp(nchw(prop), nchw(flow), nchw(scale), normalize_scale=normalize,
                  modulate=modulate)
    assert_close(nhwc(got), want)


def test_accel_fuse_and_flow(accel_pair):
    jm, v, tm = accel_pair
    rng = np.random.default_rng(6)
    a, b = (rng.standard_normal((2, 4, 4, 19)).astype(np.float32) for _ in range(2))
    want = np.asarray(jm.apply(v, jnp.asarray(a), jnp.asarray(b), method="fuse"))
    with torch.no_grad():
        assert_close(nhwc(tm.fuse(nchw(a), nchw(b))), want)
        cur, anchor = _image(7, (2, 128, 128, 3)), _image(8, (2, 128, 128, 3))
        jflow, jscale = jm.apply(v, jnp.asarray(cur), jnp.asarray(anchor), method="flow")
        flow, scale = tm.flow(nchw(cur), nchw(anchor))
        assert_close(nhwc(flow), np.asarray(jflow))
        assert_close(nhwc(scale), np.asarray(jscale))
        for method in ("ref_propagated", "update_scores"):
            want = np.asarray(jm.apply(v, jnp.asarray(cur), method=method))
            assert_close(nhwc(getattr(tm, method)(nchw(cur))), want)
