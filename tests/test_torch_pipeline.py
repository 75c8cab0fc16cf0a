"""The port's Accel clip-inference slice end to end vs
``accel_tpu.core.pipeline``: a tiny accel model (R18/R18, 128x128, head 32,
f32) with the same seeded weights on both sides and live flow heads, F=10
at k=5 so two keyframe groups run. Logits within 1e-4 * (1 + max|ref|);
class maps agree on >= 0.999 of the pixels."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_argmax_agrees, assert_close, nchw, nhwc, seeded_variables

from accel_tpu.core import pipeline as jpipe
from accel_tpu.models.accel import AccelNet as JAccelNet
from accel_tpu.ops.upsample import resize_bilinear as j_resize
from accel_tpu_torch.convert import load_flax_variables
from accel_tpu_torch.core import pipeline as tpipe
from accel_tpu_torch.core.serving import VideoSegmenter
from accel_tpu_torch.models.accel import AccelNet, build_model

torch.set_num_threads(2)
TINY = dict(ref_depth=18, update_depth=18, num_classes=19, feat_stride=16, head_channels=32)


@pytest.fixture(scope="module")
def tiny():
    jm = JAccelNet(family="accel", dtype=jnp.float32, use_pallas_warp=True, **TINY)
    cur = jnp.zeros((1, 128, 128, 3))
    v = seeded_variables(jm, cur, cur, jnp.ones((1,)), train=False, seed=11)
    tm = AccelNet(**TINY, device="cpu", dtype=torch.float32)
    load_flax_variables(tm, v)
    clip = (np.random.default_rng(12).standard_normal((1, 10, 128, 128, 3)) * 0.5
            ).astype(np.float32)
    return jm, v, tm, clip


def test_flow_is_live_and_inside_the_bound(tiny):
    """The seeded flow heads move content by more than half a feature pixel
    and stay under D=8, where the port's clamped warp equals the JAX CPU
    path's unclamped oracle."""
    jm, v, tm, clip = tiny
    flow, _ = jm.apply(v, jnp.asarray(clip[:, 1]), jnp.asarray(clip[:, 0]), method="flow")
    m = float(np.abs(np.asarray(flow)).max())
    assert 0.5 < m < 8.0, m


@pytest.mark.parametrize("propagate,cascade,norm", [
    ("incremental", "last", "none"),
    ("incremental", "product", "none"),
    ("direct", "last", "none"),
    ("incremental", "last", "mean1"),
])
def test_clip_matches_jax(tiny, propagate, cascade, norm):
    jm, v, tm, clip = tiny
    jm = jm.clone(scale_cascade=cascade, scale_field_norm=norm)
    tm.scale_cascade, tm.scale_field_norm = cascade, norm
    jclip = jnp.asarray(clip)
    want = np.asarray(jpipe.clip_logits(jm, v, jclip, 5, propagate))
    got = tpipe.clip_logits(tm, nchw(clip), 5, propagate)
    assert tuple(got.shape) == (1, 10, 19, 8, 8)
    assert_close(nhwc(got), want)

    pred = tpipe.clip_predictions(tm, torch.from_numpy(clip), 5, propagate)
    assert pred.dtype == torch.uint8 and tuple(pred.shape) == (1, 10, 128, 128)
    jpred = np.asarray(jpipe.clip_predictions(jm, v, jclip, 5, propagate))
    full = np.asarray(j_resize(jnp.asarray(want[0]), (128, 128)))[None]
    assert_argmax_agrees(pred.numpy(), jpred, full, min_agree=0.999)

    small = tpipe.clip_predictions(tm, torch.from_numpy(clip), 5, propagate, full_res=False)
    jsmall = np.asarray(jpipe.clip_predictions(jm, v, jclip, 5, propagate, full_res=False))
    assert_argmax_agrees(small.numpy(), jsmall, want, min_agree=0.999)


def test_push_group_serves_clip_predictions(tiny):
    _, _, tm, clip = tiny
    tm.scale_cascade, tm.scale_field_norm = "last", "none"
    seg = VideoSegmenter(tm, interval=5, propagate="incremental")
    frames = torch.from_numpy(clip)
    for g in range(2):
        assert seg.is_keyframe_next
        got = seg.push_group(frames[:, 5 * g:5 * g + 5])
        want = tpipe.clip_predictions(tm, frames[:, 5 * g:5 * g + 5], 5, "incremental")
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="interval"):
        seg.push_group(frames[:, :4])
    # a frame pushed on its own leaves the schedule mid-group
    seg.push_frame(frames[:, 0])
    with pytest.raises(ValueError, match="mid-group"):
        seg.push_group(frames[:, 5:])


def test_unported_modes_raise(tiny):
    _, _, tm, clip = tiny
    with pytest.raises(ValueError, match="propagate"):
        tpipe.clip_logits(tm, nchw(clip), 5, "sideways")
    with pytest.raises(ValueError, match="divisible"):
        tpipe.clip_logits(tm, nchw(clip), 3)
    with pytest.raises(ValueError, match="dilated_conv"):
        build_model({"dilated_conv": "sideways"}, device="cpu", generator=torch.Generator())
    # use_scale_field: false is ported: a FlowNet without the scale-field head
    model = build_model({"use_scale_field": False, "ref_depth": 18, "head_channels": 32},
                        device="meta", generator=torch.Generator())
    assert not hasattr(model.flownet, "scale_field")


@pytest.mark.parametrize("n,chunk", [(5, 5), (20, 20), (25, 5), (40, 20)])
def test_chunked_apply(n, chunk):
    sizes = []

    def fn(x):
        sizes.append(x.shape[0])
        return x * 2

    x = torch.arange(n, dtype=torch.float32).view(n, 1)
    torch.testing.assert_close(tpipe._chunked_apply(fn, x), x * 2)
    assert set(sizes) == {chunk}


def test_build_model_is_seeded():
    cfg = dict(TINY, flow_width_mult=0.25, dtype="float32", stem="fused7")
    a = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    b = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    c = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["ref_net.backbone.conv1.weight"],
                           sc["ref_net.backbone.conv1.weight"])
    # flax's init: identity warp and modulation, averaging fusion
    assert not a.flownet.predict_flow2.weight.any()
    assert torch.equal(a.flownet.scale_field.bias, torch.ones(19))
    assert torch.equal(a.fusion.weight[:, :19, 0, 0], 0.5 * torch.eye(19))


def test_build_model_defaults_to_the_card():
    """Without ``device`` the model is built on the card; where there is
    none, build_model raises rather than fall back to the CPU."""
    cfg = dict(TINY, dtype="float32")
    if torch.cuda.is_available():
        model = build_model(cfg, generator=torch.Generator().manual_seed(3))
        assert all(p.device.type == "cuda" for p in model.parameters())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg, generator=torch.Generator().manual_seed(3))
