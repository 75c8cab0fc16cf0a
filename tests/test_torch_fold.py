"""The port's folded downscales against ``accel_tpu``'s: the fold conv
(``ops/fold_downscale.py``) against ``fold_downscale_conv_fn``, FlowNet's
conv1 partials against the JAX ``_Conv1`` roles and the pair conv, and a
tiny Accel model with ``fold_update_downscale`` and ``fold_flow_downscale``
through ``clip_predictions`` and ``push_frame``.

The fold is held against the JAX fold, edge ring included (it differs from
resize + conv there, on both sides: ``fold_downscale.py``'s docstring). In
f32 the outputs agree within 1e-5 * (1 + max|ref|) (f32 sums taken in
another order); the model's logits within 1e-4 * (1 + max|ref|), as the
other pipeline parity tests hold them, and its class maps on >= 0.999 of
the pixels, every disagreement at a near-tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch_parity import assert_argmax_agrees, assert_close, bridged_models, nchw, nhwc

from accel_tpu.core import pipeline as jpipe
from accel_tpu.core.serving import VideoSegmenter as JVideoSegmenter
from accel_tpu.models.flownet import FlowNetS as JFlowNetS
from accel_tpu.ops.fold_downscale import _compose_matrix as j_compose
from accel_tpu.ops.fold_downscale import fold_downscale_conv_fn
from accel_tpu.ops.upsample import _down_taps as j_down_taps
from accel_tpu_torch.core import pipeline as tpipe
from accel_tpu_torch.core.serving import VideoSegmenter
from accel_tpu_torch.models.accel import build_model
from accel_tpu_torch.models.flownet import FlowNetS
from accel_tpu_torch.ops import fold_downscale as tfold
from accel_tpu_torch.ops.upsample import _down_taps, resize_bilinear

torch.set_num_threads(2)
DN = ("NHWC", "HWIO", "NHWC")
# (factor, H, W, taps, stride, padding): the update stem, the flow stem at
# flow_input_downscale 4, a small stride-1 kernel, an odd factor
FOLDS = [(2, 32, 48, 7, 2, 3), (4, 64, 64, 7, 2, 3), (2, 24, 40, 3, 1, 1), (3, 30, 36, 5, 2, 2)]
HW, K = 128, 4
FOLD_NET = dict(family="accel", ref_depth=18, update_depth=18, head_channels=32,
                update_input_downscale=2, fold_update_downscale=True, fold_flow_downscale=True)


@pytest.mark.parametrize("f", [2, 3, 4])
def test_taps_and_compose_matrix_match_jax(f):
    offs, w = _down_taps(f)
    joffs, jw = j_down_taps(f)
    np.testing.assert_array_equal(offs, joffs)
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-15)
    for S in (3, 7):
        np.testing.assert_array_equal(tfold._compose_matrix(f, S), j_compose(f, S))


@pytest.mark.parametrize("f,H,W,S,stride,pad", FOLDS)
def test_fold_conv_matches_jax_fold(f, H, W, S, stride, pad):
    rng = np.random.default_rng(f * 100 + S)
    x = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    k = rng.standard_normal((S, S, 3, 8)).astype(np.float32)
    want = np.asarray(fold_downscale_conv_fn(f)(jnp.asarray(x), jnp.asarray(k),
                                                (stride, stride), ((pad, pad), (pad, pad)),
                                                dimension_numbers=DN))
    got = tfold.fold_downscale_conv(nchw(x), torch.from_numpy(k).permute(3, 2, 0, 1), f,
                                    stride, pad)
    assert_close(nhwc(got), want, rel=1e-5)


def test_fold_conv_is_the_resized_conv_inside_the_ring():
    """Away from the edge ring the fold is resize + conv (the JAX test's
    contract), so the port's fold computes what the knob stands for."""
    f, H, W, S, stride, pad = FOLDS[0]
    g = torch.Generator().manual_seed(4)
    x, w = torch.randn(1, 3, H, W, generator=g), torch.randn(8, 3, S, S, generator=g)
    folded = tfold.fold_downscale_conv(x, w, f, stride, pad)
    two_stage = F.conv2d(resize_bilinear(x, (H // f, W // f)), w, stride=stride, padding=pad)
    ring = 2
    torch.testing.assert_close(folded[..., ring:-ring, ring:-ring],
                               two_stage[..., ring:-ring, ring:-ring], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fold", [2, 4])
def test_stem_partials_match_jax_and_the_pair_conv(fold):
    """FlowNet's conv1 partials (cur with the bias, anchor without) against
    the JAX ``_Conv1`` roles; their sum is the pair conv of the folded
    downscale, which inside the ring is conv1 of the resized pair."""
    jnet = JFlowNetS(scale_channels=19, width_mult=0.25, dtype=jnp.float32)
    side = 64 * fold
    frame = jnp.zeros((1, side, side, 3))
    v = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, side // fold, side // fold, 6)))
    rng = np.random.default_rng(fold)
    kernel = rng.standard_normal((7, 7, 6, 16)).astype(np.float32) / 10
    bias = rng.standard_normal(16).astype(np.float32)
    v = jax.tree.map(np.asarray, v)
    v["params"]["conv1"] = {"kernel": kernel, "bias": bias}
    cur = rng.standard_normal(frame.shape).astype(np.float32)
    anchor = rng.standard_normal(frame.shape).astype(np.float32)
    tnet = FlowNetS(19, 0.25, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        tnet.conv1.weight.copy_(torch.from_numpy(kernel).permute(3, 2, 0, 1))
        tnet.conv1.bias.copy_(torch.from_numpy(bias))
    parts = {}
    for role, img in (("cur", cur), ("anchor", anchor)):
        want = np.asarray(jnet.apply(v, jnp.asarray(img), role, fold, method="stem_partial"))
        parts[role] = tnet.stem_partial(nchw(img), role, fold)
        assert_close(nhwc(parts[role]), want, rel=1e-5)
    total = parts["cur"] + parts["anchor"]
    small = torch.cat([resize_bilinear(nchw(a), (side // fold,) * 2) for a in (cur, anchor)], 1)
    pair = tnet.conv1(small)
    assert total.shape == pair.shape
    torch.testing.assert_close(total[..., 2:-2, 2:-2], pair[..., 2:-2, 2:-2], rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="role"):
        tnet.stem_partial(nchw(cur), "pair", fold)


@pytest.fixture(scope="module")
def folded():
    jm, v, tm = bridged_models(FOLD_NET, HW, seed=71)
    clip = (np.random.default_rng(72).standard_normal((1, 2 * K, HW, HW, 3)) * 0.5
            ).astype(np.float32)
    flow, _ = jm.apply(v, jnp.asarray(clip[:, 1]), jnp.asarray(clip[:, 0]), method="flow")
    m = float(np.abs(np.asarray(flow)).max())
    assert 0.5 < m < 8.0, m  # live, and inside the port's warp clamp
    return jm, v, tm, clip


def test_folded_model_has_no_resized_input(folded):
    _, _, tm, _ = folded
    assert tm.update_net.backbone.input_downscale == 2 and tm.ref_net.backbone.input_downscale == 1
    assert tm.fold_flow_downscale and tm.fold_update_downscale


@pytest.mark.parametrize("propagate", ["incremental", "direct", "composed"])
def test_folded_clip_predictions_match_jax(folded, propagate):
    jm, v, tm, clip = folded
    want = np.asarray(jpipe.clip_logits(jm, v, jnp.asarray(clip), K, propagate))
    got = tpipe.clip_logits(tm, nchw(clip), K, propagate)
    assert_close(nhwc(got), want)
    full = nhwc(F.interpolate(got[0], size=(HW, HW), mode="bilinear",
                              align_corners=False))[None]
    pred = tpipe.clip_predictions(tm, torch.from_numpy(clip), K, propagate)
    jpred = np.asarray(jpipe.clip_predictions(jm, v, jnp.asarray(clip), K, propagate))
    assert_argmax_agrees(pred.numpy(), jpred, full, min_agree=0.999)


@pytest.mark.parametrize("propagate", ["direct", "incremental"])
def test_folded_push_frame_matches_jax(folded, propagate):
    """push_frame (the key/cur predictors, 'anchor_small' carrying the
    anchor-half partial) against the JAX ``push_clip`` and the port's own
    ``push_group`` on the same frames."""
    jm, v, tm, clip = folded
    frames = torch.from_numpy(clip)
    seg = VideoSegmenter(tm, interval=K, propagate=propagate)
    loop = seg.push_clip(frames)
    key_small = VideoSegmenter(tm, interval=K, propagate=propagate)
    key_small.push_frame(frames[:, 0])
    # the cached anchor is conv1's anchor half at 1/(2 * flow_input_downscale)
    assert tuple(key_small._anchor_small.shape) == (1, 64, HW // 4, HW // 4)
    logits = tpipe.clip_logits(tm, nchw(clip), K, propagate)[0]
    full = nhwc(F.interpolate(logits, size=(HW, HW), mode="bilinear", align_corners=False))[None]
    grouped = VideoSegmenter(tm, interval=K, propagate=propagate)
    group = torch.cat([grouped.push_group(frames[:, g:g + K]) for g in range(0, 2 * K, K)], 1)
    assert_argmax_agrees(loop.numpy(), group.numpy(), full, min_agree=0.999)
    jloop = np.asarray(JVideoSegmenter(jm, v, interval=K, propagate=propagate)
                       .push_clip(jnp.asarray(clip)))
    assert_argmax_agrees(loop.numpy(), jloop, full, min_agree=0.999)


def test_build_model_takes_the_fold_knobs():
    gen = torch.Generator().manual_seed(0)
    m = build_model(dict(FOLD_NET, name="accel", dtype="float32"), device="meta", generator=gen)
    assert m.update_net.backbone.input_downscale == 2
    # a factor of 1 has nothing to fold
    m = build_model(dict(FOLD_NET, name="accel", dtype="float32", update_input_downscale=1),
                    device="meta", generator=gen)
    assert m.update_net.backbone.input_downscale == 1
    with pytest.raises(ValueError, match="conv7"):
        build_model(dict(FOLD_NET, name="accel", stem="s2d"), device="meta", generator=gen)
