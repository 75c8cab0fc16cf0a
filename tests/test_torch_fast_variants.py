"""The bench's fast Accel variants in the port against ``accel_tpu``'s
``AccelNet``: ``accel18_fast`` (the update branch on half-resolution
frames with a narrower fc6, FlowNet at half width) and ``accel18_os8mixed``
(the reference branch at stride 8, the update branch at stride 16, its
scores resized onto the stride-8 grid), at tiny size: R18/R18, head 32
(the fast update head 16), 128x128, f32, the same seeded weights on both
sides and live flow heads.

Update-branch scores and clip logits within 1e-4 * (1 + max|ref|)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_close, bridged_models, nchw, nhwc

from accel_tpu.core import pipeline as jpipe
from accel_tpu_torch.core import pipeline as tpipe
from accel_tpu_torch.models.accel import AccelNet, build_model

torch.set_num_threads(2)
HW, K = 128, 4
BASE = dict(family="accel", ref_depth=18, update_depth=18, num_classes=19, head_channels=32)
VARIANTS = {
    # bench.py's accel18_fast knobs, the fc6 widths scaled down with the model
    "fast": dict(update_head_channels=16, update_input_downscale=2, flow_width_mult=0.5),
    # bench.py's accel18_os8mixed knobs; D=16, as the seeded flow moves up
    # to 12 stride-8 pixels and only the port clamps it
    "os8mixed": dict(feat_stride=8, update_feat_stride=16, warp_max_disp=16),
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    jm, v, tm = bridged_models(dict(BASE, **VARIANTS[request.param]), HW, seed=131)
    clip = (np.random.default_rng(132).standard_normal((1, K, HW, HW, 3)) * 0.5
            ).astype(np.float32)
    return request.param, jm, v, tm, clip


def test_update_input_downscale_shapes():
    """Mirrors ``tests/test_norm_ohem.py::test_update_input_downscale_shapes``:
    the half-resolution update branch's scores are resized back onto the
    feature grid."""
    m = AccelNet(ref_depth=18, update_depth=18, head_channels=16, update_input_downscale=2,
                 update_head_channels=16, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        s = m.update_scores(torch.zeros((1, 3, 128, 128)))
    assert tuple(s.shape) == (1, 19, 8, 8)


def test_variant_modules(variant):
    name, _, _, tm, _ = variant
    head = tm.update_net.head.fc6
    if name == "fast":
        assert head.out_channels == 16 and tm.ref_net.head.fc6.out_channels == 32
        assert tm.update_input_downscale == 2
    else:
        assert head.out_channels == 32 and tm.feat_stride == 8


def test_update_scores_match_jax(variant):
    _, jm, v, tm, clip = variant
    frames = clip[:, :2].reshape(2, HW, HW, 3)
    want = np.asarray(jm.apply(v, jnp.asarray(frames), method="update_scores"))
    with torch.no_grad():
        got = tm.update_scores(nchw(frames))
    hw = HW // tm.feat_stride
    assert tuple(got.shape) == (2, 19, hw, hw)
    assert_close(nhwc(got), want)


@pytest.mark.parametrize("propagate", ["direct", "incremental"])
def test_variant_clip_matches_jax(variant, propagate):
    _, jm, v, tm, clip = variant
    flow, _ = jm.apply(v, jnp.asarray(clip[:, 1]), jnp.asarray(clip[:, 0]), method="flow")
    m = float(np.abs(np.asarray(flow)).max())
    # live, and inside the port's warp clamp (the JAX CPU warp has none)
    assert 0.5 < m < tm.warp_max_disp, m
    want = np.asarray(jpipe.clip_logits(jm, v, jnp.asarray(clip), K, propagate))
    got = tpipe.clip_logits(tm, nchw(clip), K, propagate)
    hw = HW // tm.feat_stride
    assert tuple(got.shape) == (1, K, 19, hw, hw)
    assert_close(nhwc(got), want)


def test_build_model_takes_the_fast_knobs():
    """build_model passes the three update-branch knobs through, inherits
    where they are 0, and folds the update downscale into the update
    branch's stem where asked."""
    gen = torch.Generator().manual_seed(3)
    m = build_model(dict(BASE, name="accel", dtype="float32", update_head_channels=16,
                         update_input_downscale=2, update_feat_stride=8),
                    device="cpu", generator=gen)
    assert m.update_net.head.fc6.out_channels == 16 and m.update_input_downscale == 2
    assert m.update_net.backbone.layer4_block0.conv2.dilation == (4, 4)  # stride 8
    inherit = build_model(dict(BASE, name="accel", dtype="float32", update_head_channels=0,
                               update_feat_stride=0), device="cpu", generator=gen)
    assert inherit.update_net.head.fc6.out_channels == 32
    assert inherit.update_net.backbone.layer4_block0.conv2.dilation == (2, 2)  # stride 16
    folded = build_model(dict(BASE, name="accel", dtype="float32", update_input_downscale=2,
                              fold_update_downscale=True), device="cpu", generator=gen)
    assert folded.update_net.backbone.input_downscale == 2
    assert folded.ref_net.backbone.input_downscale == 1
