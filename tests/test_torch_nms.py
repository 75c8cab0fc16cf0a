"""``accel_tpu_torch/ops/nms.py`` against ``accel_tpu/ops/nms.py``: the IoU
matrix within 1e-6 and the greedy NMS keep masks equal, on seeded boxes
whose scores repeat (a stable sort keeps equal scores in their original
order on both sides), with and without ``max_out``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accel_tpu.ops import nms as jnms
from accel_tpu_torch.ops import nms as tnms


def seeded_dets(seed: int, n: int = 60) -> np.ndarray:
    """``n`` boxes in clusters of overlapping boxes, scores from a few
    values so that many are equal."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(20, 200, (n // 6, 2)).repeat(6, axis=0)
    xy = centres + rng.normal(0, 6, (n, 2))
    wh = rng.uniform(10, 40, (n, 2))
    scores = rng.choice([0.3, 0.5, 0.5, 0.7, 0.9], n)
    return np.concatenate([xy, xy + wh, scores[:, None]], axis=1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bbox_overlaps_matches_jax(seed):
    dets = seeded_dets(seed)
    boxes, query = dets[:40, :4], dets[40:, :4]
    want = np.asarray(jnms.bbox_overlaps(jnp.asarray(boxes), jnp.asarray(query)))
    got = tnms.bbox_overlaps(torch.from_numpy(boxes), torch.from_numpy(query)).numpy()
    assert got.shape == (40, 20) and (want > 0).any() and (want == 0).any()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("seed,thresh,max_out", [(0, 0.3, None), (1, 0.5, None), (2, 0.7, None),
                                                 (3, 0.3, 5), (4, 0.5, 12), (5, 0.5, 100)])
def test_nms_keep_mask_matches_jax(seed, thresh, max_out):
    dets = seeded_dets(seed)
    assert len(np.unique(dets[:, 4])) < len(dets) // 4
    want = np.asarray(jnms.nms(jnp.asarray(dets), thresh, max_out))
    got = tnms.nms(torch.from_numpy(dets), thresh, max_out)
    assert got.dtype == torch.bool and got.shape == (len(dets),)
    np.testing.assert_array_equal(got.numpy(), want)
    kept = int(want.sum())
    assert 0 < kept < len(dets) and (max_out is None or kept <= max_out)


def test_nms_takes_equal_scores_in_their_order():
    """Two identical boxes with one score: the first is kept, the second
    suppressed, on both sides."""
    dets = np.array([[0, 0, 9, 9, 0.5], [0, 0, 9, 9, 0.5], [50, 50, 60, 60, 0.5]], np.float32)
    want = np.asarray(jnms.nms(jnp.asarray(dets), 0.5))
    np.testing.assert_array_equal(want, [True, False, True])
    np.testing.assert_array_equal(tnms.nms(torch.from_numpy(dets), 0.5).numpy(), want)
