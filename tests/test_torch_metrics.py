"""The port's metrics (``accel_tpu_torch/core/metrics.py``) against
``accel_tpu.core.metrics`` on numpy-seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from accel_tpu.core import metrics as jm
from accel_tpu_torch.core import metrics as tm

torch.set_num_threads(2)
C = 19


def _maps(seed: int, shape=(2, 3, 24, 40)):
    """Class maps and labels with ignore (255) pixels and labels >= C."""
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, C, shape).astype(np.uint8)
    label = rng.integers(0, C, shape).astype(np.int32)
    label[rng.random(shape) < 0.2] = 255
    label[rng.random(shape) < 0.05] = C + 3
    agree = rng.random(shape) < 0.5
    pred[agree] = np.where(label[agree] < C, label[agree], 0)
    return pred, label


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_confusion_matrix_is_exact(seed):
    pred, label = _maps(seed)
    got = tm.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label), C)
    assert got.dtype == torch.int64 and tuple(got.shape) == (C, C)
    want = np.asarray(jm.confusion_matrix(jnp.asarray(pred), jnp.asarray(label), C))
    np.testing.assert_array_equal(got.numpy(), want)
    # by hand: every valid pixel counted once, at (label, pred)
    valid = (label != 255) & (label < C)
    hand = np.zeros((C, C), np.int64)
    np.add.at(hand, (label[valid], pred[valid].astype(np.int64)), 1)
    np.testing.assert_array_equal(got.numpy(), hand)
    assert int(got.sum()) == int(valid.sum())


def test_predictions_outside_the_classes_are_dropped():
    """A prediction >= C counts nowhere, as the reference's one-hot of it
    is all zero."""
    pred = np.array([[0, 1, 20, 3]], np.int32)
    label = np.array([[0, 1, 2, 255]], np.int32)
    got = tm.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label), 4).numpy()
    want = np.asarray(jm.confusion_matrix(jnp.asarray(pred), jnp.asarray(label), 4))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 2


@pytest.mark.parametrize("seed", [0, 3])
def test_miou_from_confusion(seed):
    rng = np.random.default_rng(seed)
    cm = rng.integers(0, 50, (C, C)).astype(np.float64)
    cm[4] = 0  # a class absent from the ground truth
    cm[:, 7] = 0
    miou, iou = tm.miou_from_confusion(cm)
    jmiou, jiou = jm.miou_from_confusion(jnp.asarray(cm))
    assert abs(float(miou) - float(jmiou)) <= 1e-6
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), atol=1e-6, rtol=0)
    assert float(tm.miou_from_confusion(np.zeros((C, C)))[0]) == 0.0


@pytest.mark.parametrize("ohem", [None, 0.3, 1e-4])
def test_softmax_cross_entropy(ohem):
    """NCHW logits against the reference's channels-last ones, 1e-5
    relative, with ignore pixels and labels >= C, with and without OHEM."""
    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((2, 12, 20, C)) * 3).astype(np.float32)
    _, label = _maps(8, shape=(2, 12, 20))
    want = float(jm.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(label), C,
                                          loss_scale=2.0, ohem_fraction=ohem))
    got = float(tm.softmax_cross_entropy(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                         torch.from_numpy(label), C, loss_scale=2.0,
                                         ohem_fraction=ohem))
    assert abs(got - want) <= 1e-5 * abs(want)


def test_accumulator_over_batches():
    jacc, tacc = jm.SegConfusionAccumulator(C), tm.SegConfusionAccumulator(C)
    for seed in range(4):
        pred, label = _maps(10 + seed)
        jacc.update(jnp.asarray(pred), jnp.asarray(label))
        tacc.update(torch.from_numpy(pred), label)  # a numpy label goes to pred's device
    np.testing.assert_array_equal(tacc.cm, jacc.cm)
    (miou, iou), (jmiou, jiou) = tacc.result(), jacc.result()
    assert abs(miou - jmiou) <= 1e-6
    np.testing.assert_allclose(iou, jiou, atol=1e-6, rtol=0)


def test_log_loss_metric():
    got, want = tm.FCNLogLossMetric(), jm.FCNLogLossMetric()
    for s, n in ((3.0, 4), (1.5, 2)):
        got.update(s, n)
        want.update(s, n)
    assert got.get() == want.get() == ("FCNLogLoss", 0.75)
    got.reset()
    assert got.get() == ("FCNLogLoss", 0.0)
