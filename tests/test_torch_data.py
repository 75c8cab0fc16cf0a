"""The port's data layer (``accel_tpu_torch/data``) against ``accel_tpu.data``
on Cityscapes- and CamVid-layout trees written by the test: the segdb,
frames, annotations, sequence paths and ``TestClipLoader`` batches, bit for
bit; the PNG reader against ``cv2.imread``; the prefetcher.

The port's resize, normalize and label LUT run its C++ (``native/``); the
JAX side runs the JAX package's own C++, built from its source for this
module (``torch_parity.jax_native_ops``), so the batches stay bit-equal."""

import os

import cv2
import numpy as np
import pytest
import torch
from torch_parity import jax_native_ops, write_camvid_tree, write_cityscapes_tree, write_png

from accel_tpu.config import default_config as j_default_config
from accel_tpu.data import image as jimage
from accel_tpu.data.camvid import CamVid as JCamVid
from accel_tpu.data.cityscapes import ANNOTATED_FRAME
from accel_tpu.data.cityscapes import Cityscape as JCityscape
from accel_tpu.data.loader import TestClipLoader as JTestClipLoader
from accel_tpu_torch.config import default_config
from accel_tpu_torch.data import image, png
from accel_tpu_torch.data.camvid import CamVid
from accel_tpu_torch.data.cityscapes import Cityscape
from accel_tpu_torch.data.loader import TestClipLoader
from accel_tpu_torch.data.prefetch import PrefetchingIter, to_device

torch.set_num_threads(2)
H, W = 128, 256


@pytest.fixture(scope="module", autouse=True)
def jax_side_native(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        jax_native_ops(mp, tmp_path_factory.mktemp("jax_native"))
        yield


@pytest.fixture(scope="module")
def cityscapes(tmp_path_factory):
    root = tmp_path_factory.mktemp("cs")
    data = write_cityscapes_tree(root, H, W)
    # separate cache roots: each package builds its own segdb pickle
    return (JCityscape("leftImg8bit_val", str(root / "j"), data),
            Cityscape("leftImg8bit_val", str(root / "t"), data))


def test_cityscapes_index_frames_and_annotations(cityscapes):
    jds, ds = cityscapes
    assert len(ds.segdb) == 4 and ds.segdb == jds.segdb
    assert ds.has_sequences() and jds.has_sequences()
    for je, e in zip(jds.segdb, ds.segdb):
        np.testing.assert_array_equal(ds.load_annotation(e), jds.load_annotation(je))
        assert set(np.unique(ds.load_annotation(e))) == {0, 10, 13, 255}
        for f in (ANNOTATED_FRAME - 6, ANNOTATED_FRAME - 1, ANNOTATED_FRAME, ANNOTATED_FRAME + 1):
            path = ds.sequence_frame(e, f)
            assert path == jds.sequence_frame(je, f) and os.path.exists(path)
            im = ds.load_image(path)
            assert im.dtype == np.uint8 and im.shape == (H, W, 3)
            np.testing.assert_array_equal(im, jds.load_image(path))
    # a second instance reads the segdb back from its pickle
    assert Cityscape("leftImg8bit_val", ds.root_path, ds.data_path).segdb == ds.segdb


@pytest.mark.parametrize("scales", [[[H, W]], [[64, 128]], [[96, 160]]],
                         ids=["native", "half", "ragged"])
def test_clip_loader_batches_match(cityscapes, scales):
    """Batches of 3 clips (the last one padded) at interval 3, key offset
    1, with SCALES at the frames' size, half of it, and a size whose
    padding to 128 is ragged: clip, label, ann_pos, entry_idx and the
    native annotations bit for bit."""
    jds, ds = cityscapes
    loaders = []
    for cfg, imdb, cls in ((j_default_config(), jds, JTestClipLoader),
                           (default_config(), ds, TestClipLoader)):
        cfg.SCALES = scales
        cfg.TEST.KEY_FRAME_INTERVAL = 3
        cfg.TEST.KEY_FRAME_OFFSET = 1
        loaders.append(cls(imdb, cfg, batch_clips=3))
    jl, tl = loaders
    assert len(tl) == len(jl) == 2 and tl.ann_pos == jl.ann_pos == 1
    resized = scales != [[H, W]]
    n = 0
    for jb, tb in zip(jl, tl, strict=True):
        assert sorted(tb) == sorted(jb)
        assert tb["clip"].dtype == np.float32 and tb["clip"].shape == jb["clip"].shape
        np.testing.assert_array_equal(tb["clip"], jb["clip"])
        np.testing.assert_array_equal(tb["label"], jb["label"])
        np.testing.assert_array_equal(tb["entry_idx"], jb["entry_idx"])
        assert tb["ann_pos"] == jb["ann_pos"]
        assert ("label_native" in tb) == resized
        for tn, jn in zip(tb.get("label_native", []), jb.get("label_native", [])):
            assert (tn is None) == (jn is None)
            if tn is not None:
                np.testing.assert_array_equal(tn[0], jn[0])
                assert tuple(tn[1]) == tuple(jn[1])
        n += 1
    assert n == 2


def test_camvid_matches(tmp_path):
    data = write_camvid_tree(tmp_path, 45, 60)
    jds = JCamVid("test", str(tmp_path / "j"), data)
    ds = CamVid("test", str(tmp_path / "t"), data)
    assert len(ds.segdb) == 3 and ds.segdb == jds.segdb
    for je, e in zip(jds.segdb, ds.segdb):
        np.testing.assert_array_equal(ds.load_image(e["image"]), jds.load_image(je["image"]))
        lab = ds.load_annotation(e)
        np.testing.assert_array_equal(lab, jds.load_annotation(je))
        assert lab.max() == 255 and lab[lab != 255].max() <= 10


def test_image_ops_match():
    rng = np.random.default_rng(3)
    im = rng.integers(0, 255, (37, 53, 3), np.uint8)
    for args in ((24, 40), (50, 80), (37, 53)):
        for interp in ("bilinear", "nearest"):
            got, gs = image.resize(im, *args, interp=interp)
            want, ws = jimage.resize(im, *args, interp=interp)
            assert gs == ws and got.shape == want.shape
            np.testing.assert_array_equal(got, want)
    means, stds = (103.06, 115.9, 123.15), (1.0, 2.0, 0.5)
    t = image.transform(im, means, stds)
    np.testing.assert_array_equal(t, jimage.transform(im, means, stds))
    np.testing.assert_array_equal(image.transform_inverse(t, means, stds),
                                  jimage.transform_inverse(t, means, stds))
    lut = rng.integers(0, 256, 256).astype(np.uint8)
    lab = rng.integers(0, 256, (20, 30)).astype(np.uint8)
    np.testing.assert_array_equal(image.map_labels(lab, lut), jimage.map_labels(lab, lut))
    parts = [rng.standard_normal((1, 3, 5)), rng.standard_normal((2, 4, 2))]
    np.testing.assert_array_equal(image.tensor_vstack(parts, 7.0),
                                  jimage.tensor_vstack(parts, 7.0))


def test_evaluate_segmentations_matches(cityscapes, capsys):
    jds, ds = cityscapes
    rng = np.random.default_rng(4)
    preds = [rng.integers(0, 19, (H // 2, W // 2)).astype(np.uint8) for _ in ds.segdb]
    preds[0] = ds.load_annotation(ds.segdb[0]).clip(0, 18)
    assert ds.evaluate_segmentations(preds) == jds.evaluate_segmentations(preds)
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:]


@pytest.mark.parametrize("flags", [png.IMREAD_UNCHANGED, png.IMREAD_COLOR],
                         ids=["unchanged", "color"])
def test_png_imread_matches_cv2(tmp_path, flags):
    """Gray, BGR and BGRA PNGs that ``cv2.imwrite`` wrote: ``imread`` gives
    ``cv2.imread``'s arrays bit for bit, and raises where cv2 gives None."""
    rng = np.random.default_rng(5)
    bgr = rng.integers(0, 255, (41, 70, 3), np.uint8)
    images = {"bgr": bgr, "gray": np.ascontiguousarray(bgr[:, :, 1]),
              "bgra": np.concatenate([bgr, rng.integers(0, 255, (41, 70, 1), np.uint8)], 2)}
    for name, im in images.items():
        path = str(tmp_path / f"{name}.png")
        write_png(path, im)
        want = cv2.imread(path, flags)
        got = png.imread(path, flags)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        png.imread(str(tmp_path / "missing.png"), flags)
    with pytest.raises(ValueError, match="unsupported imread flags"):
        png.imread(str(tmp_path / "bgr.png"), flags + 3)


def test_prefetcher_propagates_errors_and_moves_batches():
    def produce():
        yield {"clip": np.ones((1, 2, 4, 4, 3), np.float32), "label": np.zeros((1, 2, 4, 4)),
               "ann_pos": 1}
        raise RuntimeError("loader failed")

    it = PrefetchingIter(produce(), transform=lambda b: to_device(b, "cpu"))
    first = next(it)
    assert isinstance(first["clip"], torch.Tensor) and first["ann_pos"] == 1
    assert float(first["clip"].sum()) == 96.0
    with pytest.raises(RuntimeError, match="loader failed"):
        next(it)

    def bad(_):
        raise ValueError("transform failed")

    with pytest.raises(ValueError, match="transform failed"):
        list(PrefetchingIter(iter([{"clip": 0}]), transform=bad))
    assert [b["x"] for b in PrefetchingIter(iter([{"x": i} for i in range(5)]), depth=1)] \
        == list(range(5))
