"""``accel_tpu_torch/native``: the port's C++ host ops against the JAX
package's C++ built from its own source (``accel_tpu/native/
_accel_native.cpp``, through ``torch_parity.jax_native_ops``) bit for bit,
on uint8 and f32, HW and HWC, odd sizes, upscale and downscale; against
the numpy ops (``numpy_ops``): normalize and the label LUT exact where the
stds are 1 (every shipped cfg's ``PIXEL_STDS``), the normalize within one
f32 ulp otherwise (the C++ multiplies by 1/std where numpy divides), and
the resize within 1e-5 * (1 + max|x|) (the C++ takes its sample positions
in f32 where numpy takes them in f64). And the build: the library named by
a hash of the source, a failed build raising with the compiler's output."""

import numpy as np
import pytest
from torch_parity import jax_native_ops

import accel_tpu.native as jnative
from accel_tpu_torch import native

SHAPES = [(37, 53, 3), (37, 53), (64, 31, 3), (1, 9, 3)]
SIZES = [(71, 29), (19, 26), (1, 1), (128, 256)]


@pytest.fixture(scope="module")
def jax_ops(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        jax_native_ops(mp, tmp_path_factory.mktemp("jax_native"))
        yield jnative._NativeOps


def images(shape, seed: int):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, shape, np.uint8)
    return {"uint8": u8, "float32": (rng.standard_normal(shape) * 50).astype(np.float32)}


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_resize_is_bit_equal_to_the_jax_cpp_and_near_numpy(jax_ops, shape):
    for dtype, im in images(shape, seed=len(shape) * 100 + shape[0]).items():
        for size in SIZES:
            got = native.native_ops.resize_bilinear(im, *size)
            assert got.dtype == np.float32 and got.shape == size + shape[2:], (dtype, size)
            np.testing.assert_array_equal(got, jax_ops.resize_bilinear(im, *size))
            ref = native.numpy_ops.resize_bilinear(im, *size)
            bound = 1e-5 * (1.0 + float(np.abs(ref).max()))
            assert float(np.abs(got - ref).max()) <= bound, (dtype, size)


@pytest.mark.parametrize("stds", [(1.0, 1.0, 1.0), (57.375, 57.12, 58.395)],
                         ids=["unit", "imagenet"])
def test_normalize_and_lut(jax_ops, stds):
    means = np.asarray((103.06, 115.9, 123.15), np.float32)
    stds = np.asarray(stds, np.float32)
    for dtype, im in images((41, 67, 3), seed=7).items():
        got = native.native_ops.normalize(im, means, stds)
        assert got.dtype == np.float32 and got.shape == im.shape
        np.testing.assert_array_equal(got, jax_ops.normalize(im, means, stds))
        ref = native.numpy_ops.normalize(im, means, stds)
        if (stds == 1).all():
            np.testing.assert_array_equal(got, ref, err_msg=dtype)
        else:
            np.testing.assert_array_max_ulp(got, ref, maxulp=1)
    rng = np.random.default_rng(8)
    lut = rng.integers(0, 256, 256).astype(np.uint8)
    for shape in ((23, 45), (1, 1), (128, 256)):
        label = rng.integers(0, 256, shape).astype(np.uint8)
        got = native.native_ops.map_labels(label, lut)
        assert got.dtype == np.uint8 and got.shape == shape
        np.testing.assert_array_equal(got, jax_ops.map_labels(label, lut))
        np.testing.assert_array_equal(got, native.numpy_ops.map_labels(label, lut))


def test_build_is_keyed_on_the_source_and_raises_with_the_compiler_output(tmp_path):
    source = tmp_path / "_accel_native.cpp"
    source.write_text(native.SOURCE.read_text())
    lib = native.build(source, tmp_path / "build")
    assert lib.exists() and lib == native.library_path(source, tmp_path / "build")
    assert native.load(source, tmp_path / "build").map_labels is not None
    source.write_text(native.SOURCE.read_text() + "\nint broken(\n")
    assert native.library_path(source, tmp_path / "build") != lib
    with pytest.raises(RuntimeError, match="building _accel_native.cpp failed"):
        native.build(source, tmp_path / "build")
    assert native.available()
