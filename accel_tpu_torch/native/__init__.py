"""Host preprocessing in C++ (counterpart of ``accel_tpu/native``).

``native_ops`` runs the data path's bilinear resize, normalize and label
LUT through ``_accel_native.cpp`` (a copy of the JAX package's source,
the same arithmetic); ``numpy_ops`` is the numpy version of the same
three (the JAX package's fallback). The resize computes its sample
positions in f32 where numpy computes them in f64, so the two resizes
differ by float rounding; normalize and the LUT are exact in both.

The extension is built at first use with the host compiler (``g++ -O3
-shared -fPIC`` against Python's and numpy's headers; no setup.py, no
ninja; no ``-march=native``, so a library built on one x86-64 host runs on
another) into ``_build/`` beside this file (listed in ``.gitignore``), named
by a hash of the source and the flags, and written under a temporary name
then renamed, so processes building at once do not collide. A failed
build raises with the compiler's output: the data path does not fall back
to numpy.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import os
import subprocess
import sysconfig
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR / "_build"
SOURCE = NATIVE_DIR / "_accel_native.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def library_path(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Build product of ``source``, keyed on the source and the flags."""
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return build_dir / f"{source.stem}-{digest.hexdigest()[:16]}{suffix}"


def build(source: Path = SOURCE, build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``source`` (a CPython extension module ``_accel_native``)
    where its library is missing; returns the library's path. Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    lib = library_path(source, build_dir)
    if lib.exists():
        return lib
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS,
           f"-I{sysconfig.get_paths()['include']}", f"-I{np.get_include()}",
           "-o", str(tmp), str(source)]
    out = subprocess.run(cmd, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"building {source.name} failed (rc={out.returncode}):\n"
                           f"{' '.join(cmd)}\n{out.stdout}{out.stderr}")
    os.replace(tmp, lib)
    return lib


def load(source: Path = SOURCE, build_dir: Path = BUILD_DIR):
    """The extension module built from ``source``."""
    spec = importlib.util.spec_from_file_location("_accel_native", build(source, build_dir))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.cache
def _ext():
    return load()


def available() -> bool:
    """Whether the extension builds and loads here."""
    try:
        _ext()
    except RuntimeError:
        return False
    return True


class NumpyOps:
    @staticmethod
    def resize_bilinear(im: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
        """Half-pixel-centre bilinear resize, edges clamped, in f32 (HW or HWC)."""
        squeeze = im.ndim == 2
        if squeeze:
            im = im[..., None]
        h, w, _ = im.shape
        fy = np.clip((np.arange(out_h) + 0.5) * (h / out_h) - 0.5, 0, h - 1)
        fx = np.clip((np.arange(out_w) + 0.5) * (w / out_w) - 0.5, 0, w - 1)
        y0 = fy.astype(np.int64)
        x0 = fx.astype(np.int64)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = (fy - y0)[:, None, None].astype(np.float32)
        wx = (fx - x0)[None, :, None].astype(np.float32)
        im = im.astype(np.float32)
        top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
        bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
        out = top * (1 - wy) + bot * wy
        return out[..., 0] if squeeze else out

    @staticmethod
    def normalize(im: np.ndarray, means: np.ndarray, stds: np.ndarray) -> np.ndarray:
        return ((im.astype(np.float32) - means) / stds).astype(np.float32)

    @staticmethod
    def map_labels(label: np.ndarray, lut: np.ndarray) -> np.ndarray:
        return lut[label.astype(np.uint8)]


class NativeOps:
    """The three ops on the extension, inputs made contiguous uint8 or f32
    (other dtypes as f32) as the extension takes them."""

    @staticmethod
    def _host(im: np.ndarray) -> np.ndarray:
        im = np.ascontiguousarray(im)
        return im if im.dtype in (np.uint8, np.float32) else im.astype(np.float32)

    @staticmethod
    def resize_bilinear(im: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
        return _ext().resize_bilinear(NativeOps._host(im), int(out_h), int(out_w))

    @staticmethod
    def normalize(im: np.ndarray, means, stds) -> np.ndarray:
        return _ext().normalize(NativeOps._host(im), np.ascontiguousarray(means, np.float32),
                                np.ascontiguousarray(stds, np.float32))

    @staticmethod
    def map_labels(label: np.ndarray, lut: np.ndarray) -> np.ndarray:
        return _ext().map_labels(np.ascontiguousarray(label),
                                 np.ascontiguousarray(lut, np.uint8))


native_ops = NativeOps
numpy_ops = NumpyOps
