// Host preprocessing ops of the PyTorch port (a copy of the JAX package's
// accel_tpu/native/_accel_native.cpp, the same arithmetic).
//
// The loops that run hot on the host while the card runs the previous
// batch: bilinear resize (half-pixel centres, edges clamped), the BGR
// mean/std normalize and the label LUT. Every loop releases the GIL, so the
// prefetching thread runs beside the consumer.
//
// Built with the CPython C API by accel_tpu_torch/native/__init__.py (g++,
// at first use), no pybind11 and no setup.py.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// Bilinear resize, HWC uint8 or float32, half-pixel centers (matches
// jax.image.resize / cv2 INTER_LINEAR semantics).
template <typename T>
void resize_bilinear_impl(const T* src, int sh, int sw, int c, float* dst,
                          int dh, int dw) {
  const float ys = static_cast<float>(sh) / dh;
  const float xs = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * ys - 0.5f;
    fy = std::min(std::max(fy, 0.0f), static_cast<float>(sh - 1));
    const int y0 = static_cast<int>(fy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float wy = fy - y0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * xs - 0.5f;
      fx = std::min(std::max(fx, 0.0f), static_cast<float>(sw - 1));
      const int x0 = static_cast<int>(fx);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float wx = fx - x0;
      const T* p00 = src + (static_cast<int64_t>(y0) * sw + x0) * c;
      const T* p01 = src + (static_cast<int64_t>(y0) * sw + x1) * c;
      const T* p10 = src + (static_cast<int64_t>(y1) * sw + x0) * c;
      const T* p11 = src + (static_cast<int64_t>(y1) * sw + x1) * c;
      float* out = dst + (static_cast<int64_t>(y) * dw + x) * c;
      for (int k = 0; k < c; ++k) {
        const float top = p00[k] + wx * (p01[k] - p00[k]);
        const float bot = p10[k] + wx * (p11[k] - p10[k]);
        out[k] = top + wy * (bot - top);
      }
    }
  }
}

PyObject* resize_bilinear(PyObject*, PyObject* args) {
  PyObject* src_obj;
  int dh, dw;
  if (!PyArg_ParseTuple(args, "Oii", &src_obj, &dh, &dw)) return nullptr;
  PyArrayObject* src = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(src_obj, NPY_NOTYPE, NPY_ARRAY_IN_ARRAY));
  if (!src) return nullptr;
  const int nd = PyArray_NDIM(src);
  if (nd != 2 && nd != 3) {
    Py_DECREF(src);
    PyErr_SetString(PyExc_ValueError, "expected HW or HWC array");
    return nullptr;
  }
  const int sh = static_cast<int>(PyArray_DIM(src, 0));
  const int sw = static_cast<int>(PyArray_DIM(src, 1));
  const int c = nd == 3 ? static_cast<int>(PyArray_DIM(src, 2)) : 1;
  npy_intp out_dims[3] = {dh, dw, c};
  // HW in, HW out; HWC in, HWC out
  PyArrayObject* out = reinterpret_cast<PyArrayObject*>(
      PyArray_SimpleNew(nd, out_dims, NPY_FLOAT32));
  if (!out) {
    Py_DECREF(src);
    return nullptr;
  }
  const int typ = PyArray_TYPE(src);
  float* dst = static_cast<float*>(PyArray_DATA(out));
  bool ok = true;
  Py_BEGIN_ALLOW_THREADS
  if (typ == NPY_UINT8) {
    resize_bilinear_impl(static_cast<const uint8_t*>(PyArray_DATA(src)), sh, sw, c, dst, dh, dw);
  } else if (typ == NPY_FLOAT32) {
    resize_bilinear_impl(static_cast<const float*>(PyArray_DATA(src)), sh, sw, c, dst, dh, dw);
  } else {
    ok = false;
  }
  Py_END_ALLOW_THREADS
  Py_DECREF(src);
  if (!ok) {
    Py_DECREF(out);
    PyErr_SetString(PyExc_TypeError, "expected uint8 or float32");
    return nullptr;
  }
  return reinterpret_cast<PyObject*>(out);
}

PyObject* normalize(PyObject*, PyObject* args) {
  // (im HWC u8/f32, means (C,) f32, stds (C,) f32) -> (im - means)/stds f32
  PyObject *im_obj, *mean_obj, *std_obj;
  if (!PyArg_ParseTuple(args, "OOO", &im_obj, &mean_obj, &std_obj)) return nullptr;
  PyArrayObject* im = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(im_obj, NPY_NOTYPE, NPY_ARRAY_IN_ARRAY));
  PyArrayObject* mean = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(mean_obj, NPY_FLOAT32, NPY_ARRAY_IN_ARRAY));
  PyArrayObject* stdv = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(std_obj, NPY_FLOAT32, NPY_ARRAY_IN_ARRAY));
  if (!im || !mean || !stdv) {
    Py_XDECREF(im); Py_XDECREF(mean); Py_XDECREF(stdv);
    return nullptr;
  }
  if (PyArray_NDIM(im) != 3) {
    Py_DECREF(im); Py_DECREF(mean); Py_DECREF(stdv);
    PyErr_SetString(PyExc_ValueError, "expected HWC");
    return nullptr;
  }
  const int64_t hw = PyArray_DIM(im, 0) * PyArray_DIM(im, 1);
  const int c = static_cast<int>(PyArray_DIM(im, 2));
  if (c > 16 || PyArray_SIZE(mean) < c || PyArray_SIZE(stdv) < c) {
    Py_DECREF(im); Py_DECREF(mean); Py_DECREF(stdv);
    PyErr_SetString(PyExc_ValueError,
                    "normalize: C must be <= 16 and means/stds must have >= C entries");
    return nullptr;
  }
  PyArrayObject* out = reinterpret_cast<PyArrayObject*>(
      PyArray_SimpleNew(3, PyArray_DIMS(im), NPY_FLOAT32));
  if (!out) {
    Py_DECREF(im); Py_DECREF(mean); Py_DECREF(stdv);
    return nullptr;
  }
  const float* m = static_cast<const float*>(PyArray_DATA(mean));
  const float* s = static_cast<const float*>(PyArray_DATA(stdv));
  float inv[16];
  for (int k = 0; k < c; ++k) inv[k] = 1.0f / s[k];
  float* dst = static_cast<float*>(PyArray_DATA(out));
  const int typ = PyArray_TYPE(im);
  bool ok = true;
  Py_BEGIN_ALLOW_THREADS
  if (typ == NPY_UINT8) {
    const uint8_t* p = static_cast<const uint8_t*>(PyArray_DATA(im));
    for (int64_t i = 0; i < hw; ++i)
      for (int k = 0; k < c; ++k) dst[i * c + k] = (p[i * c + k] - m[k]) * inv[k];
  } else if (typ == NPY_FLOAT32) {
    const float* p = static_cast<const float*>(PyArray_DATA(im));
    for (int64_t i = 0; i < hw; ++i)
      for (int k = 0; k < c; ++k) dst[i * c + k] = (p[i * c + k] - m[k]) * inv[k];
  } else {
    ok = false;
  }
  Py_END_ALLOW_THREADS
  Py_DECREF(im); Py_DECREF(mean); Py_DECREF(stdv);
  if (!ok) {
    Py_DECREF(out);
    PyErr_SetString(PyExc_TypeError, "expected uint8 or float32");
    return nullptr;
  }
  return reinterpret_cast<PyObject*>(out);
}

PyObject* map_labels(PyObject*, PyObject* args) {
  // (label HW integer, lut (256,) u8) -> u8 HW
  PyObject *lab_obj, *lut_obj;
  if (!PyArg_ParseTuple(args, "OO", &lab_obj, &lut_obj)) return nullptr;
  PyArrayObject* lab = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(lab_obj, NPY_UINT8, NPY_ARRAY_IN_ARRAY));
  PyArrayObject* lut = reinterpret_cast<PyArrayObject*>(
      PyArray_FROM_OTF(lut_obj, NPY_UINT8, NPY_ARRAY_IN_ARRAY));
  if (!lab || !lut) {
    Py_XDECREF(lab); Py_XDECREF(lut);
    return nullptr;
  }
  if (PyArray_SIZE(lut) < 256) {
    Py_DECREF(lab); Py_DECREF(lut);
    PyErr_SetString(PyExc_ValueError, "lut must have 256 entries");
    return nullptr;
  }
  PyArrayObject* out = reinterpret_cast<PyArrayObject*>(
      PyArray_SimpleNew(PyArray_NDIM(lab), PyArray_DIMS(lab), NPY_UINT8));
  if (!out) {
    Py_DECREF(lab); Py_DECREF(lut);
    return nullptr;
  }
  const int64_t n = PyArray_SIZE(lab);
  const uint8_t* p = static_cast<const uint8_t*>(PyArray_DATA(lab));
  const uint8_t* l = static_cast<const uint8_t*>(PyArray_DATA(lut));
  uint8_t* dst = static_cast<uint8_t*>(PyArray_DATA(out));
  Py_BEGIN_ALLOW_THREADS
  for (int64_t i = 0; i < n; ++i) dst[i] = l[p[i]];
  Py_END_ALLOW_THREADS
  Py_DECREF(lab); Py_DECREF(lut);
  return reinterpret_cast<PyObject*>(out);
}

PyMethodDef methods[] = {
    {"resize_bilinear", resize_bilinear, METH_VARARGS,
     "resize_bilinear(im, out_h, out_w) -> float32 array"},
    {"normalize", normalize, METH_VARARGS,
     "normalize(im, means, stds) -> float32 array"},
    {"map_labels", map_labels, METH_VARARGS,
     "map_labels(label, lut256) -> uint8 array"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_accel_native",
                         "accel_tpu_torch native preprocessing", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__accel_native(void) {
  import_array();
  return PyModule_Create(&moduledef);
}
