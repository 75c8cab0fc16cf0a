"""MXNet ``.params`` container parser (NDArray-list save format): the
port's own numpy copy of ``accel_tpu/utils/mxnet_io.py``.

The reference's ``lib/utils/load_model.py:load_param`` reads
``{prefix}-{epoch:04d}.params`` files holding ``arg:``/``aux:``-prefixed
named dense tensors. The parser follows the binary format's constants
(magic numbers and the mshadow dtype enum), so pretrained files load
without MXNet. Conv weights come out as MXNet stores them, OIHW, the
port's own layout.
"""

from __future__ import annotations

import struct

import numpy as np


_NDLIST_MAGIC = 0x112  # kMXAPINDArrayListMagic
_NDARRAY_V1_MAGIC = 0xF993FAC8  # NDARRAY_V1_MAGIC (shape uses int64)
_NDARRAY_V2_MAGIC = 0xF993FAC9  # NDARRAY_V2_MAGIC (adds storage type)
_NDARRAY_V3_MAGIC = 0xF993FACA

_MSHADOW_DTYPES = {
    0: np.float32,
    1: np.float64,
    2: np.float16,
    3: np.uint8,
    4: np.int32,
    5: np.int8,
    6: np.int64,
}


def _read_ndarray(buf: memoryview, pos: int):
    (magic,) = struct.unpack_from("<I", buf, pos)
    if magic in (_NDARRAY_V2_MAGIC, _NDARRAY_V3_MAGIC):
        pos += 4
        (stype,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        if stype != 0:  # kDefaultStorage only (dense)
            raise ValueError(f"unsupported sparse storage type {stype}")
        (ndim,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        shape = struct.unpack_from(f"<{ndim}q", buf, pos)
        pos += 8 * ndim
    elif magic == _NDARRAY_V1_MAGIC:
        pos += 4
        (ndim,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        shape = struct.unpack_from(f"<{ndim}q", buf, pos)
        pos += 8 * ndim
    else:
        # legacy V0: magic IS ndim (uint32), shape uses uint32
        ndim = magic
        pos += 4
        if ndim > 8:
            raise ValueError(f"cannot parse NDArray header (ndim={ndim})")
        shape = struct.unpack_from(f"<{ndim}I", buf, pos)
        pos += 4 * ndim
    dev_type, dev_id, dtype_flag = struct.unpack_from("<iii", buf, pos)
    pos += 12
    dtype = _MSHADOW_DTYPES[dtype_flag]
    count = int(np.prod(shape)) if ndim else 1
    nbytes = count * np.dtype(dtype).itemsize
    arr = np.frombuffer(buf, dtype=dtype, count=count, offset=pos).reshape(shape)
    pos += nbytes
    return arr.copy(), pos


def load_mxnet_params(path: str) -> tuple[dict, dict]:
    """Parse an MXNet .params file -> (arg_params, aux_params) name->ndarray
    (the reference's load_param contract, lib/utils/load_model.py)."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    header, reserved = struct.unpack_from("<QQ", data, 0)
    pos = 16
    if header != _NDLIST_MAGIC:
        raise ValueError(f"not an MXNet NDArray-list file (magic {header:#x})")
    (n_arrays,) = struct.unpack_from("<Q", data, pos)
    pos += 8
    arrays = []
    for _ in range(n_arrays):
        arr, pos = _read_ndarray(data, pos)
        arrays.append(arr)
    (n_names,) = struct.unpack_from("<Q", data, pos)
    pos += 8
    names = []
    for _ in range(n_names):
        (ln,) = struct.unpack_from("<Q", data, pos)
        pos += 8
        names.append(bytes(data[pos : pos + ln]).decode())
        pos += ln
    assert len(names) == len(arrays)
    arg_params, aux_params = {}, {}
    for name, arr in zip(names, arrays):
        if name.startswith("arg:"):
            arg_params[name[4:]] = arr
        elif name.startswith("aux:"):
            aux_params[name[4:]] = arr
        else:
            arg_params[name] = arr
    return arg_params, aux_params


