"""Build and load the hand-written CUDA kernels.

Route: each ``*.cu`` source here is compiled by ``nvcc`` into its own
shared library with a plain ``extern "C"`` interface (raw pointers, sizes
and a ``cudaStream_t``), loaded with ``ctypes``. No source includes
PyTorch's headers, so a build takes seconds rather than the minutes a
``torch.utils.cpp_extension`` build takes; the build needs no ``ninja``.

Libraries land in ``_build/`` beside this file (listed in ``.gitignore``),
named by a hash of the source, the shared headers (``*.cuh``) and the
compiler flags, so an edited source or header rebuilds. The first
:func:`load` builds every missing library at once, one ``nvcc`` process
per source, all started together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

KERNEL_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNEL_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# argtypes of each library's extern "C" launcher ``<name>_launch``; every
# launcher returns a cudaError_t
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ARGTYPES = {
    # feat, flow, out, N, C, H, W, max_disp, is_bf16, stream
    "warp": (_P, _P, _P, _I, _I, _I, _I, _F, _I, _P),
    # logits, out, N, C, h, w, H, W, stream
    "upsample_argmax": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    # x, w (bf16: packed (176, 64); f32: (3, 7, 7, 64)), inv, shift, out, N, H, W, Ho,
    # Wo, is_bf16, stream
    "fused_stem": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # feat, flow, scale, gain, out, N, C, H, W, max_disp, feat_bf16, scale_bf16,
    # weights_bf16, rows, chunk, stages, runs, tma, stream
    "warp_onehot": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _I, _I, _I,
                    _P),
    # x (bf16: NHWC; f32: NCHW), packed weights (9, Cout, Cin), out, N, Cin, Cout, H, W,
    # dilation, is_bf16, stream
    "dilated_conv": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # x, out, planes (N*C), h, w, is_bf16, stream
    "upsample2x": (_P, _P, _I, _I, _I, _I, _P),
}
SOURCES = tuple(ARGTYPES)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(cuda_home, "bin", "nvcc")


def library_path(name: str) -> Path:
    """Build product of ``<name>.cu``, keyed on the source, every header in
    this directory (``*.cuh``) and the flags, so editing a header rebuilds."""
    digest = hashlib.sha256((KERNEL_DIR / f"{name}.cu").read_bytes())
    for header in sorted(KERNEL_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build() -> dict[str, float]:
    """Compile every kernel whose library is missing, all in parallel.

    Returns the wall seconds of this call per compiled source (empty when
    everything was already built). Raises ``RuntimeError`` with the
    compiler's output if any build fails. ``nvcc``'s ``-Xptxas -v`` report
    (registers, shared memory, spills) stays in ``_build/<lib>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in SOURCES if not library_path(n).exists()}
    t0 = time.perf_counter()
    procs = {}
    for name, lib in todo.items():
        tmp = lib.parent / f"{lib.stem}.{os.getpid()}.tmp.so"
        log = open(lib.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(KERNEL_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT),
                       tmp, lib, log)
    seconds, failed = {}, []
    for name, (proc, tmp, lib, log) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name}.cu (nvcc rc={rc}):\n"
                          + lib.with_suffix(".log").read_text())
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


@functools.cache
def load(name: str):
    """The launcher ``<name>_launch`` of kernel library ``name``, built on
    first use."""
    if not library_path(name).exists():
        build()
    fn = getattr(ctypes.CDLL(str(library_path(name))), f"{name}_launch")
    fn.argtypes = ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def launch(name: str, device, *args) -> None:
    """Call the launcher of library ``name`` with ``args`` and the raw
    stream PyTorch currently uses on ``device`` (a CUDA ``torch.device``),
    and raise on a launch error. For a kernel that takes microseconds the
    host work around the launch is most of its cost, so the device guard is
    entered only when ``device`` is not the current device, and the stream
    is read as a raw handle (no ``torch.cuda.Stream`` object is made)."""
    import torch

    fn = load(name)
    index = device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    check(err, name)
