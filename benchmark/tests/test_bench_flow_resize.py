"""The reader of FlowNet-S's 2x resizes (``metrics/flow_resize_ms.py``) on
made-up traces: a parent-like trace (PyTorch's ``upsample_bilinear2d``) and
a change-like one (the port's ``upsample2x_kernel``), each its device ms a
non-key frame; an antialiased downscale and a backward are not counted;
None without a trace, without non-key frames or without a resize."""

from types import SimpleNamespace

import pytest

from benchmark import spec
from benchmark.devtrace import Trace

LIBRARY = ("void at::native::(anonymous namespace)::upsample_bilinear2d_out_frame"
           "<c10::BFloat16, float>(int, float, float, bool)")
LIBRARY_NHWC = ("void at::native::(anonymous namespace)::upsample_bilinear2d_nhwc_out_frame"
                "<float, float>(float, float, int, int, int)")
KERNEL = "void (anonymous namespace)::upsample2x_kernel<__nv_bfloat16, true>(int, int)"
KERNEL_MANGLED = "_ZN41_INTERNAL_upsample2x_cu_1a2b3c17upsample2x_kernelIfLb0EEEvPKT_"
AA = "void at::native::(anonymous namespace)::upsample_gen2d_aa_out_frame<float, float>()"
BACKWARD = "void at::native::(anonymous namespace)::upsample_bilinear2d_backward_out_frame<float>()"
FRAMES = dict(frame=10, key=2, cur=8)


def _reader():
    return spec.load_module(spec.HERE / "metrics" / "flow_resize_ms.py")


def _run(device, frames=FRAMES):
    return SimpleNamespace(trace=Trace(device=device, host=[], window_s=1.0, frames=frames))


def test_the_library_resizes_a_pair_on_a_parent_like_trace():
    device = [(LIBRARY, 0.0, 0.004), (LIBRARY_NHWC, 0.004, 0.005), (AA, 0.005, 0.009),
              ("sm90_xmma_fprop_implicit_gemm", 0.01, 0.02)]
    assert _reader().read(_run(device)) == pytest.approx(1e3 * 0.005 / 8)


@pytest.mark.parametrize("name", [KERNEL, KERNEL_MANGLED])
def test_the_kernel_a_pair_on_a_change_like_trace(name):
    device = [(name, 0.0, 0.0002), (name, 0.001, 0.0012), (AA, 0.002, 0.006),
              (BACKWARD, 0.006, 0.008)]
    assert _reader().read(_run(device)) == pytest.approx(1e3 * 0.0004 / 8)


def test_it_divides_by_the_non_key_frames():
    device = [(KERNEL, 0.0, 0.0008)]
    reader = _reader()
    assert reader.read(_run(device, dict(frame=5, key=1, cur=4))) == pytest.approx(0.2)
    assert reader.read(_run(device, dict(frame=10, key=2, cur=8))) == pytest.approx(0.1)


def test_nothing_to_read():
    reader = _reader()
    assert reader.read(SimpleNamespace(trace=None)) is None
    assert reader.read(_run([(KERNEL, 0.0, 1e-3)], dict(frame=2, key=2, cur=0))) is None
    assert reader.read(_run([(AA, 0.0, 1e-3), (BACKWARD, 1e-3, 2e-3)])) is None
