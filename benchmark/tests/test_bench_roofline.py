"""The roofline arithmetic and the trace reduction, on a made-up trace."""

import math
from types import SimpleNamespace

import pytest

from benchmark import roofline, spec
from benchmark.devtrace import Trace, port_kernel, union_s

WARP = "void (anonymous namespace)::warp_kernel<float>(const float*, float*)"
TAIL = "void (anonymous namespace)::upsample_argmax_kernel<19>(const float*)"
ONEHOT = "_ZN43_INTERNAL_warp_onehot_cu_abc18warp_onehot_kernelEv"


def test_bound_is_the_larger_of_bytes_and_operations():
    assert roofline.bound_s(3.35e9, 0.0, "f32") == pytest.approx(1e-3)
    assert roofline.bound_s(0.0, 67e9, "f32") == pytest.approx(1e-3)
    assert roofline.bound_s(3.35e9, 2 * 67e9, "f32") == pytest.approx(2e-3)
    assert roofline.bound_s(0.0, 989e9, "bf16") == pytest.approx(1e-3)
    assert roofline.share(1e-3, 4e-3) == pytest.approx(25.0)
    assert roofline.share(1e-3, 0.0) is None


def test_port_kernel_names():
    assert port_kernel(WARP) == "warp"
    assert port_kernel(TAIL) == "upsample_argmax"
    assert port_kernel(ONEHOT) == "warp_onehot"
    assert port_kernel("sm90_xmma_fprop_implicit_gemm_bf16") is None


def test_busy_time_counts_overlaps_once_and_idle_gaps_are_named():
    assert union_s([(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]) == pytest.approx(4.0)
    trace = Trace(device=[("conv", 0.1, 0.4), ("conv", 0.3, 0.5), (WARP, 0.7, 0.8)],
                  host=[("bench.serve", 0.0, 1.0), ("aten::copy_", 0.5, 0.7)],
                  window_s=1.0, frames={})
    assert trace.busy_s() == pytest.approx(0.5)
    gaps = dict(trace.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(0.2)
    assert gaps["bench.serve"] == pytest.approx(0.1 + 0.2)
    assert dict(trace.device_ops())["conv"] == pytest.approx(0.5)


def _run(config, trace):
    return SimpleNamespace(config=config, trace=trace, device=SimpleNamespace(type="cuda"))


def test_kernel_rooflines_from_shapes_and_device_time():
    accel = spec.load_cell("accel18-offline").config
    dff = spec.load_cell("dff-offline").config
    frames = dict(frame=10, key=2, cur=8)
    trace = Trace(device=[(WARP, 0.0, 1e-4), (TAIL, 1e-4, 1.1e-3), (ONEHOT, 2e-3, 3e-3)],
                  host=[], window_s=1.0, frames=frames)
    warp = spec.load_module(spec.HERE / "metrics" / "warp_roofline.py")
    tail = spec.load_module(spec.HERE / "metrics" / "upsample_argmax_roofline.py")
    onehot = spec.load_module(spec.HERE / "metrics" / "warp_onehot_roofline.py")
    # (1,19,64,128) f32 score map and f32 flow in, the map out
    warp_bytes = 2 * 19 * 64 * 128 * 4 + 2 * 64 * 128 * 4
    assert warp.read(_run(accel, trace)) == pytest.approx(
        100 * 8 * (warp_bytes / 3.35e12) / 1e-4)
    tail_ops = 19 * (2 * 64 * 2048 + 3 * 1024 * 2048)
    assert tail.read(_run(accel, trace)) == pytest.approx(100 * 10 * (tail_ops / 67e12) / 1e-3)
    # bf16 features and scale in, bf16 out, f32 flow
    onehot_bytes = 3 * 1024 * 64 * 128 * 2 + 2 * 64 * 128 * 4
    assert onehot.read(_run(dff, trace)) == pytest.approx(
        100 * 8 * max(onehot_bytes / 3.35e12, 8 * 1024 * 64 * 128 / 67e12) / 1e-3)


def test_a_kernel_off_the_path_reads_nothing():
    trace = Trace(device=[("conv", 0.0, 1.0)], host=[], window_s=1.0,
                  frames=dict(frame=5, key=1, cur=4))
    warp = spec.load_module(spec.HERE / "metrics" / "warp_roofline.py")
    assert warp.read(_run(spec.load_cell("accel18-offline").config, trace)) is None


def test_mfu_and_idle_share():
    mfu = spec.load_module(spec.HERE / "metrics" / "step_mfu.py")
    idle = spec.load_module(spec.HERE / "metrics" / "device_idle_share.py")
    cell = spec.load_cell("accel18-offline")
    from benchmark import flops

    run = SimpleNamespace(config=cell.config, traffic=cell.workload, groups_served=30,
                          window_s=1.5, device=SimpleNamespace(type="cuda"),
                          trace=Trace([("conv", 0.0, 0.25)], [], 1.0, {}))
    want = 100 * flops.group_flops(cell.config) * 30 / (1.5 * 989e12)
    assert mfu.read(run) == pytest.approx(want)
    assert idle.read(run) == pytest.approx(75.0)
    assert not math.isnan(want)
