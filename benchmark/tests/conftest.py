"""Shared helpers of the benchmark's CPU tests: the checkout's root on the
import path, the ``card`` marker (tests that need a CUDA card; each asks
the ``card`` fixture, which skips without one), and ``tiny_cell``: a cell
of ``BENCHMARK.json`` cut to a size the CPU runs in seconds."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_HW = [128, 256]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tiny_config(config: dict) -> dict:
    """``config`` at 128x256 frames with ResNet-18 trunks and a 32-wide fc6."""
    c = copy.deepcopy(config)
    c["frame_hw"] = list(TINY_HW)
    c["network"].update(ref_depth=18, head_channels=32)
    if "update_depth" in c["network"]:
        c["network"]["update_depth"] = 18
    return c


def tiny_cell(name: str):
    from benchmark import spec

    cell = spec.load_cell(name)
    cell.config = tiny_config(cell.config)
    cell.workload = dict(cell.workload, clips=2, warm_groups=1, trace_groups=1, check_clips=2,
                         trace_seconds=0.2, check_frames=4, drain_s=5)
    return cell
