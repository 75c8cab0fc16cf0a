"""``correct`` separates a sound program from a broken one: runs of each
cell on the CPU, through the whole harness but its look for a card, with
the cell's own limits. The program as it is comes out correct (at a tiny
size); its int8 path (the configuration's ``control``, one precision step
below the bf16 it states) comes out not correct at the configuration's
own widths and depths on 256x512 frames (at the tiny size its error
stays within the limits, as it does not at the served sizes); and each
fault the cell can have, planted where the timed path produces it, comes
out not correct at the tiny size:

- ``state_unchanged``: the propagation warp returns its input, so the
  keyframe's tensor is never moved;
- ``answer_altered``: a 16x16 block of every class map takes the next
  class where the serving tail produces it;
- ``half_of_the_group``: a group's last two frames get the maps of two
  earlier frames in place of their own (the closed-loop cells, whose
  requests are groups).

One chip serves each cell, so no exchange between chips can be left out.
"""

import pytest
import torch
from conftest import tiny_cell

from benchmark import spec

from benchmark import harness

CELLS = ["accel18-offline", "dff-offline", "accel18-live", "dff-live"]


def _run(cell, network=None):
    return harness.execute(cell, 2**33 + 7, 0.3, trace=False, device="cpu", network=network,
                           emit=lambda line: None)


def _state_unchanged(monkeypatch):
    from accel_tpu_torch.models.accel import AccelNet

    def warp(self, prop, flow, scale, *args, **kwargs):
        return prop if self.warp_dtype == "native" else prop.to(torch.float32)

    monkeypatch.setattr(AccelNet, "warp", warp)


def _answer_altered(monkeypatch):
    from accel_tpu_torch.core import pipeline, predictor

    for module in (pipeline, predictor):
        original = module.upsample_argmax

        def altered(logits, out_hw, plain=False, original=original):
            out = original(logits, out_hw, plain)
            out[..., :16, :16] = (out[..., :16, :16] + 1) % logits.shape[1]
            return out

        monkeypatch.setattr(module, "upsample_argmax", altered)


def _half_of_the_group(monkeypatch):
    from accel_tpu_torch.core.serving import VideoSegmenter

    original = VideoSegmenter.push_group

    def push_group(self, frames):
        pred = original(self, frames)
        pred[:, 3:] = pred[:, 1:3].clone()
        return pred

    monkeypatch.setattr(VideoSegmenter, "push_group", push_group)


FAULTS = {"state_unchanged": _state_unchanged, "answer_altered": _answer_altered,
          "half_of_the_group": _half_of_the_group}


@pytest.mark.parametrize("name", CELLS)
def test_the_program_as_it_is_is_correct(name):
    res = _run(tiny_cell(name))
    assert res["correct"] is True, res["compared"]


@pytest.mark.parametrize("name", CELLS)
def test_the_int8_control_is_not_correct(name):
    cell = spec.load_cell(name)
    cell.config = dict(cell.config, frame_hw=[256, 512])
    cell.workload = dict(cell.workload, clips=1, warm_groups=1, check_clips=1, check_frames=2)
    res = _run(cell, dict(cell.config["network"], **cell.config["control"]))
    assert res["correct"] is False, res["compared"]


# a live cell's request is one frame: it has no group to halve
CASES = [(name, fault) for name in CELLS for fault in FAULTS
         if fault != "half_of_the_group" or name.endswith("-offline")]


@pytest.mark.parametrize("name,fault", CASES)
def test_a_planted_fault_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    FAULTS[fault](monkeypatch)
    res = _run(cell)
    assert res["correct"] is False, res["compared"]
