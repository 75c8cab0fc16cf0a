"""Closed loop, one caller: keyframe groups through ``VideoSegmenter.push_group``.

An offline labelling or eval pipeline: the caller hands the program one
keyframe group of ``batch`` clips x ``key_interval`` frames, waits for its
class maps on the host, and sends the next group. The groups cycle through
``clips`` distinct panning clips drawn from the seed (each group is served
from scratch, so cycling changes no work). The window runs whole groups
until ``--seconds`` have passed; a frame counts as served when its class
map is on the host.

Workload parameters: ``batch``, ``clips``, ``warm_groups`` (served in
set-up), ``trace_groups`` (the traced segment), ``check_clips`` (how many
clips' latest served groups the reference checks).
"""

from __future__ import annotations

import random
import time

import torch

from benchmark import frames as frames_mod
from benchmark.weights import derive


def prepare(run) -> None:
    p, c = run.traffic, run.config
    k, hw = c["key_interval"], tuple(c["frame_hw"])
    run.clips = [torch.cat([frames_mod.panning_clip(k, hw, derive(run.seed, f"clip{i}.{b}"),
                                                    run.device) for b in range(p["batch"])])
                 for i in range(p["clips"])]
    # the caller's buffers, pinned, so a copy is one DMA
    run.host_maps = torch.empty((p["clips"], p["batch"], k, *hw), dtype=torch.uint8,
                                pin_memory=run.device.type == "cuda")
    run.served_slots = set()


def calibration_pair(run) -> torch.Tensor:
    return frames_mod.nchw(run.clips[0][0, :2])


def _segmenter(run):
    from accel_tpu_torch.core.serving import VideoSegmenter

    return VideoSegmenter(run.model, run.config["key_interval"], propagate=run.config["propagate"])


def _serve_group(run, i: int) -> None:
    slot = i % len(run.clips)
    run.host_maps[slot].copy_(run.segmenters[0].push_group(run.clips[slot]))
    run.served_slots.add(slot)


def warm(run) -> None:
    run.segmenters = [_segmenter(run)]
    for i in range(run.traffic["warm_groups"]):
        _serve_group(run, i)


def serve(run, seconds: float) -> None:
    t_start = time.perf_counter()
    i = 0
    while True:
        t = time.perf_counter()
        _serve_group(run, i)
        done = time.perf_counter()
        run.records.append(dict(start=t - t_start, done=done - t_start))
        i += 1
        if done - t_start >= seconds:
            break
    run.window_s = done - t_start
    run.groups_served = i


def traced_segment(run, frames: dict) -> None:
    n = run.traffic["trace_groups"]
    for i in range(n):
        _serve_group(run, run.groups_served + i)
    frames["frame"] = n * run.traffic["batch"] * run.config["key_interval"]
    frames["key"] = n * run.traffic["batch"]
    frames["cur"] = frames["frame"] - frames["key"]


def frames_served(run) -> int:
    return run.groups_served * run.traffic["batch"] * run.config["key_interval"]


def counts(run) -> tuple[int, int]:
    return frames_served(run), 0


def end_to_end(run) -> dict:
    return dict(frames_per_s=frames_served(run) / run.window_s)


def report(run) -> list:
    ms = sorted(1e3 * (r["done"] - r["start"]) for r in run.records)
    return [dict(groups=run.groups_served, window_s=run.window_s,
                 group_ms_median=ms[len(ms) // 2], group_ms_max=ms[-1])]


def sample(run, rng: random.Random):
    """(frames (k,3,H,W), None, served maps (k,H,W)) of each checked clip's
    latest served group (every batch row)."""
    p = run.traffic
    served = sorted(run.served_slots)
    slots = rng.sample(served, min(p["check_clips"], len(served)))
    for slot in sorted(slots):
        for b in range(p["batch"]):
            yield frames_mod.nchw(run.clips[slot][b]), None, run.host_maps[slot, b]
