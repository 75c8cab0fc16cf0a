"""The traced segment: a ``torch.profiler`` trace reduced to what the
per-layer metrics and the result's ``breakdown`` read.

``Trace`` keeps each device event (name, start, end) and each host event,
in seconds from the segment's start, the segment's length, and the frames
the segment served by kind. ``busy_s`` is the union of the device events'
intervals (events that overlap count once); an idle gap is an interval of
the segment in which no device event ran, named by the innermost host
event that covers its middle.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

WINDOW = "bench.traced_segment"

# the port's kernels: the function names in accel_tpu_torch/kernels/<name>.cu
# (each in an anonymous namespace, so a mangled name also carries
# "_<name>_cu_")
KERNELS = {"warp": "warp_kernel", "upsample_argmax": "upsample_argmax_kernel",
           "fused_stem": "fused_stem_", "warp_onehot": "warp_onehot_kernel",
           "dilated_conv": "dilated_conv_"}


def port_kernel(event_name: str) -> str | None:
    """Which of the port's kernels a device event is, if any."""
    for name, fn in KERNELS.items():
        if f"(anonymous namespace)::{fn}" in event_name or f"_{name}_cu_" in event_name:
            return name
    return None


def union_s(intervals) -> float:
    """Seconds covered by (start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


class Trace:
    def __init__(self, device: list, host: list, window_s: float, frames: dict):
        self.device = device      # [(name, start_s, end_s)]
        self.host = host          # [(name, start_s, end_s)]
        self.window_s = window_s
        self.frames = frames      # frames served in the segment: "frame", "key", "cur"

    def busy_s(self) -> float:
        return union_s((s, e) for _, s, e in self.device)

    def kernel_s(self, kernel: str) -> float:
        """Device seconds of the events of one of the port's kernels."""
        return sum(e - s for name, s, e in self.device if port_kernel(name) == kernel)

    def device_ops(self, top: int = 10) -> list:
        by_name: dict[str, float] = {}
        for name, s, e in self.device:
            by_name[name[:160]] = by_name.get(name[:160], 0.0) + (e - s)
        return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """The idle time of the segment summed by the host event under it."""
        gaps, end = [], 0.0
        for s, e in sorted((s, e) for _, s, e in self.device):
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if end < self.window_s:
            gaps.append((end, self.window_s))
        if not gaps:
            return []
        names = [n for n, _, _ in self.host]
        hs = np.array([s for _, s, _ in self.host] or [0.0])
        he = np.array([e for _, _, e in self.host] or [0.0])
        by_name: dict[str, float] = {}
        for s, e in gaps:
            mid = 0.5 * (s + e)
            cover = np.flatnonzero((hs <= mid) & (he >= mid)) if names else []
            name = (names[cover[np.argmin((he - hs)[cover])]] if len(cover)
                    else "host outside any traced call")
            by_name[name[:160]] = by_name.get(name[:160], 0.0) + (e - s)
        return sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:top]


@contextlib.contextmanager
def traced(frames: dict):
    """Profile the scope (host and, where there is a card, device
    activity). Yields a dict that holds, after the scope, the ``Trace``
    under 'trace'; ``frames`` is the caller's count of the frames it
    served inside the scope, by kind, filled while the scope runs."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    out = {}
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            yield out
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            out["host_window_s"] = time.perf_counter() - t0
    # the raw events: building the profiler's event tree (``prof.events()``)
    # takes tens of seconds for a traced segment of a few thousand launches
    events = prof.profiler.kineto_results.events()
    window = next(e for e in events if e.name() == WINDOW and e.device_type() == DeviceType.CPU)
    w0, w1 = window.start_ns(), window.end_ns()
    device, host = [], []
    for e in events:
        s, t = (e.start_ns() - w0) / 1e9, (e.end_ns() - w0) / 1e9
        if e.device_type() == DeviceType.CUDA:
            # a record_function range shows on the device's timeline too
            if not e.is_user_annotation() and e.name() != WINDOW:
                device.append((e.name(), s, t))
        elif e.name() != WINDOW:
            host.append((e.name(), s, t))
    out["trace"] = Trace(device, host, (w1 - w0) / 1e9, frames)
