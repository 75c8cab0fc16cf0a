"""One run of one cell: set-up, the measured window, the traced segment,
the check against the plain reference, and the result line.

The order matters: the program is built and warmed (set-up), serves the
window, then, with ``--trace 1``, a short traced segment of the same
traffic; the device's peak memory is read; the program is freed; and only
then is the plain f32 reference built and run over a sample of what the
window served, drawn from the seed, so that its memory and time count
neither in the peak nor in ``setup_s``.
"""

from __future__ import annotations

import gc
import json
import math
import random
import subprocess
import sys
import time

import torch

from benchmark import correctness, spec, weights
from benchmark.devtrace import traced

# modules that no run may hold once its window has closed, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "accel_tpu")


class NoDevice(RuntimeError):
    pass


class Run:
    """What one run holds: the cell, the seed, the device, the weights and
    frames it made, the program it serves, and what the window and the
    traced segment recorded (``records``, ``window_s``, ``trace``)."""

    def __init__(self, cell: spec.Cell, seed: int, device: str):
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.config, self.traffic = cell.config, cell.workload
        self.model = None
        self.records: list[dict] = []
        self.window_s = 0.0
        self.trace = None
        self.phases: dict[str, float] = {}
        self._last = time.perf_counter()

    def stamp(self, phase: str) -> None:
        """Record the seconds since the last stamp under ``phase``."""
        now = time.perf_counter()
        self.phases[phase] = self.phases.get(phase, 0.0) + now - self._last
        self._last = now

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def forbidden_modules() -> list[str]:
    """Modules in ``sys.modules`` whose top-level name, compared whole, is
    one of ``FORBIDDEN``."""
    return sorted(name for name in sys.modules if name.split(".")[0] in FORBIDDEN)


def build_program(run: Run, state: dict, network: dict):
    """The program's model of ``network`` on the run's device, holding
    ``state`` (the benchmark's weights, copied in)."""
    from accel_tpu_torch.models.accel import build_model

    run.stamp("setup.program_import")
    model = build_model(network, num_classes=run.config["num_classes"], device="meta",
                        generator=None)
    want = {k: (t.shape, t.dtype) for k, t in model.state_dict().items()}
    got = {k: (t.shape, t.dtype) for k, t in state.items()}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))[:6]
        raise RuntimeError(f"the reference's weight layout is not the program's: {diff}")
    run.stamp("setup.program_meta")
    model.to_empty(device=run.device)
    model.load_state_dict(state)
    return model.eval()


def reference(run: Run, prefix: str = ""):
    """The f32 reference holding the run's weights on its device; with
    ``prefix``, only that submodule (e.g. 'flownet'), the rest left on the
    meta device."""
    ref = spec.reference_model(run.config, torch.float32, "meta")
    part = ref.get_submodule(prefix) if prefix else ref
    part.to_empty(device=run.device)
    head = f"{prefix}." if prefix else ""
    part.load_state_dict({k[len(head):]: v for k, v in run.weights.items() if k.startswith(head)})
    return ref


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out = f"nvidia-smi failed: {e}"
    return dict(card=out)


def setup(run: Run, network: dict | None = None) -> None:
    """Weights and frames from the seed, the flow head calibrated on the
    reference, the program built and warmed on this cell's shapes."""
    config = run.config
    dtype = getattr(torch, config["network"]["dtype"])
    layout = spec.reference_model(config, dtype, "meta")
    run.weights = weights.draw(layout, run.seed, run.device)
    driver = run.cell.driver
    driver.prepare(run)
    run.sync()
    run.stamp("setup.weights_frames")
    ref = reference(run, "flownet")
    with torch.inference_mode():
        run.flow_scale = weights.calibrate_flow(run.weights, ref, driver.calibration_pair(run))
    del ref
    run.stamp("setup.flow_head")
    if run.device.type == "cuda":
        from accel_tpu_torch import kernels

        kernels.build()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(run.device)
    run.stamp("setup.kernels")
    run.model = build_program(run, run.weights, network or config["network"])
    run.sync()
    run.stamp("setup.program")
    with torch.inference_mode():
        driver.warm(run)
    run.sync()
    run.stamp("setup.warm")


def check(run: Run) -> tuple[dict, int]:
    """The reference over the sample of served frames the driver draws
    from the seed, and over the same frames rounded to bf16: the gap
    numbers (``benchmark/correctness.py``) and the frames checked. TF32
    off."""
    rng = random.Random(weights.derive(run.seed, "check"))
    cudnn_tf32, mm_tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = reference(run)
        gaps, probe = correctness.Gaps(), correctness.Gaps()
        with torch.inference_mode():
            for frames, upto, served in run.cell.driver.sample(run, rng):
                n = served.shape[0]
                logits = ref.group_logits(frames, run.config["propagate"], upto)[-n:]
                gaps.add(logits, served)
                rounded = frames.to(torch.bfloat16).to(torch.float32)
                probe_logits = ref.group_logits(rounded, run.config["propagate"], upto)[-n:]
                probe.add(logits, correctness.class_maps(probe_logits, served.shape[-2:]))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = (
            cudnn_tf32, mm_tf32)
    return correctness.numbers(gaps, probe), gaps.frames


def execute(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
            t0: float | None = None, network: dict | None = None, emit=print) -> dict:
    """One run; returns the result dict (the last line's JSON). ``device``
    'cpu' runs the program's CPU path at whatever size the configuration
    gives (tests); 'cuda' needs as many cards as the cell asks for, else
    ``NoDevice``. ``network`` replaces the configuration's program
    settings (the lower-precision control); the reference and the
    weights' layout keep the configuration's."""
    t0 = time.perf_counter() if t0 is None else t0
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell.chips):
        raise NoDevice(f"the cell needs {cell.chips} CUDA device(s); "
                       f"available: {torch.cuda.is_available()}, "
                       f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    run = Run(cell, seed, device)
    run.phases["setup.start"] = run._last - t0
    driver = cell.driver
    setup(run, network)
    setup_s = time.perf_counter() - t0
    with torch.inference_mode():
        driver.serve(run, seconds)
        run.stamp("window")
        if trace:
            frames: dict = {}
            with traced(frames) as out:
                driver.traced_segment(run, frames)
            run.trace = out["trace"]
            run.phases["traced_segment"] = out["host_window_s"]
            run.stamp("trace")
    device_info = dict(platform="gpu" if run.device.type == "cuda" else "cpu",
                       kind=torch.cuda.get_device_name(run.device) if run.device.type == "cuda"
                       else "cpu", count=cell.chips,
                       memory_peak_bytes=torch.cuda.max_memory_allocated(run.device)
                       if run.device.type == "cuda" else 0)
    if trace:
        device_info.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
    attempted, failed = driver.counts(run)
    if trace:
        metrics = {}
        for entry, reader in cell.per_layer:
            value = reader.read(run)
            if value is not None:
                metrics[entry["name"]] = dict(value=value, unit=entry["unit"])
    else:
        values = dict(driver.end_to_end(run), setup_s=setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                   for m in cell.end_to_end}
    if run.device.type == "cuda":
        emit(json.dumps(card()))
    run.stamp("metrics")
    run.model = None
    run.segmenters = None
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, checked = check(run)
    run.stamp("check")
    emit(json.dumps(dict(phases_s=run.phases)))
    # last before the result: what the window served (live: how late the
    # generator ran)
    for line in driver.report(run):
        emit(json.dumps(line))
    ok, compared = correctness.judge(numbers, cell.workload["limits"])
    result = dict(correct=bool(ok and failed == 0 and checked > 0), attempted=attempted,
                  failed=failed, metrics=metrics, device=device_info)
    if trace:
        result["breakdown"] = dict(device_ops=run.trace.device_ops(),
                                   idle_gaps=run.trace.idle_gaps())
    result["gaps"] = numbers
    result["compared"] = dict(compared, frames_failed=dict(value=failed, limit=0))
    return result


def finite(obj):
    """``obj`` with every infinite or NaN float replaced by +-1e300 (JSON
    has no infinity)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return -1e300 if obj < 0 else 1e300
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [finite(v) for v in obj]
    return obj


def main(args, t0: float) -> int:
    try:
        cell = spec.load_cell(args.workload)
        result = execute(cell, args.seed, args.seconds, bool(args.trace), t0=t0)
    except NoDevice as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 3
    result = finite(result)
    for name, c in result["compared"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
