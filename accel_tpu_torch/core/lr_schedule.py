"""Warmup + multi-step learning-rate decay (counterpart of
``accel_tpu/core/lr_schedule.py``): a linear warmup to the base rate, then
a multiply by ``factor`` at each step boundary.

The schedule is a plain function of the step. It computes in float32,
operation for operation as the JAX schedule does, so both give the same
rate bit for bit.
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np


def warmup_multifactor_schedule(base_lr: float, steps: Sequence[int], factor: float = 0.1,
                                warmup: bool = True, warmup_lr: float = 0.0,
                                warmup_steps: int = 0):
    """Returns f(step) -> lr, a Python float (an f32 value).

    ``steps``: global-step boundaries at which lr *= factor. During the
    first ``warmup_steps`` steps, lr ramps linearly from ``warmup_lr`` to
    ``base_lr`` (the reference's 'linear' warmup)."""
    f32 = np.float32
    boundaries = sorted(int(s) for s in steps)

    def schedule(step: int) -> float:
        step = int(step)
        n_decays = sum(step >= b for b in boundaries)
        lr = f32(base_lr) * (f32(factor) ** f32(n_decays))
        if warmup and warmup_steps > 0 and step < warmup_steps:
            frac = min(f32(step) / f32(warmup_steps), f32(1.0))
            lr = f32(warmup_lr) + f32(base_lr - warmup_lr) * frac
        return float(lr)

    return schedule


def lr_steps_from_epochs(lr_step_csv: str, epoch_size: int, begin_epoch: int = 0) -> list[int]:
    """The reference's 'lr_step' epoch csv ('3.333,4.5') as global steps;
    epochs at or before ``begin_epoch`` are dropped."""
    out = []
    for tok in str(lr_step_csv).split(","):
        tok = tok.strip()
        if tok and float(tok) > begin_epoch:
            out.append(int(float(tok) * epoch_size))
    return out
