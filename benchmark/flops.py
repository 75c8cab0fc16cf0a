"""The work of one keyframe group, counted on the plain reference.

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions and
matrix products (2 operations a multiply-add) of the reference's forward
over one group, run on the meta device: no memory, no device, and the
same count whatever implements the group in the program. Resizes, warps,
norms and the argmax are not counted.
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode


@functools.cache
def _group_flops(config_json: str) -> int:
    from benchmark import spec

    config = json.loads(config_json)
    ref = spec.reference_model(config, torch.float32, "meta")
    k = config["key_interval"]
    frames = torch.empty((k, 3, *config["frame_hw"]), device="meta")
    with FlopCounterMode(display=False) as counter:
        ref.group_logits(frames, config["propagate"])
    return counter.get_total_flops()


def group_flops(config: dict) -> int:
    """Operations of one keyframe group of ``config`` (B=1)."""
    return _group_flops(json.dumps(config, sort_keys=True))
