"""How the served class maps are judged against the plain reference.

For each checked frame the reference's f32 logits at feature stride are
upsampled to the frame (bilinear, half-pixel centres: the serving tail's
resize) and, at every pixel, the gap by which the served class's logit
lies below the reference's best is taken, as a share of the frame's
largest reference logit. A served class equal to the reference's best has
gap 0; a class flipped at a near-tie a gap within rounding.

How large those gaps run for a sound program depends on the seed: a
random-weight model's sensitivity (how many pixels lie near a tie, how
far a rounding travels through the layers) swings from seed to seed, and
the program's and its int8 path's gaps swing with it, so far that the
int8 path on one seed reads as the bf16 program on another. The held
number therefore divides by the seed's own sensitivity, which the
reference measures alone: the same gaps for the reference's class maps
on the same frames rounded to bf16 (the program's first rounding).

- ``mean_gap_ratio`` (held): the served maps' summed gap over the
  reference-on-rounded-frames maps' summed gap, over the same pixels;
- ``widest_gap``: the largest gap over every checked pixel;
- ``mean_gap``: the mean gap over every checked pixel;
- ``clear_flip_share``: the share of checked pixels whose gap exceeds
  ``CLEAR_MARGIN``, whose served class is clearly not the best;
- ``mean_flip_gap``: the mean gap over the pixels whose served class is
  not the reference's best;
- ``probe_mean_gap``: ``mean_gap`` of the rounded-frames maps.

A cell holds the numbers its workload file gives limits for. A served
class index outside the classes reads as an infinite gap.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CLEAR_MARGIN = 1e-2
NUMBERS = ("mean_gap_ratio", "widest_gap", "mean_gap", "clear_flip_share", "mean_flip_gap",
           "probe_mean_gap")


class Gaps:
    """Running gap statistics over the checked frames."""

    def __init__(self):
        self.widest = 0.0
        self.total = 0.0
        self.flips = 0
        self.flipped = 0
        self.pixels = 0
        self.frames = 0

    @torch.no_grad()
    def add(self, ref_logits: torch.Tensor, served: torch.Tensor) -> None:
        """``ref_logits`` (n, C, h, w) f32 and ``served`` (n, H, W) uint8
        class maps of the same n frames."""
        served = served.to(ref_logits.device)
        for f in range(ref_logits.shape[0]):
            up = F.interpolate(ref_logits[f:f + 1], size=tuple(served.shape[-2:]),
                               mode="bilinear", align_corners=False)[0]
            cls = served[f].long()
            if int(cls.max()) >= up.shape[0]:
                self.widest = math.inf
                cls = cls.clamp(max=up.shape[0] - 1)
            gap = (up.max(dim=0).values - up.gather(0, cls[None])[0]) / up.abs().max()
            self.widest = max(self.widest, gap.max().item())
            self.total += gap.sum(dtype=torch.float64).item()
            self.flips += int((gap > CLEAR_MARGIN).sum())
            self.flipped += int((gap > 0).sum())
            self.pixels += gap.numel()
            self.frames += 1

    def numbers(self) -> dict[str, float]:
        return dict(widest_gap=self.widest, mean_gap=self.total / max(self.pixels, 1),
                    clear_flip_share=self.flips / max(self.pixels, 1),
                    mean_flip_gap=self.total / max(self.flipped, 1))


def class_maps(logits: torch.Tensor, hw) -> torch.Tensor:
    """(n, H, W) uint8 class maps of logits (n, C, h, w): the serving
    tail's upsample and argmax, in f32, a frame at a time."""
    return torch.stack([F.interpolate(logits[f:f + 1], size=tuple(hw), mode="bilinear",
                                      align_corners=False)[0].argmax(0)
                        for f in range(logits.shape[0])]).to(torch.uint8)


def numbers(served: Gaps, probe: Gaps) -> dict[str, float]:
    """Every number of the served maps' gaps ``served``, judged against
    the rounded-frames maps' ``probe`` over the same pixels."""
    out = served.numbers()
    if probe.total > 0:
        ratio = served.total / probe.total
    else:
        ratio = math.inf if served.total > 0 else 0.0
    return dict(mean_gap_ratio=ratio, **out, probe_mean_gap=probe.numbers()["mean_gap"])


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(every limited number within its limit, {name: {value, limit}})."""
    compared = {k: dict(value=numbers[k], limit=float(v)) for k, v in limits.items()}
    return all(c["value"] <= c["limit"] for c in compared.values()), compared
