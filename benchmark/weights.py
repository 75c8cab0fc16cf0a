"""Seeded weights for both sides of the comparison, made on the device.

The benchmark owns the weights: one dict, drawn from ``--seed`` on the
device in a few large calls, in the dtype each tensor is served in, which
loads into the program (``load_state_dict``) and, cast to f32, into the
plain reference. Conv weights are lecun-normal (variance 1/fan_in), biases
and FrozenBN shifts zero, FrozenBN scales one, FlowNet's coarse flow heads
zero, and the fusion the identity average ``0.5*I | 0.5*I``, as the
program's own initialisation has them. FlowNet's last flow head and its
scale field are drawn so that the flow moves content: the flow head is
scaled, the flow being linear in it, so that the reference's largest
displacement between a clip's first two frames is ``FLOW_TARGET`` feature
pixels.
"""

from __future__ import annotations

import hashlib

import torch
from torch import nn

FLOW_TARGET = 3.0
ZERO_HEADS = ("flownet.predict_flow6", "flownet.predict_flow5", "flownet.predict_flow4",
              "flownet.predict_flow3")


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of ``seed``, so every draw is its own."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def _rule(name: str, module: nn.Module, leaf: str):
    """(kind, std or value) for one tensor: ('normal', std) or ('fill', value)."""
    if name == "fusion" and leaf == "weight":
        return "fusion", None
    if leaf in ("running_mean", "bias") and not name.startswith("flownet.scale_field"):
        return "fill", 0.0
    if leaf == "running_var" or not isinstance(module, nn.Conv2d):
        return "fill", 1.0
    if name.startswith(ZERO_HEADS):
        return "fill", 0.0
    if name == "flownet.scale_field":
        return ("normal", 0.05) if leaf == "weight" else ("fill", 1.0)
    if name == "flownet.predict_flow2":
        return "normal", 1.0
    fan_in = module.weight.shape[1] * module.weight.shape[2] * module.weight.shape[3]
    return "normal", fan_in ** -0.5


@torch.no_grad()
def draw(layout: nn.Module, seed: int, device) -> dict[str, torch.Tensor]:
    """The weight dict of ``layout`` (a model on the meta device, its
    tensors in their serving dtypes) drawn from ``seed`` on ``device``:
    one normal draw and one fill per dtype, then views."""
    rules = {}
    for mname, module in layout.named_modules():
        for leaf, t in list(module.named_parameters(recurse=False)) + list(
                module.named_buffers(recurse=False)):
            rules[f"{mname}.{leaf}" if mname else leaf] = (_rule(mname, module, leaf), t)
    out = {}
    gen = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    for dtype in sorted({t.dtype for _, t in rules.values()}, key=str):
        normal = [(k, std, t) for k, ((kind, std), t) in rules.items()
                  if t.dtype == dtype and kind == "normal"]
        if normal:
            sizes = [t.numel() for _, _, t in normal]
            std = torch.repeat_interleave(
                torch.tensor([s for _, s, _ in normal], device=device),
                torch.tensor(sizes, device=device))
            flat = (torch.randn(sum(sizes), generator=gen, device=device) * std).to(dtype)
            for (k, _, t), part in zip(normal, flat.split(sizes)):
                out[k] = part.view(t.shape)
        for value in (0.0, 1.0):
            fills = [(k, t) for k, ((kind, v), t) in rules.items()
                     if t.dtype == dtype and kind == "fill" and v == value]
            if fills:
                sizes = [t.numel() for _, t in fills]
                flat = torch.full((sum(sizes),), value, dtype=dtype, device=device)
                for (k, t), part in zip(fills, flat.split(sizes)):
                    out[k] = part.view(t.shape)
    for k, ((kind, _), t) in rules.items():
        if kind == "fusion":
            c = t.shape[0]
            eye = 0.5 * torch.eye(c, dtype=t.dtype, device=device)
            out[k] = torch.cat([eye, eye], dim=1).view(t.shape)
    return {k: out[k] for k in layout.state_dict()}


@torch.no_grad()
def calibrate_flow(weights: dict, reference, frames: torch.Tensor) -> float:
    """Scale ``flownet.predict_flow2.weight`` in ``weights`` so that the f32
    reference's largest flow between ``frames[0]`` and ``frames[1]``
    ((2,3,H,W), at the reference's device) is ``FLOW_TARGET`` feature
    pixels. ``reference`` is an f32 reference model holding ``weights``.
    Returns the scale applied."""
    flow, _ = reference.flow(frames[1:2], frames[0:1])
    factor = FLOW_TARGET / flow.abs().max().item()
    weights["flownet.predict_flow2.weight"].mul_(factor)
    return factor
