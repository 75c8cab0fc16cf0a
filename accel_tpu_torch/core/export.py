"""Serving export (counterpart of ``accel_tpu/core/export.py``): the group
program that ``VideoSegmenter.push_group`` runs, traced by
``torch.export`` and saved as one artifact.

The artifact is the magic line ``ACCELTPU_TORCH_SERVING1\\n`` followed by
a ``torch.export.save`` archive. Unlike the JAX package's StableHLO, it is
not self-contained: the five kernels are ``torch.library`` ops registered
from Python (``torch.ops.accel_tpu_torch.*``, defined beside each kernel's
wrapper in ``ops/``), and the archive names them. So the serving host
needs ``accel_tpu_torch`` importable (and, on a card, the kernels it
builds); the model's Python classes and cfgs are not needed.
:func:`load_serving` imports the ops before it loads.

Two packaging modes, as in the JAX package:

- ``embed_params=True``: the weights are the program's ``state_dict``, a
  single file.
- ``embed_params=False``: the program takes the model's state dict as its
  first argument (``torch.func.functional_call``); the kernels' weight
  packings are computed inside the program from the weights it is called
  with (``models/resnet.py::PackedWeight``), so one artifact serves any
  checkpoint of the architecture.

``batch`` is an int for a static clip batch or a name for a symbolic one
(``torch.export.Dim(name, min=1)``): one artifact serves any batch. H, W
and the interval stay static. The JAX package's ``platforms=`` has no
counterpart: the program runs on the device of the model it was traced
from.
"""

from __future__ import annotations

import io
from collections.abc import Mapping

import torch
from torch import nn

# importing the pipeline imports every op module, which registers the five ops
from accel_tpu_torch.core.pipeline import clip_predictions_body

# serialized artifacts start with this magic so load_serving can reject
# arbitrary files early with a clear error
MAGIC = b"ACCELTPU_TORCH_SERVING1\n"


class ServingProgram(nn.Module):
    """The group serving program as a module: clip (B,F,H,W,3) f32 ->
    (B,F,H,W) uint8 class maps (or (B,F,h,w) without ``full_res``), the
    program ``push_group`` runs, with ``model`` as its one submodule."""

    def __init__(self, model, interval: int, propagate: str = "direct",
                 full_res: bool = True, upsample: str = "bilinear_logits"):
        super().__init__()
        self.model = model
        self.interval, self.propagate = int(interval), propagate
        self.full_res, self.upsample = full_res, upsample

    def forward(self, clip: torch.Tensor) -> torch.Tensor:
        return clip_predictions_body(self.model, clip, self.interval, self.propagate,
                                     self.full_res, self.upsample)


class _StateArgument(nn.Module):
    """``(state, clip) -> program(clip)`` with the model's tensors taken
    from ``state`` (its ``state_dict`` keys); the program is held outside
    the module tree, so this module owns no tensor."""

    def __init__(self, program: ServingProgram):
        super().__init__()
        object.__setattr__(self, "program", program)

    def forward(self, state: dict[str, torch.Tensor], clip: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(
            self.program, {f"model.{k}": v for k, v in state.items()}, (clip,))


def make_serving_fn(model, interval: int, propagate: str = "direct", full_res: bool = True,
                    upsample: str = "bilinear_logits") -> ServingProgram:
    """``fn(clip)`` -> (B, F, H, W) uint8 predictions of ``model``'s
    weights: the group serving program (``push_group``'s). Call it under
    ``torch.no_grad()``."""
    return ServingProgram(model, interval, propagate, full_res, upsample)


def export_serving(model, state: Mapping[str, torch.Tensor] | None,
                   frame_hw: tuple[int, int], interval: int, propagate: str = "direct",
                   batch: int | str = "b", full_res: bool = True,
                   upsample: str = "bilinear_logits", embed_params: bool = True,
                   path: str | None = None) -> bytes:
    """Export the clip-serving program of ``model`` on its device; returns
    the artifact's bytes (and writes them to ``path`` if given).

    ``state``: None for the model's own weights, or a state dict of the
    model's keys, which is loaded into ``model`` first (embedded) or only
    gives the argument's shapes and dtypes (``embed_params=False``).
    ``batch``: an int for a static clip batch, or a symbolic dim name
    (default ``'b'``) for a batch-polymorphic artifact."""
    H, W = int(frame_hw[0]), int(frame_hw[1])
    F = int(interval) if model.family != "deeplab" else 1
    device = next(model.parameters()).device
    program = make_serving_fn(model, interval, propagate, full_res, upsample)
    if isinstance(batch, str):
        example_b, dims = 2, {0: torch.export.Dim(batch, min=1)}
    else:
        example_b, dims = int(batch), None
    clip = torch.zeros((example_b, F, H, W, 3), dtype=torch.float32, device=device)
    with torch.no_grad():
        if embed_params:
            if state is not None:
                model.load_state_dict(state)
            exported = torch.export.export(program, (clip,), dynamic_shapes=(dims,))
        else:
            if state is None:
                state = model.state_dict()
            state = {k: torch.empty_like(v, device=device) for k, v in state.items()}
            exported = torch.export.export(_StateArgument(program), (state, clip),
                                           dynamic_shapes=({k: None for k in state}, dims))
    # the example inputs (a zero clip; for embed_params=False a copy of the
    # weights' shapes) are not kept in the artifact
    exported.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = MAGIC + buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_serving(src):
    """Load an artifact (a path or bytes) -> callable: ``fn(clip)`` when
    the weights were embedded, else ``fn(state, clip)``, run under
    ``torch.inference_mode`` (as ``push_group`` runs). ``fn.exported`` is
    the ``torch.export.ExportedProgram``.
    Raises ``ValueError`` on a file without the magic."""
    if isinstance(src, (bytes, bytearray)):
        blob = bytes(src)
    else:
        with open(src, "rb") as f:
            blob = f.read()
    if not blob.startswith(MAGIC):
        raise ValueError("not an accel_tpu_torch serving artifact (missing magic header)")
    exported = torch.export.load(io.BytesIO(blob[len(MAGIC):]))
    module = exported.module()

    def call(*args):
        if len(args) == 2:  # a state_dict() is an OrderedDict; the program takes a dict
            args = (dict(args[0]), args[1])
        with torch.inference_mode():
            return module(*args)

    call.exported = exported
    return call
