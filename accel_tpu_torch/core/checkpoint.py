"""Checkpoints and their training provenance (counterpart of
``accel_tpu/core/checkpoint.py``).

A port checkpoint is a ``torch.save``d dict, ``<prefix>/<epoch>.pt``, whose
``"model"`` entry is the model's ``state_dict``; the trainer's
(:func:`train_checkpoint`) holds the f32 master weights there, so that
``load_state_dict`` into a bf16 model rounds them as flax's cast does, and
adds ``"optimizer"`` (the momentum trace and the step count), ``"step"``
and ``"epoch"``, which :func:`restore_train_state` resumes from. The reference's orbax
checkpoints have no reader here, since orbax needs JAX: a JAX checkpoint
reaches the port by restoring it in JAX and passing its variables through
``accel_tpu_torch.convert.flax_to_torch``.

``provenance.json`` beside the checkpoints records the semantics the
weights were trained through; :func:`check_eval_semantics` refuses the eval
semantics measured to collapse such a checkpoint (the reference's messages
and cases, unchanged).
"""

from __future__ import annotations

import json
import os
import re

import torch

PROVENANCE_FILE = "provenance.json"


def save_provenance(prefix_dir: str, prov: dict) -> None:
    os.makedirs(prefix_dir, exist_ok=True)
    with open(os.path.join(prefix_dir, PROVENANCE_FILE), "w") as f:
        json.dump(prov, f, indent=1, sort_keys=True)


def load_provenance(prefix_dir: str) -> dict | None:
    path = os.path.join(prefix_dir, PROVENANCE_FILE)
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def provenance_from_cfg(cfg) -> dict:
    return {
        "objective": str(cfg.TRAIN.objective),
        "propagate": str(cfg.network.propagate),
        "scale_field_norm": str(cfg.network.scale_field_norm),
        "scale_cascade": str(cfg.network.scale_cascade),
        "family": str(cfg.network.name),
    }


class EvalSemanticsError(ValueError):
    """Eval semantics known (measured) to collapse this checkpoint."""


def check_eval_semantics(
    prov: dict | None, eval_propagate: str, eval_network, force: bool = False
) -> list[str]:
    """Compare a checkpoint's training provenance against the requested
    eval semantics. Returns human-readable warnings for benign mismatches
    (eval-time interventions); raises :class:`EvalSemanticsError` for the
    measured-collapse combinations unless ``force``.

    ``eval_network`` is the post-override cfg.network (dict-like with
    scale_cascade / scale_field_norm).
    """
    if prov is None:
        return []
    warnings: list[str] = []
    objective = prov.get("objective")
    trained_prop = prov.get("propagate")
    cascading = eval_propagate in ("incremental", "composed")

    trained_cascade = prov.get("scale_cascade")
    eval_cascade = (
        str(eval_network.get("scale_cascade"))
        if eval_network is not None and eval_network.get("scale_cascade")
        is not None
        else None
    )

    fatal = None
    if objective == "pair" and cascading:
        fatal = (
            f"pair-trained checkpoint evaluated --propagate {eval_propagate}: "
            "the pair objective supervises exactly ONE warp; its scale field "
            "compounds under cascade (measured 80.0 -> 20.2 mIoU, "
            "BASELINE.md propagation table)"
        )
    elif objective == "clip" and trained_prop == "direct" and cascading:
        fatal = (
            f"clip-through-direct checkpoint evaluated --propagate "
            f"{eval_propagate}: a direct-trained scale field is calibrated "
            "for exactly one warp (measured 84.36 -> 31.97 mIoU, BASELINE.md "
            "r4 decision table)"
        )
    elif (
        objective == "clip"
        and cascading
        and trained_cascade == "last"
        and eval_cascade == "product"
    ):
        fatal = (
            "'last'-trained checkpoint evaluated under the 'product' "
            "cascade: re-introduces the compounding scale product the "
            "model never trained through (measured r5: 87.45 -> 31.27 "
            "mIoU at k=5 and 87.38 -> 16.47 at k=10 on the extreme "
            "clip-last arm — BASELINE.md)"
        )
    if fatal is not None:
        if not force:
            raise EvalSemanticsError(
                fatal + " — pass --force to evaluate anyway"
            )
        warnings.append("FORCED past known-collapse semantics: " + fatal)
    elif trained_prop is not None and eval_propagate != trained_prop:
        warnings.append(
            f"eval propagate={eval_propagate!r} differs from the semantics "
            f"this checkpoint was trained through ({trained_prop!r}) — "
            "intentional for eval-time intervention studies; not the "
            "checkpoint's native operating point"
        )

    if (
        cascading
        and trained_cascade is not None
        and eval_cascade is not None
        and eval_cascade != trained_cascade
        and fatal is None
    ):
        # cascade semantics only act on cascading eval paths (direct mode
        # performs a single warp — interventions are vacuous there)
        if trained_cascade == "product" and eval_cascade == "last":
            warnings.append(
                "eval scale_cascade='last' on a product-trained checkpoint "
                "— the measured-BEST incremental eval semantics "
                "(BASELINE.md intervention table), an intentional "
                "eval-time intervention, not a hazard"
            )
        else:
            warnings.append(
                f"eval scale_cascade={eval_cascade!r} differs from trained "
                f"{trained_cascade!r} — eval-time intervention; cascade "
                "mismatches have measured up to ~25 mIoU at k=10 "
                "(BASELINE.md intervention table)"
            )
    tn = prov.get("scale_field_norm")
    en = (str(eval_network.get("scale_field_norm"))
          if eval_network is not None
          and eval_network.get("scale_field_norm") is not None else None)
    if tn is not None and en is not None and en != tn:
        warnings.append(
            f"eval scale_field_norm={en!r} differs from trained {tn!r} — "
            "the scale field's calibration is recipe-bound (BASELINE.md "
            "r2 gain A/B)"
        )
    return warnings


def _path(prefix_dir: str, epoch: int) -> str:
    return os.path.join(prefix_dir, f"{int(epoch)}.pt")


def save_checkpoint(prefix_dir: str, epoch: int, state: dict) -> None:
    """Save ``state`` (a dict with a ``"model"`` state_dict) as ``epoch``,
    replacing an earlier save of that epoch. The file is written whole
    under a temporary name first, so a crash leaves no torn checkpoint."""
    os.makedirs(prefix_dir, exist_ok=True)
    path = _path(prefix_dir, epoch)
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)


def load_checkpoint(prefix_dir: str, epoch: int, map_location="cpu") -> dict:
    """The state saved as ``epoch`` (tensors only: ``weights_only``)."""
    return torch.load(_path(prefix_dir, epoch), map_location=map_location, weights_only=True)


def saved_epochs(prefix_dir: str) -> list[int]:
    """Every saved epoch, ascending. With TRAIN.checkpoint_interval > 1 not
    every epoch exists, so a caller wanting "epoch <= N" picks from here."""
    if not os.path.isdir(prefix_dir):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(prefix_dir)
                  if (m := re.fullmatch(r"(\d+)\.pt", name)))


def latest_epoch(prefix_dir: str) -> int | None:
    """The newest saved epoch, or None."""
    epochs = saved_epochs(prefix_dir)
    return epochs[-1] if epochs else None


def train_checkpoint(state, epoch: int) -> dict:
    """A ``core.trainer.TrainState`` as a checkpoint dict on the host:
    ``"model"`` (the state_dict with each parameter's f32 master copy),
    ``"optimizer"`` ({"count", "trace"}), ``"step"`` and ``"epoch"``."""
    model = {k: state.master.get(k, v).detach().cpu()
             for k, v in state.model.state_dict().items()}
    trace = {k: v.detach().cpu() for k, v in state.opt_state["trace"].items()}
    return {"model": model, "optimizer": {"count": int(state.opt_state["count"]), "trace": trace},
            "step": int(state.step), "epoch": int(epoch)}


@torch.no_grad()
def restore_train_state(state, ckpt: dict):
    """Resume ``state`` (a ``TrainState`` of the same model) from a
    ``train_checkpoint`` dict: the master weights and the momentum exactly,
    the model from the master weights (rounded to its dtypes), the step."""
    state.model.load_state_dict(ckpt["model"])
    for k, v in state.master.items():
        v.copy_(ckpt["model"][k])
    for k, v in state.opt_state["trace"].items():
        v.copy_(ckpt["optimizer"]["trace"][k])
    state.opt_state["count"] = int(ckpt["optimizer"]["count"])
    state.step = int(ckpt["step"])
    return state
