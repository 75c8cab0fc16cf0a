"""Eval entry point: video mIoU and throughput at a keyframe interval
(counterpart of ``experiments/test.py``).

    python3 -m accel_tpu_torch.experiments.test --cfg experiments/cfgs/accel18_cityscapes.yaml
    python3 -m accel_tpu_torch.experiments.test --cfg <yaml> --device cpu --random-weights

Loads the cfg, applies ``TEST.serving_network`` and then ``--set-network``,
builds the model from the cfg, restores the newest port checkpoint at or
below ``TEST.test_epoch`` from ``<output_path>/<cfg name>/<image_set>/
<model_prefix>/`` (or takes seeded random weights), checks the eval
semantics against the checkpoint's ``provenance.json``, then runs
``TestClipLoader`` batches through ``pred_eval_clips`` for each interval
and offset asked for, logging per-class IoU, mIoU and fps.

It runs on the card (``--device cuda``, the default) and raises where
there is none; ``--device cpu`` runs the plain PyTorch versions of the
kernels. The reference's device mesh (its clip batch sharded over chips,
``tpu.mesh``) has no counterpart on one H100: ``TEST.BATCH_IMAGES`` clips
run as one batch on the one card. The reference's ``--vis`` and
``--ignore_cache``, which change nothing there, are not taken, and an
unknown flag is an error here, where the reference ignores it.
"""

from __future__ import annotations

import argparse
import os

import torch

from accel_tpu_torch.config import load_config
from accel_tpu_torch.core.checkpoint import (
    check_eval_semantics,
    load_checkpoint,
    load_provenance,
    saved_epochs,
)
from accel_tpu_torch.core.predictor import pred_eval_clips
from accel_tpu_torch.data.camvid import CamVid
from accel_tpu_torch.data.cityscapes import Cityscape
from accel_tpu_torch.data.loader import TestClipLoader
from accel_tpu_torch.data.prefetch import PrefetchingIter, to_device
from accel_tpu_torch.models.accel import build_model
from accel_tpu_torch.utils.logger import create_logger


def resolve_key_offsets(interval, ann_offsets=None, offsets=None, offset_sweep=False,
                        default_key_offset=0):
    """KEY_FRAME_OFFSET values to evaluate at ``interval``.

    The loader is keyed on the KEY offset (where the keyframe sits before
    the annotated frame), but results report the ANNOTATED offset
    ``interval - 1 - key``: ``--ann-offsets`` converts, ``--offsets``
    passes key offsets through, ``--offset-sweep`` takes every offset. A
    key offset outside [0, interval-1] raises ``ValueError``, the cfg's
    default included."""
    def _check(key_off, origin):
        if not 0 <= key_off < interval:
            raise ValueError(
                f"{origin} resolves to KEY_FRAME_OFFSET={key_off}, outside "
                f"[0, {interval - 1}] at interval {interval}"
            )
        return key_off

    if ann_offsets:
        return [_check(interval - 1 - int(x), f"--ann-offsets value {x}")
                for x in str(ann_offsets).split(",")]
    if offsets:
        return [_check(int(x), f"--offsets value {x}") for x in str(offsets).split(",")]
    if offset_sweep:
        return list(range(interval))
    return [_check(int(default_key_offset), "cfg TEST.KEY_FRAME_OFFSET")]


def parse_network_value(val: str):
    """A ``--set-network K=V`` value: 'true'/'false' (any case) as bools,
    then an int, then a float, else the string."""
    if val.lower() in ("true", "false"):
        return val.lower() == "true"
    for cast in (int, float):
        try:
            return cast(val)
        except ValueError:
            pass
    return val


def apply_network_overrides(cfg, set_network=()) -> None:
    """Each ``K=V`` of ``set_network`` into ``cfg.network``."""
    for kv in set_network:
        key, val = kv.split("=", 1)
        cfg.network[key] = parse_network_value(val)


def apply_serving_network(cfg, set_network=()) -> None:
    """Apply ``TEST.serving_network`` (the cfg's serving lowerings), then
    each ``K=V`` of ``set_network``, to ``cfg.network``, in that order, so
    that explicit flags win."""
    for key, val in (cfg.TEST.get("serving_network") or {}).items():
        cfg.network[key] = val
    apply_network_overrides(cfg, set_network)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test Accel/DFF/DeepLab (PyTorch, one GPU)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--interval", type=int, default=None, help="override KEY_FRAME_INTERVAL")
    p.add_argument("--sweep", default=None, help="csv of intervals to evaluate")
    p.add_argument("--propagate", default=None, choices=["direct", "incremental", "composed"],
                   help="override cfg.network.propagate for this eval")
    p.add_argument("--offset-sweep", action="store_true",
                   help="evaluate every annotated-frame offset 0..k-1 after the keyframe")
    p.add_argument("--offsets", default=None,
                   help="csv of KEY_FRAME_OFFSET values (KEY offsets; the logged row is the "
                        "ANNOTATED offset interval-1-key). Prefer --ann-offsets.")
    p.add_argument("--ann-offsets", default=None,
                   help="csv of ANNOTATED-frame offsets after the keyframe (converted to "
                        "KEY_FRAME_OFFSET = interval-1-ann)")
    p.add_argument("--quantize", action="store_true",
                   help="int8 serving quantization of both branches "
                        "(network.quantize_ref/quantize_update) for this eval")
    p.add_argument("--set-network", action="append", default=[], metavar="K=V",
                   help="override a cfg.network field for this eval (after "
                        "TEST.serving_network), e.g. --set-network warp_dtype=native")
    p.add_argument("--warp-max-disp", type=int, default=None,
                   help="override network.warp_max_disp (the warp's displacement clamp, "
                        "feature pixels)")
    p.add_argument("--max-items", type=int, default=None)
    p.add_argument("--random-weights", action="store_true",
                   help="skip the checkpoint restore: weights from seed 0")
    p.add_argument("--force", action="store_true",
                   help="evaluate even semantics measured to collapse the checkpoint "
                        "(check_eval_semantics)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card); 'cpu' runs the kernels' plain "
                        "versions")
    return p.parse_args(argv)


def main(argv=None) -> list[dict]:
    """Run the eval; returns one dict per (interval, offset):
    {'interval', 'ann_offset', 'miou', 'iou', 'stats'} (``pred_eval_clips``'
    stats)."""
    args = parse_args(argv)
    cfg = load_config(args.cfg)
    if args.interval:
        cfg.TEST.KEY_FRAME_INTERVAL = args.interval
    if args.quantize:
        cfg.network.quantize_ref = True
        cfg.network.quantize_update = True
    if args.warp_max_disp is not None:
        cfg.network.warp_max_disp = args.warp_max_disp
    apply_serving_network(cfg, args.set_network)

    device = torch.device(args.device)
    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    cfg_name = os.path.splitext(os.path.basename(args.cfg))[0]
    logger, _ = create_logger(cfg.output_path, cfg_name, cfg.dataset.test_image_set)

    dataset = Cityscape if cfg.dataset.dataset.lower().startswith("city") else CamVid
    imdb = dataset(cfg.dataset.test_image_set, cfg.dataset.root_path, cfg.dataset.dataset_path)

    prefix = os.path.join(cfg.output_path, cfg_name, cfg.dataset.image_set,
                          cfg.TRAIN.model_prefix)
    steps = [] if args.random_weights else saved_epochs(prefix)
    if steps:
        requested = int(cfg.TEST.test_epoch) - 1
        # the largest saved epoch <= the one requested
        epoch = max([s for s in steps if s <= requested], default=steps[0])
        if epoch > requested:
            logger.warning(
                f"TEST.test_epoch={cfg.TEST.test_epoch} requested epoch {requested} but the "
                f"earliest saved epoch is {epoch} (saved: {steps}): evaluating epoch {epoch}")
        model.load_state_dict(load_checkpoint(prefix, epoch)["model"])
        logger.info(f"restored {prefix} epoch {epoch}")
    elif not args.random_weights:
        logger.info("no checkpoint found: using random weights")

    propagate = args.propagate or str(cfg.network.propagate)
    prov = load_provenance(prefix) if steps else None
    for msg in check_eval_semantics(prov, propagate, cfg.network, force=args.force):
        logger.warning(f"PROVENANCE: {msg}")
    intervals = ([int(x) for x in args.sweep.split(",")] if args.sweep
                 else [int(cfg.TEST.KEY_FRAME_INTERVAL)])
    results = []
    for interval in intervals:
        cfg.TEST.KEY_FRAME_INTERVAL = interval
        offsets = resolve_key_offsets(interval, args.ann_offsets, args.offsets,
                                      args.offset_sweep, cfg.TEST.KEY_FRAME_OFFSET)
        for key_offset in offsets:
            cfg.TEST.KEY_FRAME_OFFSET = key_offset
            loader = TestClipLoader(imdb, cfg, batch_clips=int(cfg.TEST.BATCH_IMAGES),
                                    max_items=args.max_items)
            batches = PrefetchingIter(iter(loader), transform=lambda b: to_device(b, device))
            miou, iou, stats = pred_eval_clips(
                model, batches, int(cfg.dataset.NUM_CLASSES), interval, propagate, logger,
                upsample=str(cfg.TEST.upsample))
            if len(intervals) == 1 and len(offsets) == 1:
                for n, v in zip(imdb.class_names, iou):
                    logger.info(f"{n:20s} IU {v * 100:6.2f}")
            logger.info(f"interval {interval} offset {loader.ann_pos}: "
                        f"meanIU {miou * 100:.2f}  fps {stats['fps']:.2f}")
            results.append(dict(interval=interval, ann_offset=loader.ann_pos, miou=miou,
                                iou=iou, stats=stats))
    return results


if __name__ == "__main__":
    main()
