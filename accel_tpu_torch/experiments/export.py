"""Export entry point: a trained model's serving program as one artifact
(counterpart of ``experiments/export.py``).

    python3 -m accel_tpu_torch.experiments.export --cfg experiments/cfgs/accel18_cityscapes.yaml \\
        --height 1024 --width 2048 --out accel18.pt2

Builds the model from the cfg, restores the newest port checkpoint at or
below ``TEST.test_epoch`` (as the eval entry point does; ``--random-weights``
takes seeded random weights), and writes the group serving program of
``core/export.py`` (``torch.export``, the five kernels as
``torch.ops.accel_tpu_torch`` ops) with the weights embedded, or as an
argument under ``--no-embed-params``. The artifact runs on the device it
was exported on (``--device``, the card by default) and loads with
``accel_tpu_torch.core.export.load_serving``, which needs
``accel_tpu_torch`` importable. The JAX script's ``--platforms``
(cross-lowering) has no counterpart.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

from accel_tpu_torch.config import load_config
from accel_tpu_torch.core.checkpoint import load_checkpoint, saved_epochs
from accel_tpu_torch.core.export import export_serving
from accel_tpu_torch.models.accel import build_model


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Export serving artifact (PyTorch, one GPU)")
    p.add_argument("--cfg", required=True)
    p.add_argument("--out", required=True, help="output artifact path (.pt2)")
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=2048)
    p.add_argument("--interval", type=int, default=None,
                   help="override TEST.KEY_FRAME_INTERVAL")
    p.add_argument("--batch", default="b",
                   help="clip batch: an int for static, or a symbolic dim name (default 'b' = "
                        "batch-polymorphic artifact)")
    p.add_argument("--propagate", default=None, choices=["direct", "incremental"])
    p.add_argument("--no-embed-params", dest="embed_params", action="store_false",
                   help="keep the weights a call argument (small artifact, one program serves "
                        "many checkpoints)")
    p.add_argument("--random-weights", action="store_true",
                   help="skip checkpoint restore (packaging smoke test)")
    p.add_argument("--device", default="cuda",
                   help="torch device the program is traced on and runs on (default: the card)")
    return p.parse_args(argv)


def main(argv=None) -> bytes:
    """Export; returns the artifact's bytes."""
    args = parse_args(argv)
    cfg = load_config(args.cfg)
    cfg_name = os.path.splitext(os.path.basename(args.cfg))[0]
    model = build_model(cfg, device=torch.device(args.device),
                        generator=torch.Generator().manual_seed(0))
    prefix = os.path.join(cfg.output_path, cfg_name, cfg.dataset.image_set,
                          cfg.TRAIN.model_prefix)
    steps = [] if args.random_weights else saved_epochs(prefix)
    if steps:
        requested = int(cfg.TEST.test_epoch) - 1
        epoch = max([s for s in steps if s <= requested], default=steps[0])
        model.load_state_dict(load_checkpoint(prefix, epoch)["model"])
        print(f"restored {prefix} epoch {epoch}")
    elif not args.random_weights:
        print("no checkpoint found — exporting random weights", file=sys.stderr)

    interval = int(args.interval or cfg.TEST.KEY_FRAME_INTERVAL)
    propagate = args.propagate or str(cfg.network.propagate)
    try:
        batch = int(args.batch)
    except ValueError:
        batch = args.batch
    blob = export_serving(model, None, (args.height, args.width), interval,
                          propagate=propagate, batch=batch, upsample=str(cfg.TEST.upsample),
                          embed_params=args.embed_params, path=args.out)
    print(f"wrote {args.out}: {len(blob) / 1e6:.1f} MB, "
          f"clip=({batch},{interval},{args.height},{args.width},3), "
          f"propagate={propagate}, params "
          f"{'embedded' if args.embed_params else 'as argument'}")
    return blob


if __name__ == "__main__":
    main()
