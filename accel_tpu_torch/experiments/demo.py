"""Demo: run the pipeline on a directory of frames and write colorized class
maps (counterpart of ``experiments/demo.py``).

    python3 -m accel_tpu_torch.experiments.demo --cfg experiments/cfgs/accel18_cityscapes.yaml \\
        --frames demo/frames --out demo/output [--synthetic] [--device cpu]

The frames (``*.png`` then ``*.jpg``, sorted) are one clip, cut to a
multiple of ``TEST.KEY_FRAME_INTERVAL``; with ``--synthetic`` and no
frames, 2k panning frames of noise are written first. The model is built
from the cfg with seeded random weights (the JAX script's ``host_init``),
the clip runs through ``clip_predictions`` at the cfg's ``propagate``, and
each frame's map is written beside its name as ``<name>_seg.<ext>`` in the
Cityscapes palette (BGR, as ``cv2`` writes). It runs on the card unless
given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from accel_tpu_torch.config import load_config
from accel_tpu_torch.core.pipeline import clip_predictions
from accel_tpu_torch.data.image import transform
from accel_tpu_torch.models.accel import build_model

# the Cityscapes 19-class palette, trainId -> BGR (for cv2.imwrite)
CITYSCAPES_PALETTE = np.array(
    [
        [128, 64, 128], [244, 35, 232], [70, 70, 70], [102, 102, 156],
        [190, 153, 153], [153, 153, 153], [250, 170, 30], [220, 220, 0],
        [107, 142, 35], [152, 251, 152], [70, 130, 180], [220, 20, 60],
        [255, 0, 0], [0, 0, 142], [0, 0, 70], [0, 60, 100],
        [0, 80, 100], [0, 0, 230], [119, 11, 32],
    ],
    np.uint8,
)[:, ::-1]


def colorize(pred: np.ndarray) -> np.ndarray:
    """(H, W) class indices -> (H, W, 3) BGR; indices past the palette are black."""
    pal = np.vstack([CITYSCAPES_PALETTE,
                     np.zeros((256 - len(CITYSCAPES_PALETTE), 3), np.uint8)])
    return pal[pred]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Colorized class maps of a clip (PyTorch)")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--frames", default="demo/frames")
    ap.add_argument("--out", default="demo/output")
    ap.add_argument("--synthetic", action="store_true",
                    help="generate synthetic frames if --frames is empty")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card); 'cpu' runs the kernels' plain "
                         "versions")
    return ap.parse_args(argv)


def main(argv=None) -> list[str]:
    """Write the maps; returns their paths."""
    args = parse_args(argv)
    import cv2

    cfg = load_config(args.cfg)
    k = int(cfg.TEST.KEY_FRAME_INTERVAL)
    paths = (sorted(glob.glob(os.path.join(args.frames, "*.png")))
             + sorted(glob.glob(os.path.join(args.frames, "*.jpg"))))
    if not paths and args.synthetic:
        os.makedirs(args.frames, exist_ok=True)
        base = np.random.default_rng(0).integers(0, 255, (256, 512, 3), np.uint8)
        for i in range(2 * k):
            p = os.path.join(args.frames, f"frame_{i:04d}.png")
            cv2.imwrite(p, np.roll(base, shift=4 * i, axis=1))
            paths.append(p)
    if not paths:
        raise FileNotFoundError(f"no frames in {args.frames}")

    frames = [cv2.imread(p, cv2.IMREAD_COLOR) for p in paths]
    n_use = (len(frames) // k) * k
    paths, frames = paths[:n_use], frames[:n_use]
    means, stds = cfg.network.PIXEL_MEANS, cfg.network.PIXEL_STDS
    clip = np.stack([transform(f, means, stds)[0] for f in frames])[None]

    device = torch.device(args.device)
    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    preds = clip_predictions(model, torch.from_numpy(clip).to(device), k,
                             str(cfg.network.propagate))[0].cpu().numpy()

    os.makedirs(args.out, exist_ok=True)
    written = []
    for p, pred in zip(paths, preds):
        out_path = os.path.join(args.out, os.path.basename(p).replace(".", "_seg."))
        cv2.imwrite(out_path, colorize(pred))
        written.append(out_path)
    print(f"wrote {len(preds)} colorized maps to {args.out}")
    return written


if __name__ == "__main__":
    main()
