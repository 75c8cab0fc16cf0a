"""Train entry point (counterpart of ``experiments/train.py``).

    python3 -m accel_tpu_torch.experiments.train --cfg experiments/cfgs/accel18_cityscapes.yaml
    python3 -m accel_tpu_torch.experiments.train --cfg <yaml> --device cpu
    torchrun --standalone --nproc_per_node=N -m accel_tpu_torch.experiments.train --cfg <yaml>

Loads the cfg, builds the imdb and the loader of ``TRAIN.objective``
(``TrainClipLoader`` for 'clip', ``TrainPairLoader`` for 'pair'), builds the
model from the cfg (seeded random weights), writes ``provenance.json``
beside the checkpoints before training, resumes from the newest checkpoint
under ``TRAIN.RESUME``, and fits with the warmup-multistep SGD of
``core/trainer.py`` (f32 master weights), saving
``<output_path>/<cfg name>/<image_set>/<model_prefix>/<epoch>.pt`` every
``TRAIN.checkpoint_interval`` epochs and at the last one. The eval entry
point (``accel_tpu_torch.experiments.test``) reads those checkpoints.

It runs on the card (``--device cuda``, the default) and raises where there
is none; ``--device cpu`` runs the plain PyTorch versions of the kernels.
Plain ``python3 -m`` runs one process. Under ``torchrun`` each rank is a
process on its card (``parallel/mesh.py``: NCCL where each rank has a card
of its own, gloo where ranks share one, and on the CPU) of a ``data x
spatial`` mesh (``tpu.mesh.spatial`` ranks split each frame's rows,
``tpu.mesh.data`` -1 or world / spatial): ``TRAIN.BATCH_IMAGES`` stays the
global batch, which must divide by the data axis; each rank trains on the
rows of the batch that a one-process run with the same seed draws for its
data index and, with a spatial axis, on its rows of every frame
(``spatial.frame_rows``; the crop's rows over the spatial ranks must give
shards that divide by the model's row stride, else ``ValueError``). The
weights and master state start from rank 0's, the step sums the gradients
over the ranks, and only rank 0 logs and writes metrics, provenance and
checkpoints. (The reference's entry point replicates the batch over its
spatial axis and lets the partitioner split the rows; both compute the
same global step.) The reference's other ``tpu.*`` keys (prefetch depth,
donation) are read by no part of this entry point. Pretrained
initialisation (``network.pretrained``, ``pretrained_update``,
``pretrained_flow``: MXNet ``.params``, ``.npz`` or torchvision ``.pth``)
merges the files into the seeded weights before training
(``core/pretrained.py``), the master copy taking their f32 values; the
stages ``FIXED_PARAMS`` names stay frozen. ``--set-network K=V`` overrides a
``cfg.network`` field after the cfg is read, as the eval entry point's
flag does (here also for a field the cfg schema lacks, such as
``dilated_conv``). An unknown flag is an error here, where the reference
ignores it.
"""

from __future__ import annotations

import argparse
import contextlib
import os

import torch

from accel_tpu_torch.config import load_config
from accel_tpu_torch.core.checkpoint import (
    latest_epoch,
    load_checkpoint,
    provenance_from_cfg,
    restore_train_state,
    save_checkpoint,
    save_provenance,
    train_checkpoint,
)
from accel_tpu_torch.core.pretrained import apply_pretrained_cfg
from accel_tpu_torch.core.trainer import fit, init_train_state, make_optimizer, make_train_step
from accel_tpu_torch.data.camvid import CamVid
from accel_tpu_torch.data.cityscapes import Cityscape
from accel_tpu_torch.data.loader import TrainClipLoader, TrainPairLoader
from accel_tpu_torch.data.prefetch import PrefetchingIter, to_device
from accel_tpu_torch.experiments.test import apply_network_overrides
from accel_tpu_torch.models.accel import build_model
from accel_tpu_torch.parallel import spatial
from accel_tpu_torch.parallel.mesh import batch_rows, mesh_from_cfg, replicated
from accel_tpu_torch.utils.logger import create_logger
from accel_tpu_torch.utils.metrics_writer import MetricsWriter

PRETRAINED_KEYS = ("pretrained", "pretrained_flow", "pretrained_update")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train Accel/DFF/DeepLab (PyTorch, one GPU)")
    p.add_argument("--cfg", required=True, help="experiment yaml")
    p.add_argument("--frequent", type=int, default=None, help="log every N steps")
    p.add_argument("--set-network", action="append", default=[], metavar="K=V",
                   help="override a cfg.network field, e.g. --set-network dilated_conv=pallas")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the card); 'cpu' runs the kernels' plain "
                        "versions")
    return p.parse_args(argv)


def main(argv=None):
    """Train; returns the final ``TrainState``."""
    args = parse_args(argv)
    cfg = load_config(args.cfg)
    apply_network_overrides(cfg, args.set_network)
    mesh = mesh_from_cfg(cfg, device=args.device)
    try:
        return _train(args, cfg, mesh)
    finally:
        mesh.close()


def _train(args, cfg, mesh):
    device = mesh.device
    main_rank = mesh.rank == 0
    cfg_name = os.path.splitext(os.path.basename(args.cfg))[0]
    logger, out_dir = create_logger(cfg.output_path, cfg_name, cfg.dataset.image_set, mesh.rank)
    logger.info(f"config {args.cfg} device {device}; {mesh.describe()}")

    dataset = Cityscape if cfg.dataset.dataset.lower().startswith("city") else CamVid
    imdb = dataset(cfg.dataset.image_set, cfg.dataset.root_path, cfg.dataset.dataset_path)
    objective = str(cfg.TRAIN.objective)
    rows = batch_rows(mesh, int(cfg.TRAIN.BATCH_IMAGES))
    loader = (TrainClipLoader if objective == "clip" else TrainPairLoader)(imdb, cfg, rows=rows)
    epoch_size = loader.epoch_size

    model = build_model(cfg, device=device, generator=torch.Generator().manual_seed(0))
    if mesh.spatial > 1 and cfg.TRAIN.CROP_SIZE:
        check_split(int(cfg.TRAIN.CROP_SIZE[0]), mesh.spatial, model)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model {cfg.network.name} params {n_params / 1e6:.1f}M "
                f"epoch_size {epoch_size}")
    params = None
    if any(cfg.network.get(k) for k in PRETRAINED_KEYS):
        # merged in f32 on the host; the model takes them rounded to its
        # dtypes, the master copy as they are
        params = {k: v.detach().to("cpu", torch.float32) for k, v in model.state_dict().items()}
        params, _ = apply_pretrained_cfg(cfg, params, logger)
        model.load_state_dict(params)
    tx, _ = make_optimizer(cfg, epoch_size, model)
    state = init_train_state(model, tx, params)

    prefix = os.path.join(out_dir, cfg.TRAIN.model_prefix)
    # the training semantics beside the checkpoints, before fit, so that an
    # interrupted run carries them too; the eval entry point checks them
    if main_rank:
        save_provenance(prefix, provenance_from_cfg(cfg))
    begin_epoch = int(cfg.TRAIN.begin_epoch)
    if cfg.TRAIN.RESUME:
        le = latest_epoch(prefix)
        if le is not None:
            restore_train_state(state, load_checkpoint(prefix, le))
            begin_epoch = le + 1
            logger.info(f"resumed epoch {le}")
    replicated(mesh, model, state)

    ohem = float(cfg.TRAIN.ohem_fraction) or None
    step = make_train_step(tx, int(cfg.dataset.NUM_CLASSES), float(cfg.TRAIN.loss_scale),
                           ohem_fraction=ohem, aux_weight=float(cfg.TRAIN.aux_loss_weight),
                           objective=objective, propagate=str(cfg.network.propagate),
                           remat=bool(cfg.TRAIN.remat), mesh=mesh)
    data_iter = PrefetchingIter(iter(loader),
                                transform=lambda b: to_device(frame_rows(mesh, b), device,
                                                              keys=tuple(b)))
    end_epoch = int(cfg.TRAIN.end_epoch)
    interval = max(int(cfg.TRAIN.checkpoint_interval), 1)

    def on_epoch_end(epoch, s):
        if (epoch + 1) % interval == 0 or epoch == end_epoch - 1:
            save_checkpoint(prefix, epoch, train_checkpoint(s, epoch))

    try:
        with (MetricsWriter(os.path.join(out_dir, "metrics.jsonl")) if main_rank
              else contextlib.nullcontext()) as metrics_writer:
            state = fit(state, step, data_iter, epochs=end_epoch, epoch_size=epoch_size,
                        logger=logger, frequent=args.frequent or int(cfg.default.frequent),
                        epoch_end_callback=on_epoch_end, begin_epoch=begin_epoch,
                        metrics_writer=metrics_writer, mesh=mesh)
    finally:
        data_iter.close()
    logger.info("training done")
    return state


FRAME_KEYS = ("data", "data_ref", "clip", "label")


def check_split(rows: int, ranks: int, model) -> None:
    """``ValueError`` where a crop of ``rows`` rows does not split over
    ``ranks`` spatial ranks into shards that divide by the model's row
    stride."""
    if rows % ranks or (rows // ranks) % model.row_stride:
        raise ValueError(f"TRAIN.CROP_SIZE rows {rows} over tpu.mesh.spatial={ranks} ranks give "
                         f"shards of {rows / ranks:g} rows, which do not divide by the "
                         f"{model.family} model's row stride {model.row_stride}")


def frame_rows(mesh, batch: dict) -> dict:
    """This rank's rows (``spatial.frame_rows``) of every frame and label
    of a loader batch (their rows are dim -2), contiguous; the batch as it
    is without a spatial axis."""
    if mesh.spatial == 1:
        return batch
    rows = spatial.frame_rows(mesh, batch["label"].shape[-2])
    return {k: v[..., rows, :].contiguous() if k in FRAME_KEYS else v for k, v in batch.items()}


if __name__ == "__main__":
    main()
