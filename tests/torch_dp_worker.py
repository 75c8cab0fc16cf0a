"""One rank of ``test_torch_parallel.py``'s data-parallel cases, or of
``test_torch_spatial.py``'s spatial cases (a spec with ``spatial``), on
the CPU.

    python tests/torch_dp_worker.py SPEC RANK WORLD

``SPEC`` is a ``torch.save``d dict the test writes: ``init`` (a ``file://``
rendezvous), ``train`` (cases of train steps: cfg path, the port's
``state_dict``, the global batch, the steps), ``subgroup`` (a train case
rank 0 runs again under a group of one), ``eval`` (a model's
``state_dict``, its cfg path and global clip batches), ``entry`` and
``train_entry`` (argv for the eval and the train entry points under
``torchrun``'s variables, each with a port for their rendezvous), and
``int8`` (an int8 model's knobs and weights, global clip batches and
one-clip eval batches: ``int8_case``). A
spatial spec (``spatial_main``) holds instead a cfg with ``tpu.mesh.spatial``,
models and their clips, an eval and an eval entry point. A spatial
training spec (``spatial_train_main``) holds a cfg with
``tpu.mesh.spatial``, objective cases (a model's knobs, weights, recipe and
global batch), train-step cases, serving cases (a model's knobs, weights
and global clip batches: ``serving_case``) and a train entry point. The
rank writes its results to ``SPEC.rank<RANK>``.
Imports torch and the port only.
"""

from __future__ import annotations

import contextvars
import functools
import hashlib
import os
import sys

import torch
import torch.distributed as dist

from accel_tpu_torch.config import load_config
from accel_tpu_torch.core.pipeline import (clip_logits, clip_loss_and_stats, clip_predictions,
                                           pair_loss_and_stats, running_stats)
from accel_tpu_torch.core.predictor import pred_eval_clips
from accel_tpu_torch.core.trainer import init_train_state, make_optimizer, make_train_step
from accel_tpu_torch.experiments import test as eval_entry
from accel_tpu_torch.experiments import train as train_entry
from accel_tpu_torch.models import accel as accel_module
from accel_tpu_torch.models.accel import AccelNet, build_model
from accel_tpu_torch.ops import quant
from accel_tpu_torch.ops import warp as warp_module
from accel_tpu_torch.ops.warp_onehot import warp_onehot
from accel_tpu_torch.parallel import spatial
from accel_tpu_torch.parallel.mesh import (Mesh, all_reduce_, batch_rows, mesh_from_cfg,
                                           replicated, shard_batch)

torch.set_num_threads(2)


def _model(cfg_path: str, state_dict: dict):
    cfg = load_config(cfg_path)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    model.load_state_dict(state_dict)
    return cfg, model


def rank_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's rows of a global batch: its data index's samples, then
    (with a spatial axis) its rows of every frame, as the train entry point
    cuts them."""
    return train_entry.frame_rows(mesh, shard_batch(mesh, batch))


def train_case(case: dict, mesh: Mesh | None) -> dict:
    """``case['steps']`` train steps on this rank's rows of the global
    batch (all of it without a mesh): the losses, the master weights (rank
    0's alone), the running statistics and whether the masters equal rank
    0's bit for bit."""
    cfg, model = _model(case["cfg"], case["state_dict"])
    tx, _ = make_optimizer(cfg, 2, model)
    state = init_train_state(model, tx)
    replicated(mesh, model, state)
    tr = cfg.TRAIN
    step = make_train_step(tx, 19, ohem_fraction=float(tr.ohem_fraction) or None,
                           aux_weight=float(tr.aux_loss_weight), objective=str(tr.objective),
                           propagate=str(cfg.network.propagate), remat=bool(tr.remat),
                           mesh=mesh)
    batch = case["batch"] if mesh is None else rank_batch(mesh, case["batch"])
    losses = []
    for _ in range(case["steps"]):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    flat = torch.cat([p.reshape(-1) for p in state.master.values()])
    equal = True
    if mesh is not None and mesh.group is not None and mesh.data * mesh.spatial > 1:
        rank0 = flat.clone()
        dist.broadcast(rank0, src=0, group=mesh.group)
        equal = torch.equal(rank0, flat)
    main = mesh is None or mesh.rank == 0
    return {"losses": losses, "master": dict(state.master) if main else None,
            "rows": len(batch["label"]),
            "stats": {k: v.clone() for k, v in running_stats(model).items()},
            "masters_equal_rank0": equal}


def objective_grads(case: dict, mesh: Mesh, fresh: bool = False) -> dict:
    """One forward and backward of ``case``'s objective (its ``recipe``:
    objective, propagate, remat, ohem, aux) on this rank's rows inside
    ``spatial_sharding``, the counts over ``mesh.loss_group``: the loss and
    every parameter's gradient summed over the ranks (the global batch's),
    the running statistics, this rank's rows and its shard's counters after
    the forward and after the backward. ``fresh``: the backward runs in a
    fresh ``contextvars.Context()``, where the caller's shard is not set."""
    model = spatial_model(case)
    r = case["recipe"]
    batch = rank_batch(mesh, case["batch"])
    kw = dict(ohem_fraction=r["ohem"] or None, aux_weight=r["aux"], group=mesh.loss_group)
    with spatial.spatial_sharding(mesh, model) as shard:
        if r["objective"] == "clip":
            loss, _ = clip_loss_and_stats(model, batch, 19, propagate=r["propagate"],
                                          remat=r["remat"], **kw)
        else:
            loss, _ = pair_loss_and_stats(model, batch, 19, mutable_stats=model.norm == "batchnorm",
                                          **kw)
        forward = shard.counters()
        if fresh:
            contextvars.Context().run(loss.backward)
        else:
            loss.backward()
        counters = shard.counters()
    grads = {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for n, p in model.named_parameters()}
    total = loss.detach().reshape(1)
    all_reduce_([*grads.values(), total], mesh.group)
    return {"loss": float(total), "grads": grads, "rows": list(batch["label"].shape),
            "stats": {k: v.clone() for k, v in running_stats(model).items()},
            "forward_counters": forward, "counters": counters}


def digest(tensors: dict) -> str:
    """A SHA-256 of the tensors' bytes, in key order: equal digests, equal
    tensors bit for bit."""
    h = hashlib.sha256()
    for key in sorted(tensors):
        h.update(key.encode())
        h.update(tensors[key].detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def spatial_train_main(spec: dict, spec_path: str, rank: int, world: int) -> None:
    """Each objective case (``objective_grads``; the ``fresh`` one again
    with its backward in a fresh context, held against the first bit for
    bit here), each train-step case (``train_case``) and each serving case
    (``serving_case``) on the spec's ``data x spatial`` mesh, then the train
    entry point under ``torchrun``'s variables. Rank 0 alone returns gradients and masters (the same on
    every rank: the ranks return their digests)."""
    out = {}
    mesh = mesh_from_cfg(load_config(spec["cfg"]), device="cpu", init_method=spec["init"],
                         rank=rank, world_size=world)
    try:
        out["mesh"] = (mesh.data, mesh.spatial, mesh.data_index, mesh.spatial_index)
        out["backend"] = dist.get_backend(mesh.spatial_group)
        for name, case in spec.get("objectives", {}).items():
            out[name] = objective_grads(case, mesh)
        if "fresh" in spec:
            fresh = objective_grads(spec["objectives"][spec["fresh"]], mesh, fresh=True)
            normal = out[spec["fresh"]]
            out["fresh"] = dict(fresh, grads=None, loss_equal=fresh["loss"] == normal["loss"],
                                grads_equal=all(torch.equal(g, normal["grads"][n])
                                                for n, g in fresh["grads"].items()))
        for name in spec.get("objectives", {}):
            out[name]["grads_digest"] = digest(out[name]["grads"])
            if rank:
                out[name]["grads"] = None
        for name, case in spec.get("steps", {}).items():
            out[name] = train_case(case, mesh)
        for name, case in spec.get("serving", {}).items():
            out[name] = serving_case(case, mesh)
    finally:
        mesh.close()
    if "train_entry" in spec:
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                          LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                          MASTER_PORT=str(spec["train_entry"]["port"]))
        state = train_entry.main(spec["train_entry"]["argv"])
        out["train_entry"] = {"step": state.step, "master_digest": digest(state.master)}
    torch.save(out, f"{spec_path}.rank{rank}")


def serving_case(case: dict, mesh: Mesh) -> dict:
    """``pred_eval_clips`` of a model on this rank's part of each global
    clip batch of ``case['batches']``: its data index's clips (a batch that
    does not divide over the data axis clamped as the eval entry point
    clamps it) and its rows of their frames. Every int8 call's scale, the
    class maps ``on_preds`` sees (whole frames), the confusion and how
    many batches this rank held."""
    model = spatial_model(case)
    items = []
    for batch in case["batches"]:
        rows = batch_rows(mesh, len(batch["clip"]), clamp=True)
        if rows.stop > rows.start:
            item = shard_batch(mesh, batch, rows)
            frame = spatial.frame_rows(mesh, item["clip"].shape[2])
            items.append(dict(item, clip=item["clip"][:, :, frame]))
    maps = []
    with quant.scales_recorded() as scales:
        miou, _, stats = pred_eval_clips(model, items, 19, case["interval"], case["propagate"],
                                         mesh=mesh, on_preds=lambda _, preds: maps.append(preds))
    return {"scales": scales, "maps": maps, "miou": miou, "confusion": stats["confusion"],
            "batches": len(items)}


def spatial_model(case: dict) -> AccelNet:
    """The f32 ``AccelNet`` of a spatial case (its knobs and weights)."""
    model = AccelNet(**case["knobs"], device="cpu", dtype=torch.float32)
    model.load_state_dict(case["state_dict"])
    return model.eval()


def f32_tap_weights() -> None:
    """The one-hot warp with f32 tap weights in this process (as
    ``torch_parity.f32_tap_weights`` sets it)."""
    warp = functools.partial(warp_onehot, weights_dtype=torch.float32)
    accel_module.warp_onehot = warp_module.warp_onehot = warp


def spatial_main(spec: dict, spec_path: str, rank: int, world: int) -> None:
    """Each model case's ``clip_logits`` and ``clip_predictions`` on this
    rank's rows, ``pred_eval_clips`` under the spatial mesh, then the eval
    entry point under ``torchrun``'s variables."""
    out = {}
    if spec["f32_taps"]:
        f32_tap_weights()
    mesh = mesh_from_cfg(load_config(spec["cfg"]), device="cpu", init_method=spec["init"],
                         rank=rank, world_size=world)
    try:
        assert (mesh.data, mesh.spatial, mesh.spatial_index) == (1, world, rank)
        out["backend"] = dist.get_backend(mesh.spatial_group)
        for name, case in spec["models"].items():
            model = spatial_model(case)
            clip = case["clip"]
            rows = spatial.frame_rows(mesh, clip.shape[2])
            with spatial.spatial_sharding(mesh, model) as shard:
                logits = clip_logits(model, clip[:, :, rows].movedim(-1, -3).contiguous(),
                                     case["interval"], case["propagate"])
                with quant.scales_recorded() as scales:
                    preds = clip_predictions(model, clip[:, :, rows], case["interval"],
                                             case["propagate"])
            out[name] = {"logits": logits, "preds": preds, "halo": shard.counters(),
                         "scales": scales}
        ev = spec["eval"]
        model = spatial_model(spec["models"][ev["model"]])
        # each rank's rows of the frames, as the eval entry point cuts them
        rows = spatial.frame_rows(mesh, ev["items"][0]["clip"].shape[2])
        items = [dict(item, clip=item["clip"][:, :, rows]) for item in ev["items"]]
        miou, iou, stats = pred_eval_clips(model, items, 19, ev["interval"], ev["propagate"],
                                           mesh=mesh)
        out["eval"] = {"miou": miou, "iou": iou, "stats": stats}
    finally:
        mesh.close()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(spec["entry"]["port"]))
    (out["entry"],) = eval_entry.main(spec["entry"]["argv"])
    torch.save(out, f"{spec_path}.rank{rank}")


def int8_case(case: dict, mesh: Mesh) -> dict:
    """An int8 model on the data axis: ``clip_logits`` of each global clip
    batch on this rank's rows under the world's scale group (the
    reference's call: the global batch), with every int8 call's scale;
    then ``pred_eval_clips`` of one-clip batches split over the ranks as
    the eval entry point clamps ``TEST.BATCH_IMAGES: 1`` (rank 1 gets no
    rows, so no batches)."""
    model = spatial_model(case)
    out = {}
    for name, clip in case["clips"].items():
        rows = batch_rows(mesh, len(clip))
        with spatial.spatial_sharding(mesh, model):
            world = quant.active().within(rows.start, rows.stop - rows.start, len(clip))
            with quant.sharing(world), quant.scales_recorded() as scales:
                logits = clip_logits(model, clip[rows].movedim(-1, -3).contiguous(),
                                     case["interval"], case["propagate"])
        out[name] = {"logits": logits, "scales": scales}
    rows = batch_rows(mesh, 1, clamp=True)
    items = [shard_batch(mesh, item, rows) for item in case["items"]] if rows.stop else []
    miou, _, stats = pred_eval_clips(model, items, 19, case["interval"], case["propagate"],
                                     mesh=mesh)
    out["clamped_eval"] = {"miou": miou, "stats": stats, "rows": rows.stop - rows.start}
    return out


def main(spec_path: str, rank: int, world: int) -> None:
    spec = torch.load(spec_path, weights_only=False)
    if "spatial_train" in spec:
        return spatial_train_main(spec, spec_path, rank, world)
    if "spatial" in spec:
        return spatial_main(spec, spec_path, rank, world)
    out = {}
    first = spec["train"][0]["cfg"]
    mesh = mesh_from_cfg(load_config(first), device="cpu", init_method=spec["init"], rank=rank,
                         world_size=world)
    try:
        assert mesh.data == world and mesh.rank == rank and mesh.device.type == "cpu"
        out["backend"] = dist.get_backend(mesh.group)
        for case in spec["train"]:
            out[case["name"]] = train_case(case, mesh)
        # a group of one: the step through the all-reduce, and without a group
        sub = dist.new_group([0])
        if rank == 0:
            case = spec["subgroup"]
            one = Mesh(data=1, spatial=1, rank=0, local_rank=0, device=mesh.device, group=sub)
            out["subgroup"] = {"group": train_case(case, one), "none": train_case(case, None)}
        ev = spec["eval"]
        cfg, model = _model(ev["cfg"], ev["state_dict"])
        rows = batch_rows(mesh, len(ev["items"][0]["clip"]))
        miou, iou, stats = pred_eval_clips(
            model, [shard_batch(mesh, item, rows) for item in ev["items"]], 19,
            int(cfg.TEST.KEY_FRAME_INTERVAL), "direct", mesh=mesh)
        out["eval"] = {"miou": miou, "iou": iou, "stats": stats}
        if "int8" in spec:
            out["int8"] = int8_case(spec["int8"], mesh)
    finally:
        mesh.close()
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost")
    os.environ["MASTER_PORT"] = str(spec["entry"]["port"])
    (out["entry"],) = eval_entry.main(spec["entry"]["argv"])
    os.environ["MASTER_PORT"] = str(spec["train_entry"]["port"])
    state = train_entry.main(spec["train_entry"]["argv"])
    out["train_entry"] = {"step": state.step, "master": dict(state.master)}
    torch.save(out, f"{spec_path}.rank{rank}")


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
