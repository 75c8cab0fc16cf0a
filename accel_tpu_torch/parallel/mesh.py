"""The ``data x spatial`` mesh over processes (counterpart of
``accel_tpu/parallel/mesh.py``).

The reference shards a global batch over a ``jax.sharding.Mesh`` with a
``data`` and a ``spatial`` axis; its train step is the unsharded program
(``jit`` semantics), so W chips compute the loss and the gradient of the
whole global batch. Here each rank is a process with one card (or the
CPU), started by ``torchrun`` or by a caller that gives the rendezvous.
The world is ``data x spatial`` ranks: rank r has data index ``r //
spatial`` and spatial index ``r % spatial``, the reference's
``devices.reshape(data, spatial)`` layout. The data axis keeps the
global-batch semantics by hand:

- each rank takes its rows of the global batch (``batch_rows``,
  ``shard_batch``);
- the loss functions divide by global counts, all-reduced
  (``core/metrics.py``, ``core/pipeline.py``), and running-stat BatchNorm
  takes its statistics over the global batch, with their gradient across
  ranks (``models/resnet.py``); each rank's loss is its share of the
  global loss;
- the trainer sums the shares' f32 gradients over the ranks
  (``all_reduce_``) before the optimizer, so every rank applies the same
  update and the master weights stay bit-equal across ranks.

The ``spatial`` axis splits each frame's rows over the ranks of a data
index (``parallel/spatial.py``: halo exchanges within each spatial group,
one ``new_group`` per data index) for clip inference, eval and training.
A training rank then holds some rows of some samples: the objectives
reduce their counts over the world (``loss_group``), and the trainer's
gradient all-reduce over the world sums each rank's partial gradient,
that of its own output rows (the exchanges' backward has already returned
its halo rows' share to their owners).

An int8 model's activation scales are those of the reference's whole
call (``ops/quant.py``): under a mesh of more than one rank each call's
absmax is maxed over the world (``spatial.spatial_sharding`` opens the
group), and the clip pipeline chunks by the global batch
(``batch_layout``).
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

# elements of one all-reduce bucket of f32 gradients (256 MB)
BUCKET_NUMEL = 1 << 26


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the world of ``data x spatial`` ranks: this
    process's ``rank`` and ``local_rank``, its ``device``, the world's
    process group (None for a world of one with no group asked for) and,
    with more than one spatial rank, the group of the ranks that share this
    rank's data index (``spatial_group``)."""
    data: int
    spatial: int
    rank: int
    local_rank: int
    device: torch.device
    group: object | None = None
    spatial_group: object | None = None

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    @property
    def loss_group(self):
        """The group the loss functions reduce their counts over: the world
        wherever it has more than one rank (the data ranks hold other
        samples, the spatial ranks other rows of them); None in a world of
        one, where every path runs as it does with no mesh."""
        return self.group if self.data * self.spatial > 1 else None

    def describe(self) -> str:
        """One line for the log: the ranks, the backend and this rank's device."""
        if self.group is None:
            return f"one process on {self.device}"
        ranks = (f"{self.data} ranks" if self.spatial == 1
                 else f"{self.data} data x {self.spatial} spatial ranks")
        return (f"data parallel: {ranks}, backend {dist.get_backend(self.group)}, "
                f"rank {self.rank} on {self.device}")

    def close(self) -> None:
        """Destroy the process group this mesh made, if any."""
        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group()


def _device(cfg, local_rank: int, local_world: int, device) -> torch.device:
    """The caller's device where it names the CPU or an indexed card; else
    ``cuda:<gpus[local_rank]>`` (the reference's device-by-index rule) where
    ``cfg.gpus`` lists a valid card for every local rank, and otherwise,
    the reference's default, every card: local rank r takes card r, the
    ranks past the last card sharing the cards in turn. So the cfgs'
    default ``gpus: '0'`` puts one process on card 0 and N ranks on N
    cards, and two ranks on a one-card machine share it."""
    if device is not None:
        device = torch.device(device)
        if device.type != "cuda" or device.index is not None:
            return device
    n = torch.cuda.device_count()
    ids = [int(x) for x in str(cfg.get("gpus", "") or "").split(",") if x.strip()]
    if len(ids) < local_world or not all(i < n for i in ids):
        ids = list(range(max(n, 1)))
    return torch.device("cuda", ids[local_rank % len(ids)])


def mesh_from_cfg(cfg, device=None, init_method: str | None = None, rank: int | None = None,
                  world_size: int | None = None) -> Mesh:
    """The mesh of this process, from ``cfg.tpu.mesh`` and the launch.

    The world comes from the caller's ``init_method``/``rank``/``world_size``
    where given, else from ``torchrun``'s ``RANK``/``WORLD_SIZE``/
    ``LOCAL_RANK`` (with ``MASTER_ADDR``/``MASTER_PORT``), else it is one
    process and no group is made. ``tpu.mesh.spatial`` (>= 1) must divide
    the world (``ValueError``, as the reference's ``make_mesh`` asserts),
    and ``tpu.mesh.data`` must be -1 or world / spatial. ``device``: 'cpu'
    for the CPU; otherwise the card of ``_device``. The backend is NCCL
    where each local rank has a card of its own, gloo where ranks share a
    card (NCCL refuses two ranks on one device) or run on the CPU. Every
    rank makes the spatial group of each data index (``new_group``)."""
    m = cfg.tpu.mesh
    spatial = int(m.spatial)
    if spatial < 1:
        raise ValueError(f"tpu.mesh.spatial={spatial} must be >= 1")
    env = os.environ
    if init_method is not None:
        if rank is None or world_size is None:
            raise ValueError("init_method needs rank and world_size")
        local_rank, local_world = rank, world_size
    elif "RANK" in env and "WORLD_SIZE" in env:
        init_method, rank, world_size = "env://", int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    else:
        rank, world_size, local_rank, local_world = 0, 1, 0, 1
    if world_size % spatial:
        raise ValueError(f"tpu.mesh.spatial={spatial} does not divide the world of "
                         f"{world_size} ranks")
    data = world_size // spatial
    if int(m.data) not in (-1, data):
        raise ValueError(f"tpu.mesh.data={m.data} but the world has {world_size} ranks "
                         f"(-1 takes every rank over spatial={spatial})")
    dev = _device(cfg, local_rank, local_world, device)
    if init_method is None:
        return Mesh(data=1, spatial=1, rank=0, local_rank=0, device=dev)
    cards = {_device(cfg, r, local_world, device).index for r in range(local_world)}
    backend = "nccl" if dev.type == "cuda" and len(cards) == local_world else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size)
    spatial_group = None
    if spatial > 1:
        groups = [dist.new_group(list(range(d * spatial, (d + 1) * spatial)))
                  for d in range(data)]
        spatial_group = groups[rank // spatial]
    return Mesh(data=data, spatial=spatial, rank=rank, local_rank=local_rank, device=dev,
                group=dist.group.WORLD, spatial_group=spatial_group)


def batch_rows(mesh: Mesh | None, batch_size: int, clamp: bool = False, logger=None) -> slice:
    """This rank's rows of a global batch of ``batch_size``, by its data
    index (the spatial ranks of one data index take the same rows). The
    batch must divide by the data axis (``ValueError``); with ``clamp``
    (eval) a batch that does not is split over gcd(batch, data) data
    indices with a warning, as the reference's eval clamps its mesh's data
    axis and keeps its spatial axis, and the other ranks get no rows."""
    if mesh is None or mesh.data == 1:
        return slice(0, batch_size)
    ranks, index = mesh.data, mesh.data_index
    if batch_size % ranks:
        if not clamp:
            raise ValueError(f"batch {batch_size} does not divide by the {ranks} ranks")
        ranks = math.gcd(batch_size, mesh.data)
        if mesh.rank == 0:
            (logger or logging.getLogger(__name__)).warning(
                f"TEST.BATCH_IMAGES={batch_size} not divisible by the {mesh.data} ranks; "
                f"splitting each batch over {ranks} (raise BATCH_IMAGES to a multiple of "
                f"{mesh.data} to use every rank)")
        if index >= ranks:
            return slice(0, 0)
    per = batch_size // ranks
    return slice(index * per, (index + 1) * per)


def shard_batch(mesh: Mesh | None, batch: dict, rows: slice | None = None) -> dict:
    """This rank's rows (``rows``, default ``batch_rows``) of every entry of
    ``batch`` that has a leading batch dimension: tensors, arrays and lists
    of the batch's length; other entries as they are."""
    n = next(len(v) for v in batch.values() if hasattr(v, "shape") and len(v.shape))
    rows = batch_rows(mesh, n) if rows is None else rows
    return {k: v[rows] if (hasattr(v, "shape") and len(v.shape) or isinstance(v, list))
            and len(v) == n else v for k, v in batch.items()}


def replicated(mesh: Mesh | None, model: torch.nn.Module, state=None) -> None:
    """Broadcast rank 0's weights and buffers of ``model`` and, where given,
    the ``TrainState``'s master copy and momentum, to every rank, once at
    the start. Each tensor takes rank 0's values by ``copy_``, which bumps
    the version the packed-weight caches key on (a collective writing into
    a parameter would not)."""
    if mesh is None or mesh.group is None:
        return
    tensors = list(model.state_dict().values())
    if state is not None:
        tensors += list(state.master.values()) + list(state.opt_state["trace"].values())
    with torch.no_grad():
        for t in tensors:
            received = t.clone()
            dist.broadcast(received, src=0, group=mesh.group)
            t.copy_(received)


@torch.no_grad()
def all_reduce_(tensors: list[torch.Tensor], group) -> None:
    """Sum each f32 tensor over the ranks of ``group``, in place: the
    tensors packed into flat buckets of at most ``BUCKET_NUMEL`` elements,
    one all-reduce per bucket."""
    bucket: list[torch.Tensor] = []

    def flush():
        flat = torch.cat([t.reshape(-1) for t in bucket])
        dist.all_reduce(flat, group=group)
        for t, part in zip(bucket, flat.split([t.numel() for t in bucket]), strict=True):
            t.copy_(part.view_as(t))
        bucket.clear()

    numel = 0
    for t in tensors:
        if bucket and numel + t.numel() > BUCKET_NUMEL:
            flush()
            numel = 0
        bucket.append(t)
        numel += t.numel()
    if bucket:
        flush()


def gather_ints(mesh: Mesh, values: list[int]) -> list[list[int]]:
    """Every rank's ``values`` (the same length on each), in rank order:
    one all-gather over the world, on the mesh's device (NCCL takes only
    card tensors)."""
    mine = torch.tensor(values, dtype=torch.int64, device=mesh.device)
    parts = [torch.empty_like(mine) for _ in range(mesh.data * mesh.spatial)]
    dist.all_gather(parts, mine, group=mesh.group)
    return [p.tolist() for p in parts]


def batch_layout(mesh: Mesh, sizes: list[int]) -> tuple[int, int, int]:
    """(start, size, total): this rank's samples of a global batch from
    every rank's ``sizes`` in rank order (the spatial ranks of a data index
    hold the same samples; a rank outside a clamped split holds 0)."""
    per_index = [sizes[d * mesh.spatial] for d in range(mesh.data)]
    d = mesh.data_index
    return sum(per_index[:d]), per_index[d], sum(per_index)
