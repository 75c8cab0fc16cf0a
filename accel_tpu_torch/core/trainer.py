"""Training: the optimizer, the train step and the fit loop (counterpart of
``accel_tpu/core/trainer.py``).

The JAX package keeps f32 parameters and casts them to the compute dtype
at every apply; optax updates the f32 copy. The port's model holds its
conv weights in the compute dtype (bf16 for the shipped cfgs), so the
trainer keeps an f32 **master** copy of every parameter beside the model,
applies the SGD update to it, and writes it, rounded, into the model after
each step with ``copy_`` under ``torch.no_grad()``. That copy bumps each
parameter's version, which the kernels' packed-weight caches key on
(``models/resnet.py::PackedWeight``); a write through ``param.data`` would
not, and the kernels would run on the weights of the first step.

The update follows optax's chain in ``make_optimizer`` (``:52-75``):
global-norm clipping over all gradients (``TRAIN.grad_clip`` > 0), decoupled
weight decay added to the gradient, momentum (a trace started at zero),
times -lr of the step's count (step 0 takes ``schedule(0)``), and a zero
update for the parameters that ``FIXED_PARAMS`` names (their trace still
accumulates, as under ``optax.masked``).

Data parallelism (``mesh``, ``parallel/mesh.py``): each rank's step takes
its rows of the global batch, computes its share of the global loss (the
objectives divide by global counts), and sums the shares' f32 gradients
over the ranks in a few flat all-reduces before the update, so clipping
sees the global gradient and every rank applies the same update. This is
the reference's ``jit`` program over a mesh: the one-process loss and
gradient of the whole global batch. With a spatial axis each rank holds
its rows of its samples' frames (``parallel/spatial.py``): the step runs
its forward and its backward inside ``spatial_sharding``, each rank's
gradient is the partial sum over its own output rows (the halo rows'
share returned to their owners by the exchanges' backward), and the same
all-reduce over the world sums them. PyTorch's ``DistributedDataParallel``
is not used: it averages the per-rank ``.grad`` (bf16 on the shipped cfgs)
of per-rank means, and the step already owns the f32 gradients.
"""

from __future__ import annotations

import time
from collections.abc import Callable, Iterable
from dataclasses import dataclass

import torch
from torch import nn

from accel_tpu_torch.core.lr_schedule import lr_steps_from_epochs, warmup_multifactor_schedule
from accel_tpu_torch.core.pipeline import clip_loss_and_stats, pair_loss_and_stats
from accel_tpu_torch.ops import quant
from accel_tpu_torch.parallel import spatial
from accel_tpu_torch.parallel.mesh import all_reduce_


def flax_param_paths(model: nn.Module) -> dict[str, str]:
    """Each parameter's name -> its flax path as ``jax.tree_util.keystr``
    prints it (``"['ref_net']['backbone']['conv1']['kernel']"``), the
    string ``FIXED_PARAMS`` substrings are matched against: a conv's
    ``weight`` is flax's ``kernel``, a norm's ``scale``."""
    out = {}
    for mod_name, mod in model.named_modules():
        for name, _ in mod.named_parameters(recurse=False):
            leaf = name
            if name == "weight":
                leaf = "kernel" if isinstance(mod, nn.Conv2d) else "scale"
            parts = (mod_name.split(".") if mod_name else []) + [leaf]
            out[f"{mod_name}.{name}" if mod_name else name] = "".join(f"['{p}']" for p in parts)
    return out


class SGD:
    """optax's ``chain([clip_by_global_norm], add_decayed_weights, sgd)``
    [+ ``masked(set_to_zero)``] on a dict of f32 tensors, updated in place.
    Its state is a dict: ``count`` (steps taken) and ``trace`` (momentum
    per parameter)."""

    def __init__(self, schedule: Callable[[int], float], momentum: float, weight_decay: float,
                 grad_clip: float = 0.0, frozen: frozenset[str] = frozenset()):
        self.schedule, self.momentum, self.weight_decay = schedule, momentum, weight_decay
        self.grad_clip, self.frozen = grad_clip, frozen

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        return {"count": 0, "trace": {n: torch.zeros_like(p) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: dict,
               params: dict[str, torch.Tensor]) -> None:
        """One step on ``params`` from ``grads`` (both f32, same keys)."""
        if self.grad_clip > 0:
            g_norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            if not bool(g_norm < self.grad_clip):
                grads = {n: (g / g_norm) * self.grad_clip for n, g in grads.items()}
        # an f32 value: a tensor times it multiplies by it in f32, as optax does
        step_size = -self.schedule(state["count"])
        for n, p in params.items():
            t = state["trace"][n]
            t.mul_(self.momentum).add_(grads[n] + self.weight_decay * p)
            if n not in self.frozen:
                p.add_(t * step_size)
        state["count"] += 1


def make_optimizer(cfg, epoch_size: int, model: nn.Module,
                   fixed_prefixes=None) -> tuple[SGD, Callable[[int], float]]:
    """SGD with momentum, weight decay and the warmup-multistep schedule
    from ``cfg.TRAIN``. ``fixed_prefixes`` (default ``network.FIXED_PARAMS``):
    substrings of flax parameter paths (``flax_param_paths``) whose
    parameters get no update."""
    tr = cfg.TRAIN
    schedule = warmup_multifactor_schedule(
        base_lr=float(tr.lr), steps=lr_steps_from_epochs(tr.lr_step, epoch_size, tr.begin_epoch),
        factor=float(tr.lr_factor), warmup=bool(tr.warmup), warmup_lr=float(tr.warmup_lr),
        warmup_steps=int(tr.warmup_step))
    fixed = fixed_prefixes
    if fixed is None:
        fixed = list(cfg.network.FIXED_PARAMS or []) if "network" in cfg else []
    frozen = frozenset(n for n, path in flax_param_paths(model).items()
                       if any(p in path for p in fixed))
    return SGD(schedule, float(tr.momentum), float(tr.wd), float(tr.get("grad_clip", 0) or 0),
               frozen), schedule


@dataclass
class TrainState:
    """The model (weights in its compute dtype), the f32 master copy of its
    parameters, the optimizer state and the number of steps taken."""
    step: int
    model: nn.Module
    master: dict[str, torch.Tensor]
    opt_state: dict


def init_train_state(model: nn.Module, tx: SGD, params=None) -> TrainState:
    """The train state of ``model``: the master copy from ``params`` (f32
    values by parameter name, such as pretrained weights) where given,
    else from the model's own parameters."""
    params = params or {}
    master = {n: (params[n] if n in params else p.detach()).to(
        device=p.device, dtype=torch.float32, copy=True) for n, p in model.named_parameters()}
    return TrainState(step=0, model=model, master=master, opt_state=tx.init(master))


@torch.no_grad()
def write_master(state: TrainState) -> None:
    """The master weights into the model, rounded to each parameter's dtype,
    by ``copy_`` (which bumps the versions the packed-weight caches key on)."""
    for n, p in state.model.named_parameters():
        p.copy_(state.master[n])


def _global_batch(mesh, batch: dict) -> quant.ScaleGroup | None:
    """The running int8 scale group (``spatial_sharding``'s) for this
    rank's samples of the global batch (every data index holds as many),
    or None."""
    scales = quant.active()
    if mesh is None or scales is None:
        return None
    n = len(batch["label"])
    return scales.within(mesh.data_index * n, n, mesh.data * n)


def make_train_step(tx: SGD, num_classes: int, loss_scale: float = 1.0,
                    mutable_stats: bool | None = None, ohem_fraction: float | None = None,
                    aux_weight: float = 0.0, objective: str = "pair",
                    propagate: str = "incremental", remat: bool = False, mesh=None):
    """The train step ``step(state, batch) -> (state, {'loss': loss})``:
    forward, loss, backward, the SGD update of the master weights, then the
    master weights into the model. ``objective``: 'pair' (batch 'data',
    'data_ref', 'eq_flag', 'label') or 'clip' (batch 'clip', 'label';
    ``propagate`` and ``remat`` as ``clip_loss_and_stats`` takes them).
    ``mutable_stats`` (None: the model's ``norm`` is 'batchnorm') carries
    the BatchNorm running statistics from step to step; they live in the
    model's buffers, so checkpoints (``state_dict``) hold them.

    ``mesh`` (``parallel.mesh.Mesh``): the batch is this rank's rows of the
    global batch (with a spatial axis, also its rows of every frame,
    ``spatial.frame_rows``); the gradients (and the loss returned, the
    global batch's) are summed over the mesh's group before the update. A
    mesh of one rank with a group runs the one-process step and the
    all-reduce. An int8 model takes each call's activation scales over the
    world (``spatial_sharding`` opens the group), as the reference's
    ``jit`` over the global batch does (``ops/quant.py``; int8 is a
    serving knob, trained only as far as one process trains it)."""
    if objective not in ("pair", "clip"):
        raise ValueError(f"unknown objective {objective!r} (pair | clip)")
    group = mesh.loss_group if mesh is not None else None
    reduce_group = mesh.group if mesh is not None else None

    def step(state: TrainState, batch: dict):
        model = state.model
        stats = (getattr(model, "norm", "frozenbn") == "batchnorm" if mutable_stats is None
                 else mutable_stats)
        model.zero_grad(set_to_none=True)
        # open across the backward: its exchanges and remat's recompute need the shard
        with spatial.spatial_sharding(mesh, model), quant.sharing(_global_batch(mesh, batch)):
            if objective == "clip":
                loss, _ = clip_loss_and_stats(model, batch, num_classes, loss_scale, propagate,
                                              stats, ohem_fraction, aux_weight, remat, group)
            else:
                loss, _ = pair_loss_and_stats(model, batch, num_classes, loss_scale, stats,
                                              ohem_fraction, aux_weight, group)
            loss.backward()
        # a parameter the loss does not reach has a zero gradient, as in JAX
        grads = {n: torch.zeros_like(state.master[n]) if p.grad is None
                 else p.grad.to(torch.float32) for n, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        loss = loss.detach().float().reshape(1)
        if reduce_group is not None:
            all_reduce_([*grads.values(), loss], reduce_group)
        tx.update(grads, state.opt_state, state.master)
        write_master(state)
        state.step += 1
        return state, {"loss": loss[0]}

    return step


def _synchronize(model: nn.Module) -> None:
    device = next(model.parameters()).device
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit(state: TrainState, train_step, data_iter: Iterable, epochs: int, epoch_size: int,
        logger=None, frequent: int = 20,
        epoch_end_callback: Callable[[int, TrainState], None] | None = None,
        begin_epoch: int = 0, metrics_writer=None, mesh=None) -> TrainState:
    """The reference-shaped fit loop: ``epoch_size`` steps per epoch, a
    Speedometer line (and a metrics row) every ``frequent`` steps and at the
    epoch's end, ``epoch_end_callback(epoch, state)`` after each epoch. On
    the card, the clock is read after a synchronize. Under a ``mesh`` the
    loss is the global batch's (the step's) and the speed counts the
    global batch; only rank 0 logs, writes metrics and calls
    ``epoch_end_callback`` (which writes the checkpoints)."""
    log = logger.info if logger else print
    main = mesh is None or mesh.rank == 0
    ranks = 1 if mesh is None else mesh.data
    for epoch in range(begin_epoch, epochs):
        _synchronize(state.model)
        t0 = time.time()
        n_since = 0
        for i, batch in zip(range(epoch_size), data_iter):
            state, metrics = train_step(state, batch)
            n_since += 1
            if main and ((i + 1) % frequent == 0 or (i + 1) == epoch_size):
                loss = float(metrics["loss"])
                _synchronize(state.model)
                dt = time.time() - t0
                bsz = (batch["data"] if "data" in batch else batch["clip"]).shape[0] * ranks
                log(f"Epoch[{epoch}] Batch [{i + 1}/{epoch_size}]\t"
                    f"Speed: {n_since * bsz / dt:.2f} samples/sec\tFCNLogLoss={loss:.5f}")
                if metrics_writer is not None:
                    metrics_writer.write(state.step, loss=loss,
                                         samples_per_sec=n_since * bsz / dt, epoch=epoch)
                t0 = time.time()
                n_since = 0
        if main and epoch_end_callback is not None:
            epoch_end_callback(epoch, state)
    return state
