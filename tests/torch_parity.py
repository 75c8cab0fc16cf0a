"""Shared helpers of the PyTorch-port parity tests (``test_torch_*.py``).

Variables for a flax module are made from its abstract init (``eval_shape``:
the tree and shapes without running the initializers) and filled from a
numpy seed, so every norm, bias and head is non-trivial and both packages
get the same numbers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import accel_tpu.ops.warp_onehot as jwo
import accel_tpu_torch.models.accel as taccel
import accel_tpu_torch.ops.warp as twarp
from accel_tpu.models.accel import AccelNet as JAccelNet
from accel_tpu_torch.convert import load_flax_variables
from accel_tpu_torch.models.accel import AccelNet
from accel_tpu_torch.ops import warp_onehot as two

# flow head gain: makes the predicted flow move content by a few feature
# pixels at the tiny test sizes (asserted by the pipeline tests)
FLOW_HEAD_GAIN = 200.0


def _leaf_value(path: tuple[str, ...], shape, rng: np.random.Generator) -> np.ndarray:
    name = path[-1]
    if name == "kernel":
        fan_in = int(np.prod(shape[:-1]))
        a = rng.standard_normal(shape) / np.sqrt(fan_in)
        if path[-2] == "predict_flow2":
            a *= FLOW_HEAD_GAIN
        return a
    if name == "bias":
        b = 0.05 * rng.standard_normal(shape)
        return b + 1.0 if path[-2] == "scale_field" else b
    if name in ("scale", "var"):
        return rng.uniform(0.5, 1.5, shape)
    if name == "mean":
        return 0.1 * rng.standard_normal(shape)
    raise KeyError(f"no test value for leaf {'/'.join(path)}")


def seeded_variables(module, *init_args, seed: int = 0, **init_kwargs) -> dict:
    """Variables of ``module.init(key, *init_args, **init_kwargs)`` with
    every leaf drawn from ``np.random.default_rng(seed)`` (f32 numpy)."""
    abstract = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *init_args, **init_kwargs))
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(abstract)
    leaves = []
    for keypath, leaf in flat:
        path = tuple(k.key for k in keypath)
        leaves.append(np.asarray(_leaf_value(path, leaf.shape, rng), np.float32))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def bridged_models(knobs: dict, hw: int, seed: int):
    """An f32 ``AccelNet`` of each package with ``knobs`` and the same
    seeded weights (made for an ``hw`` x ``hw`` frame): (jax model, its
    variables, torch model on the CPU)."""
    jm = JAccelNet(dtype=jnp.float32, **knobs)
    cur = jnp.zeros((1, hw, hw, 3))
    v = seeded_variables(jm, cur, cur, jnp.ones((1,)), train=False, seed=seed)
    tm = AccelNet(**knobs, device="cpu", dtype=torch.float32)
    load_flax_variables(tm, v)
    return jm, v, tm


@pytest.fixture
def f32_tap_weights(monkeypatch):
    """Both packages' one-hot warps with ``weights_dtype`` f32 (the bf16
    tap weights round near-midpoint values to neighbouring bf16 values on
    the two sides; ``test_torch_dff.py`` explains)."""
    monkeypatch.setattr(jwo, "warp_onehot_fwd",
                        functools.partial(jwo.warp_onehot_fwd, weights_dtype=jnp.float32))
    tw = functools.partial(two.warp_onehot, weights_dtype=torch.float32)
    for module in (taccel, twarp):
        monkeypatch.setattr(module, "warp_onehot", tw)


def nchw(a) -> torch.Tensor:
    """NHWC array -> NCHW f32 torch tensor (any leading dims before H)."""
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.movedim(-1, -3).contiguous()


def nhwc(t: torch.Tensor) -> np.ndarray:
    """NCHW torch tensor -> NHWC numpy."""
    return t.detach().movedim(-3, -1).cpu().numpy()


def assert_close(ours: np.ndarray, ref: np.ndarray, rel: float = 1e-4) -> None:
    """max|ours - ref| <= rel * (1 + max|ref|)."""
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = float(np.abs(ours - ref).max())
    bound = rel * (1.0 + float(np.abs(ref).max()))
    assert err <= bound, f"max|diff| {err:.3g} > {bound:.3g}"


def assert_argmax_agrees(ours: np.ndarray, ref: np.ndarray, logits: np.ndarray,
                         min_agree: float, margin_rel: float = 1e-5) -> None:
    """Class maps agree on at least ``min_agree`` of the pixels, and every
    disagreement sits at a near-tie: top-2 margin of ``logits`` (the
    reference's channels-last full-res logits) <= margin_rel * max|logits|."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    diff = ours != ref
    agree = 1.0 - float(diff.mean())
    assert agree >= min_agree, f"agreement {agree}"
    if diff.any():
        top2 = np.sort(np.asarray(logits), axis=-1)[..., -2:]
        margin = (top2[..., 1] - top2[..., 0])[diff]
        assert float(margin.max()) <= margin_rel * float(np.abs(logits).max())


# ---- data fixtures and checkpoints for the eval parity tests ------------------


def jax_native_ops(mp, build_dir) -> None:
    """Give the JAX package's data path its C++ host ops, as the port's
    runs: ``accel_tpu/native/_accel_native.cpp`` built from its own source
    into ``build_dir`` and set, with the ``MonkeyPatch`` ``mp``, as
    ``accel_tpu.native``'s extension and ``accel_tpu.data.image``'s
    ``native_ops`` (no file of ``accel_tpu`` changes). Without it the JAX
    package runs its numpy fallback where ``init.sh`` has not built the
    extension, whose resize rounds otherwise."""
    from pathlib import Path

    import accel_tpu.native as jnative
    from accel_tpu.data import image as jimage
    from accel_tpu_torch import native

    source = Path(jnative.__file__).with_name("_accel_native.cpp")
    mp.setattr(jnative, "_ext", native.load(source, Path(build_dir)))
    mp.setattr(jimage, "native_ops", jnative._NativeOps)

CITYSCAPES_BANDS = ((23, (180, 130, 70)), (7, (90, 90, 90)), (26, (40, 40, 160)))  # sky, road, car


def write_png(path, arr: np.ndarray, params=()) -> None:
    import os

    import cv2

    os.makedirs(os.path.dirname(str(path)), exist_ok=True)
    assert cv2.imwrite(str(path), arr, list(params))


def write_cityscapes_tree(root, h: int, w: int, snippets: int = 2, seed: int = 0,
                          split: str = "val", cities=("aachen", "bochum")) -> str:
    """A Cityscapes-layout tree as ``tests/test_data.py``'s fixture writes
    it: per city ``snippets`` annotated frames with a labelIds PNG of three
    bands (sky, road, car; an unlabelled corner) and sequence frames
    ANNOTATED_FRAME-6 .. +1, each band its own colour plus noise, panning
    2 px a frame. Returns the dataset path (``root``/cityscapes)."""
    from accel_tpu.data.cityscapes import ANNOTATED_FRAME

    rng = np.random.default_rng(seed)
    data = f"{root}/cityscapes"
    lab = np.zeros((h, w), np.uint8)
    colour = np.zeros((h, w, 3), np.float32)
    for i, (label_id, bgr) in enumerate(CITYSCAPES_BANDS):
        rows = slice(i * h // 3, (i + 1) * h // 3 if i < 2 else h)
        lab[rows] = label_id
        colour[rows] = bgr
    lab[:4, :4] = 0
    for city in cities:
        for seq in range(snippets):
            base = np.clip(colour + rng.normal(0, 30, colour.shape), 0, 255).astype(np.uint8)
            name = f"{city}_{seq:06d}_{ANNOTATED_FRAME:06d}"
            write_png(f"{data}/leftImg8bit/{split}/{city}/{name}_leftImg8bit.png", base)
            write_png(f"{data}/gtFine/{split}/{city}/{name}_gtFine_labelIds.png", lab)
            for f in range(ANNOTATED_FRAME - 6, ANNOTATED_FRAME + 2):
                write_png(f"{data}/leftImg8bit_sequence/{split}/{city}/"
                          f"{city}_{seq:06d}_{f:06d}_leftImg8bit.png",
                          np.roll(base, 2 * (f - ANNOTATED_FRAME), axis=1))
    return data


def write_camvid_tree(root, h: int, w: int, n: int = 3, seed: int = 0,
                      split: str = "test") -> str:
    """A CamVid-layout tree: ``split``/*.png images (RGB) and
    ``split``annot/*.png class-index labels, some >= 11 (ignored). Returns
    the dataset path."""
    rng = np.random.default_rng(seed)
    data = f"{root}/camvid"
    for i in range(n):
        write_png(f"{data}/{split}/seq_{i:03d}.png", rng.integers(0, 255, (h, w, 3), np.uint8))
        write_png(f"{data}/{split}annot/seq_{i:03d}.png", rng.integers(0, 13, (h, w), np.uint8))
    return data


def port_checkpoint_from_jax(variables, prefix_dir: str, epoch: int) -> None:
    """A port checkpoint (``accel_tpu_torch.core.checkpoint``) holding flax
    ``variables``, through ``convert.flax_to_torch``: the route from a JAX
    checkpoint, restored in JAX, to the port."""
    from accel_tpu_torch.convert import flax_to_torch
    from accel_tpu_torch.core.checkpoint import save_checkpoint

    save_checkpoint(prefix_dir, epoch, {"model": flax_to_torch(jax.device_get(variables))})


# ---- ranks of ``torch_dp_worker.py`` -----------------------------------------


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """``world`` processes of ``torch_dp_worker.py`` on ``spec_path``,
    started once for a test module; ``results()`` waits for them (the JAX
    side runs meanwhile) and returns each rank's results."""

    def __init__(self, spec_path, world: int = 2):
        import os
        import subprocess
        import sys
        from pathlib import Path

        self.spec_path, self.world = spec_path, world
        tests = Path(__file__).resolve().parent
        repo = tests.parent
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(repo), os.environ.get("PYTHONPATH", "")]))
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(key, None)
        self.procs = [subprocess.Popen([sys.executable, str(tests / "torch_dp_worker.py"),
                                        str(spec_path), str(r), str(world)], env=env,
                                       cwd=str(repo), stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT)
                      for r in range(world)]
        self._results = None

    def close(self) -> None:
        """Stop a rank still running (a test that failed before waiting)."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    def results(self) -> list[dict]:
        if self._results is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=600)[0].decode(errors="replace"))
            finally:
                self.close()
            failed = [f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
                      for r, (p, log) in enumerate(zip(self.procs, logs)) if p.returncode]
            assert not failed, "\n".join(failed)
            self._results = [torch.load(f"{self.spec_path}.rank{r}", weights_only=False)
                             for r in range(self.world)]
        return self._results
