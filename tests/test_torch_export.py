"""The port's serving export (``accel_tpu_torch/core/export.py``) on a tiny
accel model (R18/R18, 128x128, head 32, f32, live flow heads), bridged
from ``accel_tpu``: a batch-polymorphic artifact with the weights embedded
is saved, loaded and run at B=2 and at B=1, and its class maps equal the
port's ``clip_predictions`` exactly (as ``tests/test_export.py`` holds the
JAX artifact); against the JAX package's ``make_serving_fn`` on the same
weights they agree on >= 0.999 of the pixels, every disagreement at a
near-tie. The weights as an argument give the same maps; a file without the
magic is refused. On the CPU the traced program's kernels are the ops'
plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_argmax_agrees, bridged_models

from accel_tpu.core.export import make_serving_fn as j_make_serving_fn
from accel_tpu.core.pipeline import clip_logits as j_clip_logits
from accel_tpu.ops.upsample import resize_bilinear as j_resize
from accel_tpu_torch.core import pipeline as tpipe
from accel_tpu_torch.core.export import MAGIC, export_serving, load_serving, make_serving_fn

torch.set_num_threads(2)
K = 2
TINY = dict(family="accel", ref_depth=18, update_depth=18, head_channels=32)


@pytest.fixture(scope="module")
def tiny():
    jm, v, tm = bridged_models(TINY, 128, seed=81)
    frames = (np.random.default_rng(82).standard_normal((2, K, 128, 128, 3)) * 0.5
              ).astype(np.float32)
    return jm, v, tm, frames


@pytest.fixture(scope="module")
def artifact(tiny, tmp_path_factory):
    _, _, tm, _ = tiny
    path = str(tmp_path_factory.mktemp("export") / "accel.pt2")
    blob = export_serving(tm, None, (128, 128), K, propagate="direct", batch="b", path=path)
    return path, blob


def test_export_embed_params_symbolic_batch(tiny, artifact):
    _, _, tm, frames = tiny
    path, blob = artifact
    assert blob.startswith(MAGIC) and blob[:8] == b"ACCELTPU"
    serve = load_serving(path)
    ops = {str(n.target) for n in serve.exported.graph.nodes if n.op == "call_function"}
    assert {"accel_tpu_torch.warp.default", "accel_tpu_torch.upsample_argmax.default"} <= ops
    clip = torch.from_numpy(frames)
    want = tpipe.clip_predictions(tm, clip, K, "direct")
    got = serve(clip)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    with torch.no_grad():
        assert torch.equal(make_serving_fn(tm, K, "direct")(clip), want)
    # batch-polymorphic: the same artifact at another batch
    assert torch.equal(serve(clip[:1]), want[:1])


def test_export_matches_jax_serving_fn(tiny, artifact):
    jm, v, _, frames = tiny
    got = load_serving(artifact[1])(torch.from_numpy(frames)).numpy()
    want = np.asarray(j_make_serving_fn(jm, K, "direct")(v, jnp.asarray(frames)))
    logits = np.asarray(j_clip_logits(jm, v, jnp.asarray(frames), K, "direct"))
    full = np.stack([np.asarray(j_resize(jnp.asarray(b), (128, 128))) for b in logits])
    assert_argmax_agrees(got, want, full, min_agree=0.999)


def test_export_params_as_argument(tiny):
    _, _, tm, frames = tiny
    blob = export_serving(tm, None, (128, 128), K, batch=2, embed_params=False)
    assert len(blob) < 5e6  # the weights are not in the artifact
    serve = load_serving(blob)
    clip = torch.from_numpy(frames)
    assert torch.equal(serve(tm.state_dict(), clip), tpipe.clip_predictions(tm, clip, K, "direct"))


def test_load_rejects_garbage(tmp_path):
    p = tmp_path / "junk.bin"
    p.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="magic"):
        load_serving(str(p))
