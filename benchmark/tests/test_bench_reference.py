"""The plain reference against the program's plain CPU path, at a tiny
size, both configurations: the same seeded weights in both, f32 compute,
the group's logits at feature stride."""

import pytest
import torch
from conftest import tiny_config

from benchmark import frames, spec, weights
from benchmark.harness import Run, build_program


def _models(name: str, seed: int = 5):
    cell = spec.load_cell(name)
    config = tiny_config(cell.config)
    config["network"]["dtype"] = "float32"
    cell.config = config
    run = Run(cell, seed, "cpu")
    state = weights.draw(spec.reference_model(config, torch.float32, "meta"), seed, "cpu")
    ref = spec.reference_model(config, torch.float32, "cpu")
    ref.load_state_dict(state)
    clip = frames.panning_clip(config["key_interval"], tuple(config["frame_hw"]), 3, "cpu")
    with torch.no_grad():
        weights.calibrate_flow(state, ref, frames.nchw(clip[0, :2]))
    ref.load_state_dict(state)
    return config, ref, build_program(run, state, config["network"]), clip


@pytest.mark.parametrize("name", ["accel18-offline", "dff-offline"])
def test_reference_matches_the_program_on_the_cpu(name):
    from accel_tpu_torch.core.pipeline import clip_logits

    config, ref, program, clip = _models(name)
    with torch.inference_mode():
        want = ref.group_logits(frames.nchw(clip[0]), config["propagate"])
        got = clip_logits(program, clip.permute(0, 1, 4, 2, 3), config["key_interval"],
                          config["propagate"])[0]
    scale = want.abs().max().item()
    # DFF's feature warp rounds its tap weights and features to bf16 in the
    # program (the TPU kernel's numerics), the reference does not
    tol = 2e-2 if config["network"]["warp_gather"] == "onehot" else 1e-4
    assert got.shape == want.shape
    assert (got - want).abs().max().item() <= tol * scale


@pytest.mark.parametrize("name", ["accel18-offline", "dff-offline"])
def test_flow_moves_content(name):
    config, ref, _, clip = _models(name)
    with torch.no_grad():
        flow, _ = ref.flow(frames.nchw(clip[0, 1:2]), frames.nchw(clip[0, :1]))
    assert flow.abs().max().item() == pytest.approx(weights.FLOW_TARGET, rel=1e-4)


@pytest.mark.parametrize("name", ["accel18-offline", "dff-offline"])
def test_weights_follow_the_seed_and_the_serving_dtypes(name):
    cell = spec.load_cell(name)
    config = tiny_config(cell.config)
    layout = spec.reference_model(config, torch.bfloat16, "meta")
    a, b = (weights.draw(layout, 2**40 + 1, "cpu") for _ in range(2))
    c = weights.draw(layout, 2**40 + 2, "cpu")
    key = "ref_net.head.fc6.weight"
    assert torch.equal(a[key], b[key]) and not torch.equal(a[key], c[key])
    assert a[key].dtype == torch.bfloat16
    assert a["ref_net.head.score.weight"].dtype == torch.float32
    assert {k: (t.shape, t.dtype) for k, t in a.items()} == {
        k: (t.shape, t.dtype) for k, t in layout.state_dict().items()}
