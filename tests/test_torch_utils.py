"""The port's ``utils/summary.py`` and ``utils/profiler.py`` against
``accel_tpu``'s: parameter counts of three model families equal the JAX
package's count of the same flax trees (running statistics are buffers
here, ``batch_stats`` there, and neither counts), the summary table's rows
and its ``TOTAL`` as the JAX one prints them, shape inference without
computing, a profiler trace, and the NaN check (the spans:
``test_torch_spans.py``)."""

import os

import jax
import jax.numpy as jnp
import pytest
import torch
from torch_parity import bridged_models

from accel_tpu.models.resnet import DilatedResNet as JDilatedResNet
from accel_tpu.utils import summary as jsummary
from accel_tpu_torch.models.resnet import DilatedResNet
from accel_tpu_torch.utils.profiler import debug_nans, profile_trace
from accel_tpu_torch.utils.summary import ShapeDtype, infer_shapes, param_count, param_summary

torch.set_num_threads(2)
FAMILIES = {
    "accel": dict(family="accel", ref_depth=18, update_depth=18, head_channels=32),
    "dff": dict(family="dff", ref_depth=18, head_channels=32, flow_width_mult=0.5),
    "deeplab": dict(family="deeplab", ref_depth=18, head_channels=32, norm="batchnorm",
                    stem="s2d"),
}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_param_count_matches_jax(family):
    _, v, tm = bridged_models(FAMILIES[family], 128, seed=1)
    want = jsummary.param_count(v)
    assert param_count(tm) == want == param_count(tm.state_dict())
    # the running statistics (frozenbn's and batchnorm's) are not counted
    assert param_count(tm) < sum(t.numel() for t in tm.state_dict().values())


def test_param_summary_rows_and_total_as_jax():
    m = DilatedResNet(depth=18, device="cpu", dtype=torch.float32)
    jm = JDilatedResNet(depth=18, dtype=jnp.float32)
    v = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    ours, ref = param_summary(m, max_rows=5).splitlines(), jsummary.param_summary(v, max_rows=5)
    ref = ref.splitlines()
    assert len(ours) == len(ref) == 7
    assert ours[-2] == ref[-2] == "... (55 more)" and ours[-1] == ref[-1]
    assert ours[-1].startswith("TOTAL") and ours[-1].endswith("11,176,512")
    assert ours[0].split() == ["conv1.weight", "(64,", "3,", "7,", "7)", "float32", "9,408"]
    full = param_summary(m).splitlines()
    assert len(full) == 61 and full[-1] == ref[-1]


def test_infer_shapes_computes_nothing():
    m = DilatedResNet(depth=18, device="cpu", dtype=torch.float32)
    seen = []
    m.layer4_block1.register_forward_hook(lambda mod, a, out: seen.append(type(out).__name__))
    out = infer_shapes(m, torch.zeros((1, 3, 32, 32)))
    assert out == ShapeDtype((1, 512, 2, 2), torch.float32)
    assert seen == ["FakeTensor"]


def test_profile_trace(tmp_path):
    with profile_trace(str(tmp_path / "off"), enabled=False):
        torch.ones(3).sum()
    with profile_trace(None):
        torch.ones(3).sum()
    assert not (tmp_path / "off").exists()
    with profile_trace(str(tmp_path / "on")):
        torch.ones(3).sum()
    (trace,) = os.listdir(tmp_path / "on")
    assert trace.endswith(".pt.trace.json")


def test_debug_nans_context():
    bad = torch.tensor([-1.0])
    with debug_nans(True):
        torch.log(-bad)
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(bad)
    assert torch.isnan(torch.log(bad)).all()  # outside the scope: no check
    with debug_nans(False):
        torch.log(bad)
