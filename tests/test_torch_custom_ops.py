"""The six kernels as ``torch.library`` ops (``torch.ops.accel_tpu_torch.*``,
the form a program traced by ``torch.export`` calls them in), on CPU
inputs, where each op runs its kernel's plain version.

``torch.library.opcheck`` holds each op's schema, its fake (shape)
implementation against the real one, its autograd registration and its
use under ``aot_autograd`` with dynamic shapes; the inputs of #1, #3, #4
and #6 require grad, so their registered gradients (autograd through the
plain version, as the JAX custom VJPs; #6: ``upsample_bilinear2d``'s
backward) run too. Each op's output equals its plain
version's exactly."""

import pytest
import torch

from accel_tpu_torch.ops import dilated_cuda as tdc
from accel_tpu_torch.ops import fused_stem as tstem
from accel_tpu_torch.ops import upsample as tup
from accel_tpu_torch.ops import upsample_argmax as tua
from accel_tpu_torch.ops import warp_cuda as twc
from accel_tpu_torch.ops import warp_onehot as two

torch.set_num_threads(2)


def _case(name: str):
    """(op, op arguments, the plain version's output) for ``name``."""
    g = torch.Generator().manual_seed(len(name))

    def r(*shape, scale=1.0, grad=False):
        return (torch.randn(*shape, generator=g) * scale).requires_grad_(grad)

    if name == "warp":
        args = (r(2, 3, 6, 8, grad=True), r(2, 2, 6, 8, scale=3.0, grad=True), 2.0)
        return twc.warp_op, args, twc.warp_plain(*args)
    if name == "upsample_argmax":
        args = (r(2, 5, 4, 6), [8, 12])
        return tua.upsample_argmax_op, args, tua.upsample_argmax_plain(*args)
    if name == "fused_stem":
        args = (r(1, 3, 16, 20, grad=True), r(64, 3, 7, 7, scale=0.1, grad=True),
                r(64, grad=True), r(64, grad=True), None)
        return tstem.fused_stem_op, args, tstem.fused_stem_plain(*args[:4])
    if name == "upsample2x":
        args = (r(2, 3, 5, 7, grad=True),)
        return tup.upsample2x_op, args, tup.upsample2x_plain(*args)
    if name == "conv3x3_dilated":
        args = (r(1, 8, 6, 8), r(4, 8, 3, 3, scale=0.3), 2, None)
        return tdc.conv3x3_dilated_op, args, tdc.conv3x3_dilated_plain(*args[:3])
    feat, flow = r(2, 8, 6, 8, grad=True), r(2, 2, 6, 8, scale=3.0, grad=True)
    if name == "warp_onehot":
        args = (feat, flow, r(2, 8, 6, 8, grad=True), 2.0, r(2, grad=True), torch.bfloat16)
    else:  # no scale: DFF without the scale field
        args = (feat, flow, None, 2.0, None, torch.float32)
    return two.warp_onehot_op, args, two.warp_onehot_plain(*args)


@pytest.mark.parametrize("name", ["warp", "upsample_argmax", "fused_stem", "warp_onehot",
                                  "warp_onehot_no_scale", "conv3x3_dilated", "upsample2x"])
def test_op_passes_opcheck_and_equals_its_plain_version(name):
    op, args, want = _case(name)
    assert op._qualname == f"accel_tpu_torch::{name.removesuffix('_no_scale')}"
    results = torch.library.opcheck(op, args)
    assert set(results.values()) == {"SUCCESS"}, results
    with torch.no_grad():
        got = op(*args)
    assert got.dtype == want.dtype and torch.equal(got, want.detach())

