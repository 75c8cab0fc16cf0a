"""FlowNet-S with the DFF scale-field head (counterpart of
``accel_tpu/models/flownet.py``).

Input is the channel concat ``[cur, anchor]`` at FlowNet resolution; the
predicted flow maps a pixel of ``cur`` to its source in ``anchor``, in
FlowNet-input pixels, at 1/4 of that resolution. The predict convs start
at zero (identity warp) and the scale field's bias at one (identity
modulation). "Deconv" is a 2x bilinear resize followed by a 3x3 conv.

Folded prologue (``stem_partial`` + ``from_conv1``): conv1 is linear in its
6 input channels, so ``conv1(cat(d(cur), d(anchor)))`` is the sum of two
per-frame convs of its kernel halves, each with the factor-f bilinear
downscale ``d`` folded in (``ops/fold_downscale.py``), on full-resolution
frames. A group computes each frame's two partials once and adds them per
pair at 1/2f resolution; the bias rides the 'cur' half.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from accel_tpu_torch.ops.fold_downscale import fold_downscale_conv
from accel_tpu_torch.ops.upsample import bilinear_upsample


def _leaky(x):
    return F.leaky_relu(x, negative_slope=0.1)


class FlowNetS(nn.Module):
    def __init__(self, scale_channels=19, width_mult=1.0, *, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        wm = lambda ch: max(int(ch * width_mult), 16)  # noqa: E731

        def conv(cin, ch, k, s):
            return nn.Conv2d(cin, wm(ch), k, stride=s, padding=k // 2, device=device,
                             dtype=dtype)

        def predict(cin, ch):
            return nn.Conv2d(cin, ch, 3, padding=1, device=device, dtype=torch.float32)

        self.conv1 = conv(6, 64, 7, 2)
        self.conv2 = conv(wm(64), 128, 5, 2)
        self.conv3 = conv(wm(128), 256, 5, 2)
        self.conv3_1 = conv(wm(256), 256, 3, 1)
        self.conv4 = conv(wm(256), 512, 3, 2)
        self.conv4_1 = conv(wm(512), 512, 3, 1)
        self.conv5 = conv(wm(512), 512, 3, 2)
        self.conv5_1 = conv(wm(512), 512, 3, 1)
        self.conv6 = conv(wm(512), 1024, 3, 2)
        self.conv6_1 = conv(wm(1024), 1024, 3, 1)
        cat5 = wm(512) + wm(512) + 2
        cat4 = wm(512) + wm(256) + 2
        cat3 = wm(256) + wm(128) + 2
        cat2 = wm(128) + wm(64) + 2
        self.deconv5 = conv(wm(1024), 512, 3, 1)
        self.deconv4 = conv(cat5, 256, 3, 1)
        self.deconv3 = conv(cat4, 128, 3, 1)
        self.deconv2 = conv(cat3, 64, 3, 1)
        self.predict_flow6 = predict(wm(1024), 2)
        self.predict_flow5 = predict(cat5, 2)
        self.predict_flow4 = predict(cat4, 2)
        self.predict_flow3 = predict(cat3, 2)
        self.predict_flow2 = predict(cat2, 2)
        self.scale_field = predict(cat2, scale_channels)

    def forward(self, pair):
        """pair (N,6,H,W) = cat(cur, anchor), H and W divisible by 64 ->
        (flow (N,2,H/4,W/4), scale (N,S,H/4,W/4)), both f32."""
        return self.from_conv1(self.conv1(pair.to(self.dtype)))

    def stem_partial(self, frame, role: str, fold: int):
        """conv1's 'cur' (input channels 0:3, with the bias) or 'anchor'
        (3:6) kernel half on one full-resolution frame (N,3,H,W) with the
        factor-``fold`` downscale folded in, so that ``cur + anchor``
        equals conv1 of the downscaled pair inside the fold's edge ring
        (``accel_tpu``'s ``_Conv1`` roles)."""
        if role not in ("cur", "anchor"):
            raise ValueError(f"unknown conv1 role {role!r} (cur | anchor)")
        w = self.conv1.weight
        half = w[:, :3] if role == "cur" else w[:, 3:]
        y = fold_downscale_conv(frame.to(self.dtype), half, fold, 2, 3)
        return y + self.conv1.bias.view(1, -1, 1, 1) if role == "cur" else y

    def from_conv1(self, c1_preact):
        """The FlowNet-S tail from the (pre-activation) conv1 output."""
        dt = self.dtype
        f32 = torch.float32

        def upconv(mod, x):
            return mod(bilinear_upsample(x, 2))

        def upflow(f):  # units stay FlowNet-input pixels at every level
            return bilinear_upsample(f, 2).to(dt)

        c1 = _leaky(c1_preact.to(dt))
        c2 = _leaky(self.conv2(c1))
        c3 = _leaky(self.conv3_1(_leaky(self.conv3(c2))))
        c4 = _leaky(self.conv4_1(_leaky(self.conv4(c3))))
        c5 = _leaky(self.conv5_1(_leaky(self.conv5(c4))))
        c6 = _leaky(self.conv6_1(_leaky(self.conv6(c5))))

        flow6 = self.predict_flow6(c6.to(f32))
        cat5 = torch.cat([c5, _leaky(upconv(self.deconv5, c6)), upflow(flow6)], dim=1)
        flow5 = self.predict_flow5(cat5.to(f32))
        cat4 = torch.cat([c4, _leaky(upconv(self.deconv4, cat5)), upflow(flow5)], dim=1)
        flow4 = self.predict_flow4(cat4.to(f32))
        cat3 = torch.cat([c3, _leaky(upconv(self.deconv3, cat4)), upflow(flow4)], dim=1)
        flow3 = self.predict_flow3(cat3.to(f32))
        cat2 = torch.cat([c2, _leaky(upconv(self.deconv2, cat3)), upflow(flow3)], dim=1)
        flow2 = self.predict_flow2(cat2.to(f32))
        return flow2, self.scale_field(cat2.to(f32))
