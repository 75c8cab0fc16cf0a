"""Accel: corrective-fusion video segmentation (counterpart of
``accel_tpu/models/accel.py``, family ``accel``).

A DeepLab reference branch runs on keyframes; FlowNet-S flow plus the DFF
scale field warps the keyframe's score map forward; a DeepLab update branch
runs on every frame; a 1x1 fusion conv merges the two score maps. Every
branch emits at feature stride.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import torch
from torch import nn

from accel_tpu_torch.models.deeplab import DeepLab
from accel_tpu_torch.models.flownet import FlowNetS
from accel_tpu_torch.models.resnet import FrozenBatchNorm
from accel_tpu_torch.ops.upsample import resize_bilinear
from accel_tpu_torch.ops.warp import bilinear_warp, flow_to_feature_res


class AccelNet(nn.Module):
    """Family ``accel`` of ``accel_tpu``'s ``AccelNet``.

    ``use_kernels=False`` runs every kernel's plain PyTorch version even on
    CUDA tensors (for comparing the two); on CPU tensors the plain versions
    always run."""

    def __init__(self, ref_depth=101, update_depth=18, num_classes=19, feat_stride=16,
                 head_channels=1024, head_dilation=6, flow_input_downscale=2,
                 norm="frozenbn", stem="conv7", use_pallas_warp=True, warp_max_disp=8,
                 flow_width_mult=1.0, scale_field_norm="none", scale_cascade="last", *,
                 use_kernels=True, device=None, dtype=torch.bfloat16):
        super().__init__()
        if scale_field_norm not in ("none", "mean1"):
            raise ValueError(f"unsupported scale_field_norm {scale_field_norm!r}")
        self.num_classes = num_classes
        self.feat_stride = feat_stride
        self.flow_input_downscale = flow_input_downscale
        self.use_pallas_warp = use_pallas_warp
        self.warp_max_disp = warp_max_disp
        self.scale_field_norm = scale_field_norm
        self.scale_cascade = scale_cascade
        self.use_kernels = use_kernels
        branch = dict(num_classes=num_classes, output_stride=feat_stride,
                      head_channels=head_channels, head_dilation=head_dilation, norm=norm,
                      stem=stem, use_kernels=use_kernels, device=device, dtype=dtype)
        self.ref_net = DeepLab(ref_depth, **branch)
        self.update_net = DeepLab(update_depth, **branch)
        self.fusion = nn.Conv2d(2 * num_classes, num_classes, 1, device=device,
                                dtype=torch.float32)
        self.flownet = FlowNetS(num_classes, flow_width_mult, device=device, dtype=dtype)

    # ---- branch applications -------------------------------------------

    def ref_propagated(self, image):
        """Keyframe pass of the reference branch -> the score map that is
        cached and warped."""
        return self.ref_net(image, mode="full")

    def ref_scores_from_propagated(self, prop):
        return prop

    def update_scores(self, image):
        feat_hw = (image.shape[-2] // self.feat_stride, image.shape[-1] // self.feat_stride)
        s = self.update_net(image)
        if tuple(s.shape[-2:]) != feat_hw:
            s = resize_bilinear(s, feat_hw)
        return s

    def downscale_for_flow(self, frames):
        """(N,3,H,W) full-res -> FlowNet-input resolution."""
        ds = self.flow_input_downscale
        return resize_bilinear(frames, (frames.shape[-2] // ds, frames.shape[-1] // ds))

    def _flow_post(self, flow_small, scale_small, feat_hw):
        flow = flow_to_feature_res(flow_small, feat_hw,
                                   self.flow_input_downscale / self.feat_stride)
        return flow, resize_bilinear(scale_small, feat_hw)

    def flow_pair(self, cur_small, anchor_small):
        """Flow (feature res and units) and scale field from already
        downscaled frames; the pair is ``[cur, anchor]``."""
        ds = self.flow_input_downscale
        flow_small, scale_small = self.flownet(torch.cat([cur_small, anchor_small], dim=1))
        feat_hw = (cur_small.shape[-2] * ds // self.feat_stride,
                   cur_small.shape[-1] * ds // self.feat_stride)
        return self._flow_post(flow_small, scale_small, feat_hw)

    def flow(self, cur, anchor):
        """Flow mapping cur-frame pixels to their anchor-frame source, at
        feature resolution and units, plus the scale field there."""
        return self.flow_pair(self.downscale_for_flow(cur), self.downscale_for_flow(anchor))

    def norm_scale_gain(self, scale):
        """mean1's per-sample gain 1/(|mean|+eps), shape (N,) f32."""
        m = scale.mean(dim=(1, 2, 3))
        return 1.0 / (m.abs().to(torch.float32) + 1e-6)

    def norm_scale(self, scale):
        if self.scale_field_norm == "mean1":
            scale = scale * self.norm_scale_gain(scale).view(-1, 1, 1, 1).to(scale.dtype)
        return scale

    def warp(self, prop, flow, scale, normalize_scale=True, max_disp=None, modulate=True):
        """Warp the propagated tensor in f32 and (``modulate``) multiply by
        the (``normalize_scale``: normalized) scale field."""
        d = self.warp_max_disp if max_disp is None else max_disp
        warped = bilinear_warp(prop.to(torch.float32), flow, use_pallas=self.use_pallas_warp,
                               max_disp=d, plain=not self.use_kernels)
        if modulate:
            if normalize_scale:
                scale = self.norm_scale(scale)
            warped = warped * scale
        return warped

    def fuse(self, warped_ref_scores, update_scores):
        """1x1 fusion of ``[warped_ref, update]`` in f32."""
        x = torch.cat([warped_ref_scores.to(torch.float32), update_scores.to(torch.float32)],
                      dim=1)
        return self.fusion(x)


# ---- initialisation, mirroring the flax initializers ----------------------


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``lecun_normal``: truncated normal in [-2, 2] std, variance 1/fan_in."""
    fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    t = torch.empty(w.shape, dtype=torch.float32, device=generator.device)
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
    w.copy_(t)


@torch.no_grad()
def init_weights(model: AccelNet, generator: torch.Generator) -> None:
    """Seeded init of every parameter and buffer, in module order: lecun
    normal convs with zero biases, unit norms, zero predict heads, a scale
    field of one, and the fusion ``0.5*I | 0.5*I``."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            _lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (FrozenBatchNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, FrozenBatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    fn = model.flownet
    for name in ("predict_flow6", "predict_flow5", "predict_flow4", "predict_flow3",
                 "predict_flow2", "scale_field"):
        getattr(fn, name).weight.zero_()
    fn.scale_field.bias.fill_(1.0)
    c = model.num_classes
    eye = 0.5 * torch.eye(c, dtype=torch.float32)
    model.fusion.weight.copy_(torch.cat([eye, eye], dim=1).view(c, 2 * c, 1, 1))


# cfg.network keys whose other values need code that a later port slice adds
_ONLY = {
    "name": ("accel",),
    "use_scale_field": (True,),
    "warp_dtype": ("f32",),
    "warp_gather": ("taps",),
    "warp_gain_fold": (False,),
    "update_input_downscale": (1,),
    "fold_update_downscale": (False,),
    "fold_flow_downscale": (False,),
    "quantize_ref": (False,),
    "quantize_update": (False,),
    "dilated_conv": ("auto", "direct"),
    "scale_cascade": ("last", "product"),
}


def build_model(network: Mapping | None = None, *, num_classes: int = 19,
                device=None, generator: torch.Generator, use_kernels: bool = True) -> AccelNet:
    """Build and seed-initialise an ``AccelNet`` from ``cfg.network``-style
    keys (a plain mapping; missing keys take ``AccelNet``'s defaults).

    Values this port does not run yet raise ``NotImplementedError``. The
    parameters are drawn from ``generator`` on its own device, so one seed
    gives the same weights on every device."""
    net = dict(network or {})
    for key, allowed in _ONLY.items():
        if key in net and net[key] not in allowed:
            raise NotImplementedError(
                f"network.{key}={net[key]!r} is not ported yet (supported: {allowed})")
    for key, inherit, default in (("update_feat_stride", "feat_stride", 16),
                                  ("update_head_channels", "head_channels", 1024)):
        if net.get(key) and net[key] != net.get(inherit, default):
            raise NotImplementedError(f"network.{key} != {inherit} is not ported yet")
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        net.get("dtype", "bfloat16")]
    kwargs = {k: net[k] for k in (
        "ref_depth", "update_depth", "feat_stride", "head_channels", "head_dilation",
        "flow_input_downscale", "norm", "stem", "use_pallas_warp", "warp_max_disp",
        "flow_width_mult", "scale_field_norm", "scale_cascade") if k in net}
    model = AccelNet(num_classes=num_classes, use_kernels=use_kernels, device="meta",
                     dtype=dtype, **kwargs)
    model.to_empty(device=device or "cpu")
    init_weights(model, generator)
    return model.eval()
