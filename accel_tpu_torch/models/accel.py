"""Accel, DFF and per-frame DeepLab (counterpart of
``accel_tpu/models/accel.py``), one module for the three families:

- ``deeplab``: the per-frame DeepLab reference branch only;
- ``dff``: keyframe fc6 *features* warped forward by FlowNet-S flow and the
  DFF scale field, then the shared 1x1 score head;
- ``accel``: the keyframe's *score map* warped forward, a DeepLab update
  branch on every frame, and a 1x1 fusion conv merging the two.

Every branch emits at feature stride.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import torch
from torch import nn

from accel_tpu_torch.config.loader import Config
from accel_tpu_torch.models.deeplab import DeepLab
from accel_tpu_torch.models.flownet import FlowNetS
from accel_tpu_torch.models.resnet import BatchNorm, FrozenBatchNorm
from accel_tpu_torch.ops.upsample import resize_bilinear
from accel_tpu_torch.ops.warp import bilinear_warp, flow_to_feature_res
from accel_tpu_torch.ops.warp_onehot import warp_onehot

FAMILIES = ("deeplab", "dff", "accel")
SCALE_CASCADES = ("last", "product", "mean1", "clamp")


class AccelNet(nn.Module):
    """``accel_tpu``'s ``AccelNet`` for the families ``deeplab``, ``dff`` and
    ``accel``. Only the family's modules exist: ``ref_net`` always,
    ``flownet`` for dff/accel, ``update_net`` and ``fusion`` for accel.

    ``warp_dtype``: 'f32' (warp and modulation in f32) or 'native' (the
    propagated tensor's dtype). ``warp_gather``: 'taps' or 'stacked'
    (the same plain warp here, where the kernel does not take the map) or
    'onehot' (the wide-feature warp, with the scale modulation fused into
    it).
    ``warp_gain_fold`` folds mean1's per-sample gain into that fused
    epilogue. ``scale_cascade`` ('last', 'product', 'mean1', 'clamp') is
    what incremental and composed propagation do with the per-step scale
    fields (``core/pipeline.py``). The update branch may run at its own
    output stride (``update_feat_stride``) and fc6 width
    (``update_head_channels``), 0 meaning the reference branch's, on frames
    downscaled by ``update_input_downscale``; ``fold_update_downscale``
    folds that downscale into the update branch's stem conv, and
    ``fold_flow_downscale`` FlowNet's input downscale into per-frame conv1
    partials (``ops/fold_downscale.py``). ``quantize_ref`` and
    ``quantize_update`` serve a branch's block convs and fc6 through the
    int8 conv (``ops/quant.py``). ``use_kernels=False`` runs every kernel's
    plain PyTorch version (and the int8 conv's exact plain product) even on
    CUDA tensors (for comparing the two); on CPU tensors the plain versions
    always run."""

    def __init__(self, ref_depth=101, update_depth=18, num_classes=19, feat_stride=16,
                 head_channels=1024, head_dilation=6, flow_input_downscale=2,
                 norm="frozenbn", stem="conv7", use_pallas_warp=True, warp_max_disp=8,
                 flow_width_mult=1.0, scale_field_norm="none", scale_cascade="last",
                 family="accel", warp_dtype="f32", warp_gather="taps", warp_gain_fold=False,
                 dilated_conv="auto", update_feat_stride=0, update_head_channels=0,
                 update_input_downscale=1, fold_update_downscale=False,
                 fold_flow_downscale=False, quantize_ref=False, quantize_update=False, *,
                 use_kernels=True, device=None, dtype=torch.bfloat16):
        super().__init__()
        if scale_field_norm not in ("none", "mean1"):
            raise ValueError(f"unsupported scale_field_norm {scale_field_norm!r}")
        if family not in FAMILIES:
            raise ValueError(f"unknown family {family!r} {FAMILIES}")
        if warp_dtype not in ("f32", "native"):
            raise ValueError(f"unsupported warp_dtype {warp_dtype!r} (f32 | native)")
        if scale_cascade not in SCALE_CASCADES:
            raise ValueError(f"unknown scale_cascade {scale_cascade!r} {SCALE_CASCADES}")
        self.family = family
        self.num_classes = num_classes
        self.feat_stride = feat_stride
        self.flow_input_downscale = flow_input_downscale
        self.use_pallas_warp = use_pallas_warp
        self.warp_max_disp = warp_max_disp
        self.scale_field_norm = scale_field_norm
        self.scale_cascade = scale_cascade
        self.warp_dtype = warp_dtype
        self.warp_gather = warp_gather
        self.warp_gain_fold = warp_gain_fold
        self.update_input_downscale = update_input_downscale
        self.fold_update_downscale = fold_update_downscale
        self.fold_flow_downscale = fold_flow_downscale
        self.norm = norm
        self.dtype = dtype
        self.use_kernels = use_kernels
        branch = dict(num_classes=num_classes, output_stride=feat_stride,
                      head_channels=head_channels, head_dilation=head_dilation, norm=norm,
                      stem=stem, dilated_conv=dilated_conv, use_kernels=use_kernels,
                      device=device, dtype=dtype)
        self.ref_net = DeepLab(ref_depth, quantize=quantize_ref, **branch)
        if family == "accel":
            fold = fold_update_downscale and update_input_downscale > 1
            self.update_net = DeepLab(update_depth, quantize=quantize_update, **dict(
                branch, output_stride=update_feat_stride or feat_stride,
                head_channels=update_head_channels or head_channels,
                input_downscale=update_input_downscale if fold else 1))
            self.fusion = nn.Conv2d(2 * num_classes, num_classes, 1, device=device,
                                    dtype=torch.float32)
        if family in ("dff", "accel"):
            scale_channels = head_channels if self.warp_tensor == "features" else num_classes
            self.flownet = FlowNetS(scale_channels, flow_width_mult, device=device, dtype=dtype)

    @property
    def warp_tensor(self) -> str:
        """DFF warps fc6 features (the score head runs per frame); Accel
        warps the score map."""
        return "features" if self.family == "dff" else "scores"

    # ---- branch applications -------------------------------------------

    def ref_propagated(self, image):
        """Keyframe pass of the reference branch -> the tensor that is
        cached and warped (scores for accel, fc6 features for dff)."""
        return self.ref_net(image, mode="features" if self.warp_tensor == "features" else "full")

    def ref_scores_from_propagated(self, prop):
        if self.warp_tensor == "features":
            return self.ref_net.scores_from_features(prop)
        return prop

    def update_scores(self, image):
        """Update-branch scores on the feature grid: the branch runs on the
        frame downscaled by ``update_input_downscale``, and its scores are
        resized onto the grid where its stride or input size differ. Under
        ``fold_update_downscale`` the branch's stem conv reads the
        full-resolution frame with the downscale folded in."""
        feat_hw = (image.shape[-2] // self.feat_stride, image.shape[-1] // self.feat_stride)
        ds = self.update_input_downscale
        if ds > 1 and not self.fold_update_downscale:
            image = resize_bilinear(image, (image.shape[-2] // ds, image.shape[-1] // ds))
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
        if self.warp_dtype == "native":
            # the resize then runs on the storage dtype
            scale_small = scale_small.to(self.dtype)
        return flow, resize_bilinear(scale_small, feat_hw)

    def flow_pair(self, cur_small, anchor_small):
        """Flow (feature res and units) and scale field from already
        downscaled frames; the pair is ``[cur, anchor]``."""
        ds = self.flow_input_downscale
        flow_small, scale_small = self.flownet(torch.cat([cur_small, anchor_small], dim=1))
        feat_hw = (cur_small.shape[-2] * ds // self.feat_stride,
                   cur_small.shape[-1] * ds // self.feat_stride)
        return self._flow_post(flow_small, scale_small, feat_hw)

    def flow_stem_partials(self, frames):
        """Each full-resolution frame's FlowNet conv1 partials in its two
        roles, (cur, anchor), with the flow input downscale folded in
        (``fold_flow_downscale``): a group computes them once per frame and
        combines them per pair."""
        f = self.flow_input_downscale
        return (self.flownet.stem_partial(frames, "cur", f),
                self.flownet.stem_partial(frames, "anchor", f))

    def flow_pair_from_partials(self, cur_part, anchor_part):
        """Flow and scale field (as ``flow_pair``) from conv1 partials."""
        flow_small, scale_small = self.flownet.from_conv1(cur_part + anchor_part)
        ds = self.flow_input_downscale
        feat_hw = (cur_part.shape[-2] * 2 * ds // self.feat_stride,
                   cur_part.shape[-1] * 2 * ds // self.feat_stride)
        return self._flow_post(flow_small, scale_small, feat_hw)

    def flow(self, cur, anchor):
        """Flow mapping cur-frame pixels to their anchor-frame source, at
        feature resolution and units, plus the scale field there."""
        if self.fold_flow_downscale:
            f = self.flow_input_downscale
            return self.flow_pair_from_partials(self.flownet.stem_partial(cur, "cur", f),
                                                self.flownet.stem_partial(anchor, "anchor", f))
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
        """Warp the propagated tensor (in f32, or in its own dtype under
        ``warp_dtype='native'``) and (``modulate``) multiply by the
        (``normalize_scale``: normalized) scale field. Under
        ``warp_gather='onehot'`` the multiply is fused into the warp."""
        x = prop if self.warp_dtype == "native" else prop.to(torch.float32)
        d = self.warp_max_disp if max_disp is None else max_disp
        plain = not self.use_kernels
        if self.warp_gather == "onehot" and modulate:
            if normalize_scale and self.warp_gain_fold and self.scale_field_norm == "mean1":
                # mean1's 1/|mean| rides the fused epilogue as a per-sample
                # f32 scalar; the normalized field never materializes
                gain = self.norm_scale_gain(scale)
                return warp_onehot(x, flow, scale.to(x.dtype), d, gain=gain, plain=plain)
            if normalize_scale:
                scale = self.norm_scale(scale)
            return warp_onehot(x, flow, scale.to(x.dtype), d, plain=plain)
        warped = bilinear_warp(x, flow, use_pallas=self.use_pallas_warp, max_disp=d,
                               gather=self.warp_gather, plain=plain)
        if modulate:
            if normalize_scale:
                scale = self.norm_scale(scale)
            if self.warp_dtype == "native":
                scale = scale.to(warped.dtype)
            warped = warped * scale
        return warped

    def fuse(self, warped_ref_scores, update_scores):
        """1x1 fusion of ``[warped_ref, update]`` in f32."""
        x = torch.cat([warped_ref_scores.to(torch.float32), update_scores.to(torch.float32)],
                      dim=1)
        return self.fusion(x)

    # ---- the pair objective's forward -------------------------------------

    def forward(self, cur, key, eq_flag=None):
        """Training pair forward -> logits at feature stride.

        ``cur`` (N,3,H,W) is the annotated frame, ``key`` its sampled
        keyframe, ``eq_flag`` (N,) 1.0 where cur is key: there the
        keyframe's propagated tensor replaces the warped one (mixed in f32),
        so early flow noise does not reach the score head."""
        if self.family == "deeplab":
            return self.ref_net(cur)
        prop_key = self.ref_propagated(key)
        flow, scale = self.flow(cur, key)
        warped = self.warp(prop_key, flow, scale)
        if eq_flag is not None:
            e = eq_flag.reshape(-1, 1, 1, 1).to(torch.float32)
            warped = e * prop_key.to(torch.float32) + (1.0 - e) * warped
        ref_scores = self.ref_scores_from_propagated(warped)
        if self.family == "dff":
            return ref_scores
        return self.fuse(ref_scores, self.update_scores(cur))


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
    field of one, and the fusion ``0.5*I | 0.5*I`` (the last two where the
    family has them)."""
    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            _lecun_normal_(mod.weight, generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, (FrozenBatchNorm, BatchNorm, nn.GroupNorm)):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
            if isinstance(mod, (FrozenBatchNorm, BatchNorm)):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
    if hasattr(model, "flownet"):
        fn = model.flownet
        for name in ("predict_flow6", "predict_flow5", "predict_flow4", "predict_flow3",
                     "predict_flow2", "scale_field"):
            getattr(fn, name).weight.zero_()
        fn.scale_field.bias.fill_(1.0)
    if hasattr(model, "fusion"):
        c = model.num_classes
        eye = 0.5 * torch.eye(c, dtype=torch.float32)
        model.fusion.weight.copy_(torch.cat([eye, eye], dim=1).view(c, 2 * c, 1, 1))


# cfg.network keys whose other values the port does not run
# (use_scale_field: False drops the DFF scale field, which the port keeps)
_ONLY = {
    "name": FAMILIES,
    "use_scale_field": (True,),
}


def build_model(network: Config | Mapping | None = None, *, num_classes: int | None = None,
                device=None, generator: torch.Generator, use_kernels: bool = True) -> AccelNet:
    """Build and seed-initialise an ``AccelNet``.

    ``network`` is a whole ``Config`` (``config.load_config``): the model
    takes ``cfg.network`` and ``cfg.dataset.NUM_CLASSES``, so every key the
    cfg does not set takes the cfg defaults (``groupnorm``, ``conv7``,
    ``scale_field_norm: mean1``, ...), as ``accel_tpu``'s
    ``build_model(cfg)`` does. Or it is a plain mapping of
    ``cfg.network``-style keys, where a missing key takes ``AccelNet``'s
    defaults and ``num_classes`` defaults to 19.

    Values this port does not run yet raise ``NotImplementedError``. The
    model lives on ``device``, by default the card ("cuda"); without one
    it raises rather than build on the CPU, which takes ``device="cpu"``.
    The parameters are drawn from ``generator`` on its own device, so one
    seed gives the same weights on every device."""
    if isinstance(network, Config):
        if num_classes is None:
            num_classes = int(network.dataset.NUM_CLASSES)
        network = network.network
    net = dict(network or {})
    num_classes = 19 if num_classes is None else num_classes
    for key, allowed in _ONLY.items():
        if key in net and net[key] not in allowed:
            raise NotImplementedError(
                f"network.{key}={net[key]!r} is not ported yet (supported: {allowed})")
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        net.get("dtype", "bfloat16")]
    kwargs = {k: net[k] for k in (
        "ref_depth", "update_depth", "feat_stride", "head_channels", "head_dilation",
        "flow_input_downscale", "norm", "stem", "use_pallas_warp", "warp_max_disp",
        "flow_width_mult", "scale_field_norm", "scale_cascade", "warp_dtype", "warp_gather",
        "warp_gain_fold", "dilated_conv", "update_feat_stride", "update_head_channels",
        "update_input_downscale", "fold_update_downscale", "fold_flow_downscale",
        "quantize_ref", "quantize_update") if k in net}
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device; pass device='cpu' to build on the CPU")
    model = AccelNet(num_classes=num_classes, family=net.get("name", "accel"),
                     use_kernels=use_kernels, device="meta", dtype=dtype, **kwargs)
    model.to_empty(device=device)
    init_weights(model, generator)
    return model.eval()
