"""Plain PyTorch reference of the Accel and DFF video-segmentation models.

A frozen, stand-alone forward of the two architectures as the benchmark's
configurations state them, used to judge the class maps the served program
returns. It imports nothing of the program: every module, warp and
propagation step is written out here in plain ``torch`` operations.

- Accel (Jain, Wang, Gonzalez, CVPR 2019, arXiv:1807.06667): a DeepLab
  reference branch (dilated ResNet-101 at output stride 16, fc6 3x3 at
  dilation 6, a 1x1 score head) on keyframes, whose score map is warped
  forward by FlowNet-S flow and modulated by its scale field; a DeepLab
  update branch (ResNet-18) on every frame; a 1x1 fusion of the two.
- DFF (Zhu et al., CVPR 2017, arXiv:1611.07715): the keyframe's fc6
  features warped forward and modulated by the scale field, then the
  score head.

Parameter and buffer names are the program's ``state_dict`` keys, so one
weight dict loads into both. Built with ``dtype=torch.float32`` the model
computes in f32; the benchmark also builds it on the meta device in the
configuration's serving dtype, to read each tensor's shape and the dtype
it is served in. Departures from the papers, all shared with the
configurations as served: FrozenBN norms (pretrained statistics as a
fixed affine), FlowNet's "deconv" as a 2x bilinear resize and a 3x3 conv,
the warp's displacement clamp (``warp_max_disp``: both axes for the
score-map warp, the vertical axis for the feature warp), and bilinear
resizes with half-pixel centres, antialiased when they shrink.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# (block kind, blocks per stage)
STAGES = {18: ("basic", (2, 2, 2, 2)), 101: ("bottleneck", (3, 4, 23, 3))}
# output stride -> (stride, dilation) of the four stages
STRIDES = {16: ((1, 2, 2, 1), (1, 1, 1, 2)), 8: ((1, 2, 1, 1), (1, 1, 2, 4))}


def resize(x: torch.Tensor, hw) -> torch.Tensor:
    """Bilinear resize with half-pixel centres, antialiased where an axis
    shrinks."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(hw):
        return x
    shrink = hw[0] < h or hw[1] < w
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                         antialias=shrink)


def warp(feat: torch.Tensor, flow: torch.Tensor, clamp_x, clamp_y) -> torch.Tensor:
    """Bilinear warp: ``out[n, c, y, x] = feat[n, c, y + dy, x + dx]`` with
    (dx, dy) = ``flow`` (N,2,h,w) in feature pixels, each clamped to
    ``±clamp`` where one is given, and taps outside the map reading 0."""
    N, C, H, W = feat.shape
    dx, dy = flow[:, 0], flow[:, 1]
    if clamp_x is not None:
        dx = dx.clamp(-clamp_x, clamp_x)
    if clamp_y is not None:
        dy = dy.clamp(-clamp_y, clamp_y)
    sy = torch.arange(H, device=feat.device, dtype=feat.dtype).view(1, H, 1) + dy
    sx = torch.arange(W, device=feat.device, dtype=feat.dtype).view(1, 1, W) + dx
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy, wx = sy - y0, sx - x0
    flat = feat.reshape(N, C, H * W)
    out = torch.zeros_like(flat)
    for oy, ox, wt in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                       (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        yi, xi = y0 + oy, x0 + ox
        inside = (yi >= 0) & (yi <= H - 1) & (xi >= 0) & (xi <= W - 1)
        idx = (yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).to(torch.int64)
        taps = torch.gather(flat, 2, idx.reshape(N, 1, H * W).expand(N, C, H * W))
        out = out + taps * (wt * inside).reshape(N, 1, H * W)
    return out.reshape(N, C, H, W)


class FrozenBN(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.ones(c, **kw))
        self.bias = nn.Parameter(torch.zeros(c, **kw))
        self.register_buffer("running_mean", torch.zeros(c, **kw))
        self.register_buffer("running_var", torch.ones(c, **kw))

    def forward(self, x):
        inv = self.weight / torch.sqrt(self.running_var + 1e-5)
        shift = self.bias - self.running_mean * inv
        return x * inv.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1)


def conv(cin, cout, k, stride=1, dilation=1, bias=False, device=None, dtype=None):
    return nn.Conv2d(cin, cout, k, stride=stride, padding=dilation * (k // 2),
                     dilation=dilation, bias=bias, device=device, dtype=dtype)


class Basic(nn.Module):
    expansion = 1

    def __init__(self, cin, width, stride, dilation, device, dtype):
        super().__init__()
        self.conv1 = conv(cin, width, 3, stride, dilation, device=device, dtype=dtype)
        self.bn1 = FrozenBN(width, device)
        self.conv2 = conv(width, width, 3, 1, dilation, device=device, dtype=dtype)
        self.bn2 = FrozenBN(width, device)
        self.downsample = None
        if cin != width or stride != 1:
            self.downsample = conv(cin, width, 1, stride, device=device, dtype=dtype)
            self.ds_bn = FrozenBN(width, device)

    def forward(self, x):
        y = self.bn2(self.conv2(torch.relu(self.bn1(self.conv1(x)))))
        res = x if self.downsample is None else self.ds_bn(self.downsample(x))
        return torch.relu(y + res)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, width, stride, dilation, device, dtype):
        super().__init__()
        self.conv1 = conv(cin, width, 1, device=device, dtype=dtype)
        self.bn1 = FrozenBN(width, device)
        self.conv2 = conv(width, width, 3, stride, dilation, device=device, dtype=dtype)
        self.bn2 = FrozenBN(width, device)
        self.conv3 = conv(width, 4 * width, 1, device=device, dtype=dtype)
        self.bn3 = FrozenBN(4 * width, device)
        self.downsample = None
        if cin != 4 * width or stride != 1:
            self.downsample = conv(cin, 4 * width, 1, stride, device=device, dtype=dtype)
            self.ds_bn = FrozenBN(4 * width, device)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = x if self.downsample is None else self.ds_bn(self.downsample(x))
        return torch.relu(y + res)


class ResNet(nn.Module):
    """Dilated ResNet v1: 7x7/2 conv, norm, relu, 3x3/2 max pool, four
    stages; returns C5."""

    def __init__(self, depth, output_stride, device, dtype):
        super().__init__()
        kind, plan = STAGES[depth]
        block = Basic if kind == "basic" else Bottleneck
        self.conv1 = conv(3, 64, 7, 2, device=device, dtype=dtype)
        self.bn = FrozenBN(64, device)
        self.blocks = []
        cin = 64
        for s, (n, width, stride, dil) in enumerate(zip(plan, (64, 128, 256, 512),
                                                        *STRIDES[output_stride])):
            for b in range(n):
                name = f"layer{s + 1}_block{b}"
                self.add_module(name, block(cin, width, stride if b == 0 else 1, dil, device,
                                            dtype))
                self.blocks.append(name)
                cin = width * block.expansion
        self.out_channels = cin

    def forward(self, x):
        x = torch.relu(self.bn(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x


class DeepLab(nn.Module):
    """Backbone, fc6 (3x3 at ``head_dilation``, relu) and a 1x1 score head."""

    def __init__(self, depth, num_classes, output_stride, head_channels, head_dilation,
                 device, dtype):
        super().__init__()
        self.backbone = ResNet(depth, output_stride, device, dtype)
        self.head = nn.Module()
        self.head.fc6 = conv(self.backbone.out_channels, head_channels, 3,
                             dilation=head_dilation, bias=True, device=device, dtype=dtype)
        self.head.score = nn.Conv2d(head_channels, num_classes, 1, device=device,
                                    dtype=torch.float32)

    def features(self, image):
        return torch.relu(self.head.fc6(self.backbone(image)))

    def scores(self, features):
        return self.head.score(features)


class FlowNetS(nn.Module):
    """FlowNet-S with the DFF scale-field head. ``forward`` takes the pair
    ``cat(cur, anchor)`` at FlowNet resolution and returns the flow (cur
    pixel -> its anchor source, in input pixels) and the scale field, at a
    quarter of that resolution."""

    def __init__(self, scale_channels, width_mult, device, dtype):
        super().__init__()

        def wm(ch):
            return max(int(ch * width_mult), 16)

        def c(cin, ch, k, s):
            return nn.Conv2d(cin, wm(ch), k, stride=s, padding=k // 2, device=device,
                             dtype=dtype)

        def predict(cin, ch):
            return nn.Conv2d(cin, ch, 3, padding=1, device=device, dtype=torch.float32)

        self.conv1, self.conv2, self.conv3 = c(6, 64, 7, 2), c(wm(64), 128, 5, 2), \
            c(wm(128), 256, 5, 2)
        self.conv3_1, self.conv4 = c(wm(256), 256, 3, 1), c(wm(256), 512, 3, 2)
        self.conv4_1, self.conv5 = c(wm(512), 512, 3, 1), c(wm(512), 512, 3, 2)
        self.conv5_1, self.conv6 = c(wm(512), 512, 3, 1), c(wm(512), 1024, 3, 2)
        self.conv6_1 = c(wm(1024), 1024, 3, 1)
        cat5, cat4 = wm(512) + wm(512) + 2, wm(512) + wm(256) + 2
        cat3, cat2 = wm(256) + wm(128) + 2, wm(128) + wm(64) + 2
        self.deconv5, self.deconv4 = c(wm(1024), 512, 3, 1), c(cat5, 256, 3, 1)
        self.deconv3, self.deconv2 = c(cat4, 128, 3, 1), c(cat3, 64, 3, 1)
        self.predict_flow6, self.predict_flow5 = predict(wm(1024), 2), predict(cat5, 2)
        self.predict_flow4, self.predict_flow3 = predict(cat4, 2), predict(cat3, 2)
        self.predict_flow2 = predict(cat2, 2)
        self.scale_field = predict(cat2, scale_channels)

    def forward(self, pair):
        def leaky(x):
            return F.leaky_relu(x, 0.1)

        def up(x):
            return resize(x, (2 * x.shape[-2], 2 * x.shape[-1]))

        c2 = leaky(self.conv2(leaky(self.conv1(pair))))
        c3 = leaky(self.conv3_1(leaky(self.conv3(c2))))
        c4 = leaky(self.conv4_1(leaky(self.conv4(c3))))
        c5 = leaky(self.conv5_1(leaky(self.conv5(c4))))
        c6 = leaky(self.conv6_1(leaky(self.conv6(c5))))
        flow6 = self.predict_flow6(c6)
        cat5 = torch.cat([c5, leaky(self.deconv5(up(c6))), up(flow6)], dim=1)
        cat4 = torch.cat([c4, leaky(self.deconv4(up(cat5))), up(self.predict_flow5(cat5))], 1)
        cat3 = torch.cat([c3, leaky(self.deconv3(up(cat4))), up(self.predict_flow4(cat4))], 1)
        cat2 = torch.cat([c2, leaky(self.deconv2(up(cat3))), up(self.predict_flow3(cat3))], 1)
        return self.predict_flow2(cat2), self.scale_field(cat2)


class AccelReference(nn.Module):
    """Accel (``network['name'] == 'accel'``) or DFF (``'dff'``) from a
    configuration's ``network`` mapping. Parameters named as the program
    names them; conv weights in ``dtype``, norms and the f32 heads (score,
    FlowNet's predictions and scale field, fusion) in f32."""

    def __init__(self, network: dict, num_classes: int, dtype=torch.float32, device=None):
        super().__init__()
        self.family = network["name"]
        if self.family not in ("accel", "dff"):
            raise ValueError(f"no reference for family {self.family!r}")
        self.feat_stride = network["feat_stride"]
        self.flow_downscale = network["flow_input_downscale"]
        self.max_disp = float(network["warp_max_disp"])
        self.scale_field_norm = network["scale_field_norm"]
        self.scale_cascade = network.get("scale_cascade", "last")
        heads = (num_classes, self.feat_stride, network["head_channels"],
                 network["head_dilation"], device, dtype)
        self.ref_net = DeepLab(network["ref_depth"], *heads)
        if self.family == "accel":
            self.update_net = DeepLab(network["update_depth"], *heads)
            self.fusion = nn.Conv2d(2 * num_classes, num_classes, 1, device=device,
                                    dtype=torch.float32)
        warped = network["head_channels"] if self.family == "dff" else num_classes
        self.flownet = FlowNetS(warped, network["flow_width_mult"], device, dtype)

    def key(self, image):
        """The keyframe's propagated tensor (Accel: scores; DFF: fc6
        features) and its logits."""
        feats = self.ref_net.features(image)
        if self.family == "dff":
            return feats, self.ref_net.scores(feats)
        scores = self.ref_net.scores(feats)
        return scores, self.fuse(scores, image)

    def fuse(self, scores, image):
        update = self.update_net.scores(self.update_net.features(image))
        return self.fusion(torch.cat([scores, update], dim=1))

    def flow(self, cur, anchor):
        """Flow (cur -> anchor, feature pixels) and scale field at the
        feature grid."""
        ds = self.flow_downscale
        small = [resize(x, (x.shape[-2] // ds, x.shape[-1] // ds)) for x in (cur, anchor)]
        flow, scale = self.flownet(torch.cat(small, dim=1))
        hw = (cur.shape[-2] // self.feat_stride, cur.shape[-1] // self.feat_stride)
        return resize(flow, hw) * (ds / self.feat_stride), resize(scale, hw)

    def modulation(self, scale):
        if self.scale_field_norm == "mean1":
            return scale / (scale.mean(dim=(1, 2, 3), keepdim=True).abs() + 1e-6)
        return scale

    def group_logits(self, frames: torch.Tensor, propagate: str, upto: int | None = None):
        """Logits at feature stride (n, C, h, w) of the first ``upto``
        frames (all by default) of one keyframe group ``frames`` (k,3,H,W),
        keyframe first. 'incremental' warps frame to frame (scale cascade
        'last': the carry is unmodulated, each scored copy takes its own
        step's scale field); 'direct' warps every frame from the keyframe."""
        n = frames.shape[0] if upto is None else upto
        prop, key_logits = self.key(frames[:1])
        out = [key_logits]
        carry = prop
        for i in range(1, n):
            anchor = frames[i - 1:i] if propagate == "incremental" else frames[:1]
            flow, scale = self.flow(frames[i:i + 1], anchor)
            if self.family == "accel":
                if propagate != "incremental" or self.scale_cascade != "last":
                    raise ValueError("the Accel reference serves incremental + 'last'")
                carry = warp(carry, flow, self.max_disp, self.max_disp)
                scored = carry * self.modulation(scale)
                out.append(self.fuse(scored, frames[i:i + 1]))
            else:
                if propagate != "direct":
                    raise ValueError("the DFF reference serves direct propagation")
                warped = warp(prop, flow, None, self.max_disp) * self.modulation(scale)
                out.append(self.ref_net.scores(warped))
        return torch.cat(out)


def build(config: dict, dtype, device) -> AccelReference:
    """The reference of ``config`` (a configuration file's contents), its
    conv weights in ``dtype``, on ``device``, in eval mode."""
    return AccelReference(config["network"], config["num_classes"], dtype, device).eval()
