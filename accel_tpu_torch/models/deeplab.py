"""DeepLab head + per-frame model (counterpart of ``accel_tpu/models/deeplab.py``).

The head splits into ``features`` (the atrous fc6 conv + relu) and
``scores`` (the 1x1 classifier, in f32) because the DFF family warps fc6
features while Accel warps the score map.
"""

from __future__ import annotations

import torch
from torch import nn

from accel_tpu_torch.models.resnet import DilatedResNet, _conv


class DeepLabHead(nn.Module):
    def __init__(self, in_channels, num_classes=19, head_channels=1024, head_dilation=6, *,
                 dilated_conv="auto", use_kernels=True, device=None, dtype=torch.bfloat16):
        super().__init__()
        self.fc6 = _conv(in_channels, head_channels, 3, dilation=head_dilation, bias=True,
                         dilated_conv=dilated_conv, use_kernels=use_kernels, device=device,
                         dtype=dtype)
        self.score = nn.Conv2d(head_channels, num_classes, 1, device=device,
                               dtype=torch.float32)

    def forward(self, feat, mode: str = "full"):
        """mode: 'full' = fc6 + score, 'scores' = score only, 'features' = fc6 only."""
        if mode not in ("full", "features", "scores"):
            raise ValueError(f"unknown head mode {mode!r}")
        x = feat
        if mode in ("full", "features"):
            x = torch.relu(self.fc6(x))
            if mode == "features":
                return x
        return self.score(x.to(torch.float32))


class DeepLab(nn.Module):
    """Dilated ResNet backbone + DeepLab head; logits at feature stride.

    ``dilated_conv``: 'auto'/'direct' (``nn.Conv2d`` everywhere), 'pallas'
    (every dilated 3x3 conv of the backbone and fc6 through the dilated
    kernel) or 'pallas_fc6' (fc6 only, the backbone as 'auto'), as
    ``accel_tpu``'s ``DeepLab.setup`` splits them."""

    def __init__(self, depth=101, num_classes=19, output_stride=16, head_channels=1024,
                 head_dilation=6, norm="frozenbn", stem="conv7", *, dilated_conv="auto",
                 use_kernels=True, device=None, dtype=torch.bfloat16):
        super().__init__()
        fc6_only = dilated_conv == "pallas_fc6"
        self.backbone = DilatedResNet(depth, output_stride, norm, stem,
                                      dilated_conv="auto" if fc6_only else dilated_conv,
                                      use_kernels=use_kernels, device=device, dtype=dtype)
        self.head = DeepLabHead(self.backbone.out_channels, num_classes, head_channels,
                                head_dilation,
                                dilated_conv="pallas" if fc6_only else dilated_conv,
                                use_kernels=use_kernels, device=device, dtype=dtype)

    def forward(self, image, mode: str = "full"):
        """image (N,3,H,W) normalized -> logits/features at feature stride."""
        return self.head(self.backbone(image), mode=mode)

    def scores_from_features(self, features):
        return self.head(features, mode="scores")
