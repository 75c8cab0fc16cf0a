"""Dilated ResNet v1 backbones (counterpart of ``accel_tpu/models/resnet.py``).

Module and attribute names follow the flax tree (``conv1``, ``bn``,
``layer{s}_block{b}``, ``bn1``, ``downsample``, ``ds_bn``...) so the weight
bridge (``convert.py``) maps names one to one. Conv weights live in the
compute dtype: flax keeps f32 params and casts them to the compute dtype at
every apply, which rounds them the same way. Training keeps the f32 master
copy beside the model (``core/trainer.py``) and writes it, rounded, into
the model after each step.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from accel_tpu_torch.ops.dilated_cuda import (
    conv3x3_dilated,
    pack_dilated_weight,
    pack_dilated_weight_dx,
)
from accel_tpu_torch.ops.fused_stem import fused_stem, stem_kernel_weight

STAGE_PLANS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}

# (strides, dilations) of the four stages per output stride (DeepLab recipe)
STRIDE_PLANS = {
    32: ((1, 2, 2, 2), (1, 1, 1, 1)),
    16: ((1, 2, 2, 1), (1, 1, 1, 2)),
    8: ((1, 2, 1, 1), (1, 1, 2, 4)),
}


class FrozenBatchNorm(nn.Module):
    """BN as a fixed per-channel affine. ``inv``/``shift`` fold in f32 and
    apply in the activation dtype, as the flax module does (here as one
    fused multiply-add pass)."""

    def __init__(self, c: int, *, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.ones(c, **kw))
        self.bias = nn.Parameter(torch.zeros(c, **kw))
        self.register_buffer("running_mean", torch.zeros(c, **kw))
        self.register_buffer("running_var", torch.ones(c, **kw))

    def folded(self) -> tuple[torch.Tensor, torch.Tensor]:
        inv = self.weight / torch.sqrt(self.running_var + 1e-5)
        return inv, self.bias - self.running_mean * inv

    def forward(self, x):
        inv, shift = self.folded()
        return torch.addcmul(shift.to(x.dtype).view(1, -1, 1, 1), x,
                             inv.to(x.dtype).view(1, -1, 1, 1))


class GroupNorm16(nn.GroupNorm):
    """flax ``GroupNorm(group_size=16, epsilon=1e-5)``: f32 statistics with
    flax's fast variance ``E[x^2] - E[x]^2`` (clipped at 0), the affine in
    f32, output in the activation dtype.

    The statistics are two f32-accumulating reductions over the (N, G, -1)
    view rather than ``F.group_norm``, whose CUDA kernel gives each of the
    N*G rows one thread block: at N=1 and 4-32 groups over a 1024x2048
    frame's feature maps that leaves the card nearly idle."""

    def __init__(self, c: int, *, device=None):
        super().__init__(c // 16, c, eps=1e-5, device=device, dtype=torch.float32)

    def forward(self, x):
        N, C = x.shape[:2]
        xg = x.reshape(N, self.num_groups, -1)
        n = xg.shape[-1]
        mean = xg.sum(-1, dtype=torch.float32) / n
        sq = torch.linalg.vector_norm(xg, 2, dim=-1, dtype=torch.float32) ** 2 / n
        rstd = torch.rsqrt((sq - mean * mean).clamp_min(0.0) + self.eps)
        scale = (rstd.repeat_interleave(C // self.num_groups, dim=1) * self.weight)
        shift = self.bias - mean.repeat_interleave(C // self.num_groups, dim=1) * scale
        return torch.addcmul(shift.view(N, C, 1, 1), x, scale.view(N, C, 1, 1)).to(x.dtype)


def make_norm(norm: str, c: int, *, device=None) -> nn.Module:
    """norm: 'frozenbn' or 'groupnorm' (``batchnorm`` waits for training)."""
    if norm == "frozenbn":
        return FrozenBatchNorm(c, device=device)
    if norm == "groupnorm":
        return GroupNorm16(c, device=device)
    raise ValueError(f"unsupported norm {norm!r} (frozenbn | groupnorm)")


class PackedWeight:
    """A kernel's packing of a parameter, made once per parameter version:
    again after an in-place write (``load_state_dict``, ``copy_``) or a
    move to other storage. A plain attribute, so ``state_dict`` keeps only
    the parameter. A write through ``param.data`` does not bump the
    version and is not seen: write parameters with ``copy_`` under
    ``torch.no_grad()``, as the trainer does."""

    def __init__(self, pack):
        self.pack, self.key, self.value = pack, None, None

    def __call__(self, param: torch.Tensor, *args) -> torch.Tensor:
        key = (param.data_ptr(), param._version, *args)
        if key != self.key:
            self.value, self.key = self.pack(param.detach(), *args), key
        return self.value


class DilatedConv3x3(nn.Conv2d):
    """A 3x3, stride-1 conv with dilation d and padding d whose conv runs
    through ``ops/dilated_cuda.py`` (the kernel on CUDA, ``F.conv2d`` on the
    CPU or with ``use_kernels=False``); the bias is added after it, as the
    flax hook computes only the conv. Same parameters and ``state_dict``
    keys as ``nn.Conv2d``; the kernel's packed weights are a cache beside
    them (``packed_weight``), and so are the rotated weights of its
    backward's dx conv (``packed_weight_dx``)."""

    def __init__(self, cin, cout, dilation, *, bias=False, use_kernels=True, device=None,
                 dtype=None):
        super().__init__(cin, cout, 3, padding=dilation, dilation=dilation, bias=bias,
                         device=device, dtype=dtype)
        self.use_kernels = use_kernels
        self._packed = PackedWeight(pack_dilated_weight)
        self._packed_dx = PackedWeight(pack_dilated_weight_dx)

    def packed_weight(self) -> torch.Tensor:
        """``pack_dilated_weight(self.weight)``, packed once per weight version."""
        return self._packed(self.weight)

    def packed_weight_dx(self) -> torch.Tensor:
        """``pack_dilated_weight_dx(self.weight)``, packed once per weight
        version, on the first backward that needs it."""
        return self._packed_dx(self.weight)

    def forward(self, x):
        plain = not self.use_kernels or x.device.type == "cpu"
        y = conv3x3_dilated(x, self.weight, self.dilation[0], plain=plain,
                            packed=None if plain else self.packed_weight(),
                            packed_dx=self.packed_weight_dx)
        if self.bias is not None:
            y = y + self.bias.view(1, -1, 1, 1)
        return y


def _conv(cin, cout, k, *, stride=1, dilation=1, bias=False, dilated_conv="auto",
          use_kernels=True, device=None, dtype=None):
    """Conv with 'same' padding. ``dilated_conv='pallas'`` sends a 3x3,
    stride-1 conv with dilation > 1 to the dilated kernel
    (``accel_tpu``'s ``_pick_conv_fn`` and ``pallas_conv_general_dilated``
    route the same convs); 'auto' and 'direct' keep ``nn.Conv2d``."""
    if dilated_conv == "pallas" and k == 3 and stride == 1 and dilation > 1:
        return DilatedConv3x3(cin, cout, dilation, bias=bias, use_kernels=use_kernels,
                              device=device, dtype=dtype)
    pad = dilation * (k // 2)
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, dilation=dilation,
                     bias=bias, device=device, dtype=dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, width, stride=1, dilation=1, norm="frozenbn", *,
                 dilated_conv="auto", use_kernels=True, device=None, dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        routed = dict(kw, dilated_conv=dilated_conv, use_kernels=use_kernels)
        self.conv1 = _conv(cin, width, 3, stride=stride, dilation=dilation, **routed)
        self.bn1 = make_norm(norm, width, device=device)
        self.conv2 = _conv(width, width, 3, dilation=dilation, **routed)
        self.bn2 = make_norm(norm, width, device=device)
        if cin != width or stride != 1:
            self.downsample = _conv(cin, width, 1, stride=stride, **kw)
            self.ds_bn = make_norm(norm, width, device=device)
        else:
            self.downsample = None

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.ds_bn(self.downsample(x))
        return torch.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin, width, stride=1, dilation=1, norm="frozenbn", *,
                 dilated_conv="auto", use_kernels=True, device=None, dtype=torch.bfloat16):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        out_ch = 4 * width
        self.conv1 = _conv(cin, width, 1, **kw)
        self.bn1 = make_norm(norm, width, device=device)
        self.conv2 = _conv(width, width, 3, stride=stride, dilation=dilation,
                           dilated_conv=dilated_conv, use_kernels=use_kernels, **kw)
        self.bn2 = make_norm(norm, width, device=device)
        self.conv3 = _conv(width, out_ch, 1, **kw)
        self.bn3 = make_norm(norm, out_ch, device=device)
        if cin != out_ch or stride != 1:
            self.downsample = _conv(cin, out_ch, 1, stride=stride, **kw)
            self.ds_bn = make_norm(norm, out_ch, device=device)
        else:
            self.downsample = None

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.ds_bn(self.downsample(x))
        return torch.relu(y + residual)


class DilatedResNet(nn.Module):
    """ResNet v1 trunk with DeepLab dilation; returns the C5 feature map.

    ``stem``: 'conv7' (conv + norm + relu) or 'fused7' (the same parameters
    through the fused stem kernel; frozenbn only, since the norm must fold
    into a per-channel affine). ``dilated_conv``: 'auto' or 'direct'
    (``nn.Conv2d``), or 'pallas' (every dilated 3x3 conv through the dilated
    kernel). ``use_kernels=False`` runs the kernels' plain versions even on
    CUDA (for comparing the two)."""

    def __init__(self, depth=101, output_stride=16, norm="frozenbn", stem="conv7", *,
                 dilated_conv="auto", use_kernels=True, device=None, dtype=torch.bfloat16):
        super().__init__()
        if dilated_conv not in ("auto", "direct", "pallas"):
            raise ValueError(f"unsupported dilated_conv {dilated_conv!r} "
                             "(auto | direct | pallas)")
        if stem not in ("conv7", "fused7"):
            raise ValueError(f"unsupported stem {stem!r} (conv7 | fused7)")
        if stem == "fused7" and norm != "frozenbn":
            raise ValueError("stem='fused7' requires norm='frozenbn' "
                             "(the BN must fold to a per-channel affine)")
        if output_stride not in STRIDE_PLANS:
            raise ValueError(f"bad output_stride {output_stride}")
        self.stem, self.dtype, self.use_kernels = stem, dtype, use_kernels
        self._stem_packed = PackedWeight(stem_kernel_weight)
        kind, plan = STAGE_PLANS[depth]
        block_cls = BasicBlock if kind == "basic" else Bottleneck
        strides, dils = STRIDE_PLANS[output_stride]
        self.conv1 = _conv(3, 64, 7, stride=2, device=device, dtype=dtype)
        self.bn = make_norm(norm, 64, device=device)
        self.block_names = []
        cin = 64
        for si, (n_blocks, w, s, d) in enumerate(zip(plan, (64, 128, 256, 512), strides, dils)):
            for bi in range(n_blocks):
                name = f"layer{si + 1}_block{bi}"
                self.add_module(name, block_cls(cin, w, s if bi == 0 else 1, d, norm,
                                                dilated_conv=dilated_conv,
                                                use_kernels=use_kernels, device=device,
                                                dtype=dtype))
                self.block_names.append(name)
                cin = w * block_cls.expansion
        self.out_channels = cin

    def forward(self, x):
        x = x.to(self.dtype)
        if self.stem == "fused7":
            inv, shift = self.bn.folded()
            plain = not self.use_kernels or x.device.type == "cpu"
            x = fused_stem(x, self.conv1.weight, inv, shift, plain=plain,
                           packed=None if plain else self._stem_packed(self.conv1.weight, x.dtype))
        else:
            x = torch.relu(self.bn(self.conv1(x)))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x
