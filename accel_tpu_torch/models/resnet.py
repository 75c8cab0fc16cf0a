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
from accel_tpu_torch.ops.fold_downscale import fold_downscale_conv
from accel_tpu_torch.ops.fused_stem import fused_stem, stem_kernel_weight
from accel_tpu_torch.ops.quant import QuantizedWeight, int8_conv2d

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


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` with running
    statistics, not ``nn.BatchNorm2d``: the batch statistics are f32 over
    (N, H, W) with flax's fast variance ``E[x^2] - E[x]^2`` (clipped at 0,
    the biased variance), the output ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias`` in f32, rounded to x's dtype.

    In ``train()`` mode the module normalizes by the batch statistics and
    keeps them aside; :meth:`commit` folds each kept pair into the running
    statistics (``0.9 * running + 0.1 * batch``, flax's momentum 0.9) once
    the step's forward passes are done, so passes in ``eval()`` mode during
    the step (the pair objective's auxiliary losses) read the statistics
    the step started from, as flax's ``model.apply`` without ``train``
    does. In ``eval()`` mode it normalizes by the running statistics."""

    def __init__(self, c: int, *, device=None):
        super().__init__()
        kw = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.ones(c, **kw))
        self.bias = nn.Parameter(torch.zeros(c, **kw))
        self.register_buffer("running_mean", torch.zeros(c, **kw))
        self.register_buffer("running_var", torch.ones(c, **kw))
        self.momentum, self.eps = 0.9, 1e-5
        self._pending: list[tuple[torch.Tensor, torch.Tensor]] = []

    def forward(self, x):
        xf = x.to(torch.float32)
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            self._pending.append((mean.detach(), var.detach()))
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) + self.bias.view(1, -1, 1, 1)
        return y.to(x.dtype)

    @torch.no_grad()
    def commit(self) -> None:
        """Fold the batch statistics kept since the last commit into the
        running statistics, in the order the passes ran."""
        for mean, var in self._pending:
            m = self.momentum
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)
        self._pending.clear()


def make_norm(norm: str, c: int, *, device=None) -> nn.Module:
    """norm: 'frozenbn' (a fixed affine from pretrained statistics),
    'batchnorm' (running statistics, flax's ``nn.BatchNorm``) or
    'groupnorm' (groups of 16 channels)."""
    if norm == "frozenbn":
        return FrozenBatchNorm(c, device=device)
    if norm == "batchnorm":
        return BatchNorm(c, device=device)
    if norm == "groupnorm":
        return GroupNorm16(c, device=device)
    raise ValueError(f"unsupported norm {norm!r} (frozenbn | batchnorm | groupnorm)")


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


class Int8Conv2d(nn.Conv2d):
    """A conv that serves through ``ops/quant.py``'s int8 conv (the GEMM on
    CUDA, the exact plain product on the CPU or with ``use_kernels=False``);
    the bias is added after it in x's dtype, as flax's ``nn.Conv`` adds it
    around its ``conv_general_dilated`` hook. Same parameters and
    ``state_dict`` keys as ``nn.Conv2d``; the quantized weights are a cache
    beside them, made once per weight version."""

    def __init__(self, *args, use_kernels=True, **kwargs):
        super().__init__(*args, **kwargs)
        self.use_kernels = use_kernels
        self._quantized = PackedWeight(QuantizedWeight)

    def forward(self, x):
        plain = not self.use_kernels or x.device.type == "cpu"
        y = int8_conv2d(x, self._quantized(self.weight), self.stride, self.padding,
                        self.dilation, plain=plain)
        if self.bias is not None:
            y = y + self.bias.view(1, -1, 1, 1)
        return y


# dilated_conv values; 's2b' and 'shift1x1' are exact rewrites of the same
# conv for the TPU (space-to-batch phases, a shifted 1x1 sum:
# accel_tpu/ops/dilated.py:83, :184) and run as the direct conv here
DILATED_CONVS = ("auto", "direct", "s2b", "shift1x1", "pallas")


def _conv(cin, cout, k, *, stride=1, dilation=1, bias=False, dilated_conv="auto",
          quantize=False, use_kernels=True, device=None, dtype=None):
    """Conv with 'same' padding, routed as ``accel_tpu``'s ``_pick_conv_fn``
    (``resnet.py:110-130``) routes it: ``quantize`` first (the int8 conv,
    ``Int8Conv2d``); then ``dilated_conv='pallas'`` sends a 3x3, stride-1
    conv with dilation > 1 to the dilated kernel; 'auto', 'direct', 's2b'
    and 'shift1x1' keep ``nn.Conv2d``."""
    pad = dilation * (k // 2)
    if quantize:
        return Int8Conv2d(cin, cout, k, stride=stride, padding=pad, dilation=dilation, bias=bias,
                          use_kernels=use_kernels, device=device, dtype=dtype)
    if dilated_conv == "pallas" and k == 3 and stride == 1 and dilation > 1:
        return DilatedConv3x3(cin, cout, dilation, bias=bias, use_kernels=use_kernels,
                              device=device, dtype=dtype)
    return nn.Conv2d(cin, cout, k, stride=stride, padding=pad, dilation=dilation,
                     bias=bias, device=device, dtype=dtype)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, width, stride=1, dilation=1, norm="frozenbn", *,
                 dilated_conv="auto", quantize=False, use_kernels=True, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        routed = dict(device=device, dtype=dtype, dilated_conv=dilated_conv, quantize=quantize,
                      use_kernels=use_kernels)
        self.conv1 = _conv(cin, width, 3, stride=stride, dilation=dilation, **routed)
        self.bn1 = make_norm(norm, width, device=device)
        self.conv2 = _conv(width, width, 3, dilation=dilation, **routed)
        self.bn2 = make_norm(norm, width, device=device)
        if cin != width or stride != 1:
            self.downsample = _conv(cin, width, 1, stride=stride, **routed)
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
                 dilated_conv="auto", quantize=False, use_kernels=True, device=None,
                 dtype=torch.bfloat16):
        super().__init__()
        routed = dict(device=device, dtype=dtype, dilated_conv=dilated_conv, quantize=quantize,
                      use_kernels=use_kernels)
        out_ch = 4 * width
        self.conv1 = _conv(cin, width, 1, **routed)
        self.bn1 = make_norm(norm, width, device=device)
        self.conv2 = _conv(width, width, 3, stride=stride, dilation=dilation, **routed)
        self.bn2 = make_norm(norm, width, device=device)
        self.conv3 = _conv(width, out_ch, 1, **routed)
        self.bn3 = make_norm(norm, out_ch, device=device)
        if cin != out_ch or stride != 1:
            self.downsample = _conv(cin, out_ch, 1, stride=stride, **routed)
            self.ds_bn = make_norm(norm, out_ch, device=device)
        else:
            self.downsample = None

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        residual = x if self.downsample is None else self.ds_bn(self.downsample(x))
        return torch.relu(y + residual)


def space_to_depth(x: torch.Tensor, block: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, b*b*C, H/b, W/b), channel ``(dy*b + dx)*C + c``:
    ``accel_tpu``'s ``space_to_depth`` order (``F.pixel_unshuffle`` orders
    them ``c*b*b + dy*b + dx``), so the bridged ``conv1_s2d`` weights need
    no permutation."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // block, block, w // block, block)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, block * block * c, h // block, w // block)


def embed_conv7_as_s2d(w7: torch.Tensor) -> torch.Tensor:
    """A 7x7/2 stem kernel (O, C, 7, 7) embedded exactly into the
    space-to-depth form: the (O, 4C, 4, 4) stride-1 kernel over
    ``space_to_depth(x, 2)`` with padding (2, 1) (``accel_tpu``'s
    ``embed_conv7_as_s2d``, OIHW)."""
    o, c = w7.shape[:2]
    k4 = w7.new_zeros((o, 4 * c, 4, 4))
    for u in range(-3, 4):
        a, dy = (u + 4) // 2 - 2, (u + 4) % 2
        for v in range(-3, 4):
            b, dx = (v + 4) // 2 - 2, (v + 4) % 2
            k4[:, (dy * 2 + dx) * c:(dy * 2 + dx + 1) * c, a + 2, b + 2] = w7[:, :, u + 3, v + 3]
    return k4


STEMS = ("conv7", "fused7", "s2d")


class DilatedResNet(nn.Module):
    """ResNet v1 trunk with DeepLab dilation; returns the C5 feature map.

    ``stem``: 'conv7' (conv + norm + relu), 'fused7' (the same parameters
    through the fused stem kernel; frozenbn only, since the norm must fold
    into a per-channel affine) or 's2d' (``space_to_depth(x, 2)`` and a 4x4
    conv ``conv1_s2d`` padded (2, 1): an exact reparametrization of the
    7x7/2 conv, ``embed_conv7_as_s2d``). ``dilated_conv``: one of
    ``DILATED_CONVS`` (``_conv``). ``quantize``: every block conv through
    the int8 conv; the stem stays float. ``input_downscale`` > 1: the
    caller passes full-resolution frames and the factor's bilinear
    downscale is folded into ``conv1`` (``ops/fold_downscale.py``; conv7
    stem only). ``use_kernels=False`` runs the kernels' plain versions
    even on CUDA (for comparing the two)."""

    def __init__(self, depth=101, output_stride=16, norm="frozenbn", stem="conv7", *,
                 dilated_conv="auto", quantize=False, input_downscale=1, use_kernels=True,
                 device=None, dtype=torch.bfloat16):
        super().__init__()
        if dilated_conv not in DILATED_CONVS:
            raise ValueError(f"unsupported dilated_conv {dilated_conv!r} {DILATED_CONVS}")
        if stem not in STEMS:
            raise ValueError(f"unsupported stem {stem!r} {STEMS}")
        if stem == "fused7" and norm != "frozenbn":
            raise ValueError("stem='fused7' requires norm='frozenbn' "
                             "(the BN must fold to a per-channel affine)")
        if input_downscale > 1 and stem != "conv7":
            raise ValueError("input_downscale folding needs the conv7 stem")
        if output_stride not in STRIDE_PLANS:
            raise ValueError(f"bad output_stride {output_stride}")
        self.stem, self.dtype, self.use_kernels = stem, dtype, use_kernels
        self.input_downscale = input_downscale
        self._stem_packed = PackedWeight(stem_kernel_weight)
        kind, plan = STAGE_PLANS[depth]
        block_cls = BasicBlock if kind == "basic" else Bottleneck
        strides, dils = STRIDE_PLANS[output_stride]
        if stem == "s2d":
            self.conv1_s2d = nn.Conv2d(12, 64, 4, bias=False, device=device, dtype=dtype)
        else:
            self.conv1 = _conv(3, 64, 7, stride=2, device=device, dtype=dtype)
        self.bn = make_norm(norm, 64, device=device)
        self.block_names = []
        cin = 64
        for si, (n_blocks, w, s, d) in enumerate(zip(plan, (64, 128, 256, 512), strides, dils)):
            for bi in range(n_blocks):
                name = f"layer{si + 1}_block{bi}"
                self.add_module(name, block_cls(cin, w, s if bi == 0 else 1, d, norm,
                                                dilated_conv=dilated_conv, quantize=quantize,
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
            if self.input_downscale > 1:
                x = fold_downscale_conv(x, self.conv1.weight, self.input_downscale, 2, 3)
            elif self.stem == "s2d":
                x = self.conv1_s2d(F.pad(space_to_depth(x, 2), (2, 1, 2, 1)))
            else:
                x = self.conv1(x)
            x = torch.relu(self.bn(x))
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        for name in self.block_names:
            x = getattr(self, name)(x)
        return x
