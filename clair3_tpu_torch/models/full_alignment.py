"""Full-alignment network, the counterpart of
``clair3_tpu/models/full_alignment.py``.

Input ``[B, depth, 33, 8|9]`` int8 tensors (NHWC, as the extractor writes
them), divided by 100.  Three stride-2 conv stages (64/128/256), each
followed by one residual block, a spatial pyramid max-pool (3x3 + 2x2 + 1x1
cells = 14 x 256 features, flattened in NHWC order), a Dense-256 trunk and
four heads.  The convolutions run in torch's NCHW layout through
``torch.nn.functional.conv2d`` (the JAX package leaves them to XLA too);
weights keep torch's ``[O, I, kh, kw]`` layout and BatchNorm keeps flax's
four tensors, applied as an inference affine at eps 1e-3.

With ``use_kernel_conv1`` (inference only, the counterpart of the JAX
``use_pallas_conv1``) the first ConvBNRelu runs through
``ops.fa_conv1.fa_conv1`` on the same ``conv1.conv`` / ``conv1.bn``
tensors: the CUDA kernel for a tensor on the card, its plain twin for a
tensor on the CPU.  One state_dict drives both routes.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from clair3_tpu.config import FA_CHANNEL_SIZE, FA_NORMALIZE_NUM
from clair3_tpu_torch.models.layers import HEAD_NAMES, HEAD_SIZES, Dense
from clair3_tpu_torch.ops.fa_conv1 import fa_conv1

BN_EPS = 1e-3


class Conv(nn.Module):
    """3x3 convolution with bias, padding 1."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        stride=self.stride, padding=1)


class BatchNorm(nn.Module):
    """Inference BatchNorm with flax's tensors: ``scale``, ``bias`` and the
    running ``mean``/``var``; computed in float32 and cast back, as flax
    does for a low-precision ``dtype``."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mul = (torch.rsqrt(self.var.float() + BN_EPS) * self.scale.float()).view(shape)
        y = (x.float() - self.mean.float().view(shape)) * mul
        return (y + self.bias.float().view(shape)).to(x.dtype)


class ConvBNRelu(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv = Conv(cin, cout, stride)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class ResBlock(nn.Module):
    """Two 3x3 convs with BN and an identity shortcut."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = Conv(channels, channels)
        self.bn1 = BatchNorm(channels)
        self.conv2 = Conv(channels, channels)
        self.bn2 = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(x + y)


def pyramid_pool(x: torch.Tensor, pool_sizes: Sequence[int] = (3, 2, 1)) -> torch.Tensor:
    """Spatial pyramid max-pool over NCHW.  Zero-pads centred (values are
    post-ReLU, so >= 0), pools with window == stride = ceil(dim / size), and
    flattens each level in NHWC order so the L4 weights line up with the
    JAX net's."""
    B, C, H, W = x.shape
    pooled = []
    for p in pool_sizes:
        wh, ww = math.ceil(H / p), math.ceil(W / p)
        out_h, out_w = math.ceil(H / wh), math.ceil(W / ww)
        pad_h = max(out_h * wh - H, 0)
        pad_w = max(out_w * ww - W, 0)
        xp = F.pad(x, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
        m = F.max_pool2d(xp, kernel_size=(wh, ww), stride=(wh, ww))
        pooled.append(m.permute(0, 2, 3, 1).reshape(B, -1))
    return torch.cat(pooled, dim=1)


class FullAlignmentNet(nn.Module):
    def __init__(self, add_indel_length: bool = True,
                 input_channels: int = FA_CHANNEL_SIZE,
                 l4_units: int = 256, l5_units: int = 128,
                 compute_dtype: torch.dtype = torch.float32,
                 use_kernel_conv1: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.use_kernel_conv1 = use_kernel_conv1
        self.n_heads = 4 if add_indel_length else 2
        self.conv1 = ConvBNRelu(input_channels, 64, stride=2)
        self.res_block1 = ResBlock(64)
        self.conv3 = ConvBNRelu(64, 128, stride=2)
        self.res_block2 = ResBlock(128)
        self.conv5 = ConvBNRelu(128, 256, stride=2)
        self.res_block3 = ResBlock(256)
        self.L4 = Dense(14 * 256, l4_units)
        for i in range(self.n_heads):
            setattr(self, f"L5_{i + 1}", Dense(l4_units, l5_units))
            setattr(self, HEAD_NAMES[i], Dense(l5_units, HEAD_SIZES[i]))

    @property
    def input_channels(self) -> int:
        return self.conv1.conv.weight.shape[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.use_kernel_conv1 and not self.training:
            conv, bn = self.conv1.conv, self.conv1.bn
            x = fa_conv1(x, conv.weight.permute(2, 3, 1, 0), conv.bias, bn.scale,
                         bn.bias, bn.mean, bn.var, eps=BN_EPS,
                         norm=float(FA_NORMALIZE_NUM), compute_dtype=dt)
            x = x.permute(0, 3, 1, 2)  # NHWC view of NCHW memory -> NCHW
        else:
            x = self.conv1((x.to(dt) / FA_NORMALIZE_NUM).permute(0, 3, 1, 2))
        for stage in (self.res_block1, self.conv3, self.res_block2,
                      self.conv5, self.res_block3):
            x = stage(x)
        x = F.selu(self.L4(pyramid_pool(x), dt))
        outs = []
        for i in range(self.n_heads):
            l5, out = getattr(self, f"L5_{i + 1}"), getattr(self, HEAD_NAMES[i])
            logits = out(F.selu(l5(x, dt)), dt)
            # SELU-before-softmax matches the trained reference checkpoints
            outs.append(torch.softmax(F.selu(logits.float()), dim=-1))
        return torch.cat(outs, dim=-1)
