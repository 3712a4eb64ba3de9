"""Experimental full-alignment binary scorer, the counterpart of
``clair3_tpu/models/fb.py`` (reference: clair3/model.py:419-509
``Clair3_FB``).  Unused by any reference pipeline, and by the port's: kept
so the port holds every net the JAX package holds.

Input ``[B, depth, 33, C]`` int8 tensors (NHWC, as the extractor writes
them), divided by 100.  Three separable-conv stages (48/96/160: a depthwise
3x3 with ``groups=C`` and no bias, then a pointwise 1x1 with bias), each
with BatchNorm (eps 1e-3), ReLU and one residual block; a 1x1 projection to
96 with SELU, 4-head self-attention over the ``H*W`` positions (head width
24), dropout 0.2 and a residual LayerNorm (eps 1e-5); the trunk and the
attention map concatenated, global mean and max pooling, dense 128 and 96
(SELU) after dropouts 0.35 and 0.25, and a sigmoid of the logit in f32.
Output ``[B, 1]`` in (0, 1).

The parameters keep flax's layout, so ``models/bridge.py`` carries them
across: conv kernels as torch's ``[O, I/groups, kh, kw]`` under
``.weight`` (the depthwise one ``[C, 1, 3, 3]``), the attention's
``query``/``key``/``value`` kernels ``[96, 4, 24]`` with biases ``[4, 24]``
and its ``out`` kernel ``[4, 24, 96]``, LayerNorm ``scale``/``bias``, and
the BatchNorm of ``models/full_alignment.py``.  Attention is plain tensor
ops (``softmax(q k^T / sqrt(24)) v``), as flax computes it outside any
kernel; in training mode its weights take flax's dropout of 0.1.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from clair3_tpu_torch.config import FA_CHANNEL_SIZE, FA_NORMALIZE_NUM
from clair3_tpu_torch.models.full_alignment import BatchNorm
from clair3_tpu_torch.models.layers import Dense, Dropout


class _Conv(nn.Module):
    """flax ``nn.Conv`` in torch's layout: ``weight [O, I/groups, k, k]``,
    padding ``k // 2``."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
                 bias: bool = True):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, stride=self.stride,
                        padding=self.weight.shape[-1] // 2, groups=self.groups)


class SeparableConv(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.depthwise = _Conv(cin, cin, 3, stride, groups=cin, bias=False)
        self.pointwise = _Conv(cin, cout, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class SepConvBNRelu(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv = SeparableConv(cin, cout, stride)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class SepResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = SeparableConv(channels, channels)
        self.bn1 = BatchNorm(channels)
        self.conv2 = SeparableConv(channels, channels)
        self.bn2 = BatchNorm(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(x + self.bn2(self.conv2(y)))


class _HeadsDense(nn.Module):
    """flax ``DenseGeneral(features=(heads, width))``: ``kernel [in, heads,
    width]``, ``bias [heads, width]``."""

    def __init__(self, dim: int, heads: int, width: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(dim, heads, width))
        self.bias = nn.Parameter(torch.zeros(heads, width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("bld,dhk->blhk", x, self.kernel.to(x.dtype)) + self.bias.to(x.dtype)


class _OutDense(nn.Module):
    """flax ``DenseGeneral(axis=(-2, -1))``: ``kernel [heads, width, out]``."""

    def __init__(self, heads: int, width: int, dim: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(heads, width, dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("blhk,hkd->bld", x, self.kernel.to(x.dtype)) + self.bias.to(x.dtype)


class SelfAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention(num_heads)`` over ``[B, L, dim]``
    with query = key = value input."""

    def __init__(self, dim: int, heads: int, dropout_rate: float = 0.1):
        super().__init__()
        width = dim // heads
        self.query = _HeadsDense(dim, heads, width)
        self.key = _HeadsDense(dim, heads, width)
        self.value = _HeadsDense(dim, heads, width)
        self.out = _OutDense(heads, width, dim)
        self.weights_dropout = Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        q, k, v = self.query(x), self.key(x), self.value(x)
        q = q / math.sqrt(q.shape[-1])
        logits = torch.einsum("bqhk,bshk->bhqs", q, k)
        weights = self.weights_dropout(torch.softmax(logits.float(), dim=-1).to(x.dtype),
                                       generator)
        return self.out(torch.einsum("bhqs,bshk->bqhk", weights, v))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5)``: ``scale``, ``bias``; statistics in
    float32."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), x.shape[-1:], self.scale.float(), self.bias.float(),
                            eps=1e-5).to(x.dtype)


class FullAlignmentBinaryNet(nn.Module):
    """Binary variant-quality scorer: ``[B, depth, 33, C]`` -> ``[B, 1]`` in
    (0, 1)."""

    def __init__(self, input_channels: int = FA_CHANNEL_SIZE,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = SepConvBNRelu(input_channels, 48, 2)
        self.res1 = SepResBlock(48)
        self.conv2 = SepConvBNRelu(48, 96, 2)
        self.res2 = SepResBlock(96)
        self.conv3 = SepConvBNRelu(96, 160, 2)
        self.res3 = SepResBlock(160)
        self.attn_proj = _Conv(160, 96, 1)
        self.attn_mha = SelfAttention(96, 4)
        self.attn_dropout = Dropout(0.2)
        self.attn_norm = LayerNorm(96)
        self.dropout1 = Dropout(0.35)
        self.dense1 = Dense(2 * (160 + 96), 128)
        self.dropout2 = Dropout(0.25)
        self.dense2 = Dense(128, 96)
        self.logit = Dense(96, 1)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.compute_dtype
        x = (x.to(dt) / FA_NORMALIZE_NUM).permute(0, 3, 1, 2)
        for stage in (self.conv1, self.res1, self.conv2, self.res2, self.conv3, self.res3):
            x = stage(x)
        B, C, H, W = x.shape
        seq = F.selu(self.attn_proj(x)).permute(0, 2, 3, 1).reshape(B, H * W, -1)
        attn = self.attn_dropout(self.attn_mha(seq, generator), generator)
        seq = self.attn_norm(seq + attn)
        attn_map = seq.reshape(B, H, W, -1).permute(0, 3, 1, 2)
        x = torch.cat([x, attn_map], dim=1)
        pooled = torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=1)
        h = F.selu(self.dense1(self.dropout1(pooled, generator), dt))
        h = F.selu(self.dense2(self.dropout2(h, generator), dt))
        return torch.sigmoid(self.logit(h, dt).float())
