"""The two Clair3 nets in plain PyTorch, float32, written from the published
architecture (HKU-BAL/Clair3 ``clair3/model.py``: Clair3_P and Clair3_F)
and the weight files' own layout, with no kernel, cache or batching of the
program.

Weights come from the ``.npz`` checkpoint with numpy (flax layout: Dense
``kernel [in, out]``; LSTM ``wi [C, 4H]``, ``wh [H, 4H]``, one bias ``b
[4H]``, gates input, forget, cell, output; conv ``kernel [kh, kw, I, O]``;
BatchNorm ``scale``/``bias`` and running ``mean``/``var``, eps 1e-3).  Every
fp16 leaf is widened to float32.

``quant="fp8"`` is the control: every matrix product and convolution takes
both operands rounded to float8 e4m3 with one scale per tensor (its
absolute maximum onto 448), accumulating in float32 -- the nearest
precision below the bfloat16 the configurations serve in.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

FA_NORMALIZE = 100.0
BN_EPS = 1e-3
HEADS = ("Y_gt21_logits", "Y_genotype_logits",
         "Y_indel_length_logits_1", "Y_indel_length_logits_2")


def no_tf32() -> None:
    """float32 products stay float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def load_weights(path: str) -> Dict[str, np.ndarray]:
    """The checkpoint's leaves by their '/'-joined path, as float32."""
    with np.load(path) as data:
        return {k: np.asarray(data[k], np.float32) for k in data.files}


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax().clamp_min(1e-12)
    scale = amax / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class _Net:
    def __init__(self, weights: Dict[str, np.ndarray], device="cpu",
                 quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown quant {quant!r}")
        self.q = _fp8 if quant == "fp8" else (lambda t: t)
        self.device = torch.device(device)
        self.w = {k: torch.from_numpy(v).to(self.device) for k, v in weights.items()}

    def p(self, path: str) -> torch.Tensor:
        return self.w["params/" + path]

    def dense(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return self.q(x) @ self.q(self.p(f"{name}/kernel")) + self.p(f"{name}/bias")

    def heads(self, x: torch.Tensor, n: int) -> torch.Tensor:
        outs = []
        for i in range(n):
            h = F.selu(self.dense(x, f"L5_{i + 1}"))
            logits = self.dense(h, HEADS[i])
            outs.append(torch.softmax(F.selu(logits), dim=-1))
        return torch.cat(outs, dim=-1)


class PileupRef(_Net):
    """Clair3_P: BiLSTM 128, BiLSTM 160, flatten, Dense 128 (SELU), then
    per head Dense 128 (SELU) and the logits; each head's logits pass SELU
    before softmax, as the trained checkpoints expect.  ``[B, 33, 18]``
    counts in, ``[B, 24]`` probabilities out."""

    def __init__(self, weights, device="cpu", quant=None):
        super().__init__(weights, device, quant)
        self.n_heads = 4 if "params/L5_3/kernel" in weights else 2

    def _lstm_dir(self, x: torch.Tensor, name: str, reverse: bool) -> torch.Tensor:
        wi, wh, b = (self.p(f"{name}/wi"), self.p(f"{name}/wh"), self.p(f"{name}/b"))
        B, T, _ = x.shape
        H = wh.shape[0]
        xw = (self.q(x.reshape(B * T, -1)) @ self.q(wi) + b).reshape(B, T, 4 * H)
        whq = self.q(wh)
        h = torch.zeros(B, H, device=x.device)
        c = torch.zeros(B, H, device=x.device)
        out = [None] * T
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            gates = xw[:, t] + self.q(h) @ whq
            i, f, g, o = gates.chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            out[t] = h
        return torch.stack(out, dim=1)

    def _bilstm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        return torch.cat([self._lstm_dir(x, f"{name}/fwd", False),
                          self._lstm_dir(x, f"{name}/bwd", True)], dim=-1)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.device, torch.float32)
        x = self._bilstm(self._bilstm(x, "LSTM1"), "LSTM2")
        x = F.selu(self.dense(x.reshape(x.shape[0], -1), "L4"))
        return self.heads(x, self.n_heads)


class FullAlignmentRef(_Net):
    """Clair3_F: ``[B, depth, 33, C]`` int8 matrices divided by 100; conv
    3x3 stride 2 to 64, 128 and 256 channels, each with BatchNorm and ReLU
    and followed by one residual block (two conv-BN, identity shortcut);
    a spatial pyramid max-pool of 3x3, 2x2 and 1x1 cells; Dense 256 (SELU);
    four heads as in the pileup net.  ``[B, 90]`` probabilities out."""

    def conv(self, x: torch.Tensor, name: str, stride: int = 1) -> torch.Tensor:
        w = self.p(f"{name}/kernel").permute(3, 2, 0, 1)
        return F.conv2d(self.q(x), self.q(w), self.p(f"{name}/bias"),
                        stride=stride, padding=1)

    def bn(self, x: torch.Tensor, name: str) -> torch.Tensor:
        mean = self.w[f"batch_stats/{name}/mean"].view(1, -1, 1, 1)
        var = self.w[f"batch_stats/{name}/var"].view(1, -1, 1, 1)
        scale = self.p(f"{name}/scale").view(1, -1, 1, 1)
        bias = self.p(f"{name}/bias").view(1, -1, 1, 1)
        return (x - mean) * torch.rsqrt(var + BN_EPS) * scale + bias

    def conv_bn_relu(self, x, name, stride):
        return F.relu(self.bn(self.conv(x, f"{name}/conv", stride), f"{name}/bn"))

    def res_block(self, x, name):
        y = F.relu(self.bn(self.conv(x, f"{name}/conv1"), f"{name}/bn1"))
        y = self.bn(self.conv(y, f"{name}/conv2"), f"{name}/bn2")
        return F.relu(x + y)

    @staticmethod
    def pyramid_pool(x: torch.Tensor) -> torch.Tensor:
        """Max over a 3x3, a 2x2 and a 1x1 grid of equal cells
        (ceil(dim / cells) wide, zero-padded evenly; inputs are >= 0),
        each level flattened cell by cell with the channels last."""
        B, C, H, W = x.shape
        levels = []
        for cells in (3, 2, 1):
            wh, ww = math.ceil(H / cells), math.ceil(W / cells)
            ph = math.ceil(H / wh) * wh - H
            pw = math.ceil(W / ww) * ww - W
            xp = F.pad(x, (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
            m = F.max_pool2d(xp, kernel_size=(wh, ww), stride=(wh, ww))
            levels.append(m.permute(0, 2, 3, 1).reshape(B, -1))
        return torch.cat(levels, dim=1)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = (x.to(self.device, torch.float32) / FA_NORMALIZE).permute(0, 3, 1, 2)
        x = self.conv_bn_relu(x, "conv1", 2)
        x = self.res_block(x, "res_block1")
        x = self.conv_bn_relu(x, "conv3", 2)
        x = self.res_block(x, "res_block2")
        x = self.conv_bn_relu(x, "conv5", 2)
        x = self.res_block(x, "res_block3")
        x = F.selu(self.dense(self.pyramid_pool(x), "L4"))
        return self.heads(x, 4)


def run_blocks(net, x: np.ndarray, block: int = 2048) -> np.ndarray:
    """``net`` over ``x`` in blocks of rows, as float32 numpy."""
    if len(x) == 0:
        return np.zeros((0, 90 if isinstance(net, FullAlignmentRef) else 24), np.float32)
    outs = []
    for lo in range(0, len(x), block):
        outs.append(net(torch.from_numpy(np.ascontiguousarray(x[lo: lo + block])))
                    .float().cpu().numpy())
    return np.concatenate(outs)
