"""Plain bidirectional LSTM, in the fused form of ``clair3_tpu/ops/lstm.py``.

Parameter layout (the JAX layout, kept so the weight bridge is a copy and
the pileup kernel reads the same tensors): ``wi [2, C, 4H]``,
``wh [2, H, 4H]``, one folded bias ``b [2, 4H]``; slot 0 is the forward
direction, slot 1 the backward one; gate order input, forget, cell, output.
"""

from __future__ import annotations

import torch
from torch import nn


def bilstm(x: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """Both directions in one loop over ``[B, T, C]``: step t advances the
    forward direction at time t and the backward one at time T-1-t, with the
    two recurrent products batched.  Everything runs in ``x.dtype``, as the
    JAX scan does.  Returns ``[B, T, 2H]`` in torch order
    (``[h_fwd(t); h_bwd(t)]``)."""
    B, T, C = x.shape
    H = wh.shape[1]
    dt = x.dtype
    wi, wh, b = wi.to(dt), wh.to(dt), b.to(dt)
    # one input projection for both directions: [B, T, 8H]
    xw = x @ torch.cat([wi[0], wi[1]], dim=1)
    xw_f = (xw[..., :4 * H] + b[0]).transpose(0, 1)          # [T, B, 4H]
    xw_b = (xw[..., 4 * H:] + b[1]).transpose(0, 1).flip(0)  # backward walk
    h = torch.zeros(2, B, H, dtype=dt, device=x.device)
    c = torch.zeros(2, B, H, dtype=dt, device=x.device)
    hs = []
    for t in range(T):
        gates = torch.stack([xw_f[t], xw_b[t]]) + torch.bmm(h, wh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    hs = torch.stack(hs)                       # [T, 2, B, H]
    fwd = hs[:, 0].transpose(0, 1)             # [B, T, H]
    bwd = hs[:, 1].flip(0).transpose(0, 1)     # un-reverse the backward walk
    return torch.cat([fwd, bwd], dim=-1)


class BiLSTM(nn.Module):
    """Bidirectional LSTM layer ``[B, T, C] -> [B, T, 2H]``."""

    def __init__(self, input_size: int, hidden: int):
        super().__init__()
        self.wi = nn.Parameter(torch.zeros(2, input_size, 4 * hidden))
        self.wh = nn.Parameter(torch.zeros(2, hidden, 4 * hidden))
        self.b = nn.Parameter(torch.zeros(2, 4 * hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return bilstm(x, self.wi, self.wh, self.b)
