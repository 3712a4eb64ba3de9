"""Plain bidirectional LSTM, in the fused form of ``clair3_tpu/ops/lstm.py``.

Parameter layout (the JAX layout, kept so the weight bridge is a copy and
the pileup kernel reads the same tensors): ``wi [2, C, 4H]``,
``wh [2, H, 4H]``, one folded bias ``b [2, 4H]``; slot 0 is the forward
direction, slot 1 the backward one; gate order input, forget, cell, output.
"""

from __future__ import annotations

import torch
from torch import nn

from clair3_tpu_torch.ops.bilstm import batch_major, bilstm_batch_major


def _project(x: torch.Tensor, wi: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One input projection for both directions, stacked as the recurrence
    walks them: ``[T, 2, B, 4H]``, slot 1 reversed in time."""
    H4 = wi.shape[-1]
    xw = x @ torch.cat([wi[0], wi[1]], dim=1)                 # [B, T, 8H]
    xw_f = (xw[..., :H4] + b[0]).transpose(0, 1)               # [T, B, 4H]
    xw_b = (xw[..., H4:] + b[1]).transpose(0, 1).flip(0)       # backward walk
    return torch.stack([xw_f, xw_b], dim=1)


def bilstm(x: torch.Tensor, wi: torch.Tensor, wh: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """Both directions in one loop over ``[B, T, C]``: step t advances the
    forward direction at time t and the backward one at time T-1-t, with the
    two recurrent products batched.  Everything runs in ``x.dtype``, as the
    JAX scan does.  Returns ``[B, T, 2H]`` in torch order."""
    dt = x.dtype
    wi, wh, b = wi.to(dt), wh.to(dt), b.to(dt)
    xw = _project(x, wi, b)
    _, _, B, H4 = xw.shape
    h = torch.zeros(2, B, H4 // 4, dtype=dt, device=x.device)
    c = torch.zeros_like(h)
    hs = []
    for x_t in xw:
        gates = x_t + torch.bmm(h, wh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return batch_major(torch.stack(hs))


class BiLSTM(nn.Module):
    """Bidirectional LSTM layer ``[B, T, C] -> [B, T, 2H]``.  With
    ``use_kernel`` the recurrence runs through ``ops.bilstm`` (the CUDA
    kernel on the card, its plain twin on the CPU), as the JAX
    ``BiLSTM(use_pallas=True)`` does; inference only.  That route is one
    ``addmm`` (both directions' projections, bias folded in, ``[B, T, 8H]``)
    and one kernel launch that reads it and writes ``[B, T, 2H]`` in place
    by strides."""

    def __init__(self, input_size: int, hidden: int, use_kernel: bool = False):
        super().__init__()
        self.use_kernel = use_kernel
        self.wi = nn.Parameter(torch.zeros(2, input_size, 4 * hidden))
        self.wh = nn.Parameter(torch.zeros(2, hidden, 4 * hidden))
        self.b = nn.Parameter(torch.zeros(2, 4 * hidden))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.use_kernel:
            return bilstm(x, self.wi, self.wh, self.b)
        dt = x.dtype
        B, T, C = x.shape
        wi = self.wi.to(dt)
        xw = torch.addmm(self.b.to(dt).reshape(-1), x.reshape(B * T, C),
                         torch.cat([wi[0], wi[1]], dim=1))
        return bilstm_batch_major(xw.view(B, T, -1), self.wh.to(dt))
