"""Pileup network, the counterpart of ``clair3_tpu/models/pileup.py``.

Input ``[B, 33, 18]`` integer pileup counts.  Two stacked bidirectional
LSTMs (128, 160), flatten, Dense-128 trunk, and 2 or 4 head branches, each
applying SELU to its logits before softmax (a quirk of the trained
reference checkpoints).  Output ``[B, 24]`` or ``[B, 90]`` float32.

Parameters are kept in float32 and cast to ``compute_dtype`` at use, as
flax's ``param_dtype``/``dtype`` split does.  With ``use_kernel`` the whole
net runs through ``ops.pileup_full.pileup_full``: the CUDA kernel for a
tensor on the card, its plain twin for a tensor on the CPU; the operands are
cast and packed once per (dtype, device) and kept until a parameter changes.
The kernel has no backward, so a net in training mode takes the plain route
under autograd, with dropout after LSTM2 (0.2), L4 (0.5) and each L5 (0.2)
at the JAX net's places; its masks come from the generator passed to
``forward``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from clair3_tpu_torch.config import NO_OF_POSITIONS, PILEUP_CHANNEL_SIZE
from clair3_tpu_torch.models.layers import HEAD_NAMES, HEAD_SIZES, Dense, Dropout
from clair3_tpu_torch.ops.lstm import BiLSTM
from clair3_tpu_torch.ops.pileup_full import (PackedPileup, pack_pileup_operands,
                                              pileup_full_packed)

# eval-mode forwards that took the plain path on a CUDA tensor: a run that
# should have gone through the kernel reads 0 here
plain_cuda_forwards = 0


class PileupNet(nn.Module):
    def __init__(self, add_indel_length: bool = False,
                 input_channels: int = PILEUP_CHANNEL_SIZE,
                 lstm1_units: int = 128, lstm2_units: int = 160,
                 l4_units: int = 128, l5_units: int = 128,
                 compute_dtype: torch.dtype = torch.float32,
                 use_kernel: bool = False):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.use_kernel = use_kernel
        self._packed = None  # (key, PackedPileup) of the kernel route
        self.n_heads = 4 if add_indel_length else 2
        self.LSTM1 = BiLSTM(input_channels, lstm1_units)
        self.LSTM2 = BiLSTM(2 * lstm1_units, lstm2_units)
        self.L3_dropout = Dropout(0.2)
        self.L4 = Dense(NO_OF_POSITIONS * 2 * lstm2_units, l4_units)
        self.L4_dropout = Dropout(0.5)
        for i in range(self.n_heads):
            setattr(self, f"L5_{i + 1}", Dense(l4_units, l5_units))
            setattr(self, f"L5_{i + 1}_dropout", Dropout(0.2))
            setattr(self, HEAD_NAMES[i], Dense(l5_units, HEAD_SIZES[i]))

    def heads(self):
        """The head branches as ``((L5, logits), ...)``."""
        return tuple((getattr(self, f"L5_{i + 1}"), getattr(self, HEAD_NAMES[i]))
                     for i in range(self.n_heads))

    def kernel_operands(self):
        """The operands of ``ops.pileup_full``: ``(trunk, head_weights)``,
        with the L4 kernel reshaped to ``[T, 2*H2, D]``."""
        H2 = self.LSTM2.wh.shape[1]
        trunk = (self.LSTM1.wi, self.LSTM1.wh, self.LSTM1.b,
                 self.LSTM2.wi, self.LSTM2.wh, self.LSTM2.b,
                 self.L4.kernel.reshape(NO_OF_POSITIONS, 2 * H2, -1), self.L4.bias)
        heads = []
        for l5, out in self.heads():
            heads += [l5.kernel, l5.bias, out.kernel, out.bias]
        return trunk, tuple(heads)

    def packed_operands(self, dtype: torch.dtype, device) -> PackedPileup:
        """``ops.pileup_full.pack_pileup_operands`` of this net, packed once
        per ``(dtype, device)`` and again when a parameter is replaced or
        written in place (``load_state_dict``, ``.to``): the key holds every
        parameter's ``data_ptr`` and ``_version``."""
        key = (dtype, torch.device(device),
               tuple((p.data_ptr(), p._version) for p in self.parameters()))
        if self._packed is None or self._packed[0] != key:
            trunk, heads = self.kernel_operands()
            self._packed = (key, pack_pileup_operands(trunk, heads, dtype, device))
        return self._packed[1]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        global plain_cuda_forwards
        dt = self.compute_dtype
        if self.use_kernel and not self.training:
            return pileup_full_packed(x, self.packed_operands(dt, x.device))
        if x.is_cuda and not self.training:
            plain_cuda_forwards += 1
        x = self.L3_dropout(self.LSTM2(self.LSTM1(x.to(dt))), generator)
        x = F.selu(self.L4(x.reshape(x.shape[0], -1), dt))
        x = self.L4_dropout(x, generator)
        outs = []
        for i, (l5, out) in enumerate(self.heads()):
            drop = getattr(self, f"L5_{i + 1}_dropout")
            logits = out(drop(F.selu(l5(x, dt)), generator), dt)
            # SELU-before-softmax is baked into the trained checkpoints
            outs.append(torch.softmax(F.selu(logits.float()), dim=-1))
        return torch.cat(outs, dim=-1)
