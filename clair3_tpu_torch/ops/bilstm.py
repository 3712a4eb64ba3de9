"""One bidirectional LSTM layer's recurrence as one kernel: wrapper and
plain twin.

Counterpart of ``clair3_tpu/ops/pallas_lstm.py::bilstm_pallas``.  Layout
as there: ``xw [T, 2, B, 4H]`` pre-projected inputs with slot 1 already
reversed in time, ``wh [2, H, 4H]``, output ``hs [T, 2, B, H]`` with slot 1
still reversed.  Rounding points of ``pallas_lstm._kernel``: float32 gate
sums of ``x_t + h @ wh``; c, then h from the rounded c, stored in the
input dtype after every step.

``bilstm_recurrence`` takes a tensor on the CPU to the plain twin and
launches ``csrc/bilstm.cu`` for a tensor on the card; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches by bilstm_recurrence (plain CPU calls do not count)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def bilstm_recurrence_reference(xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """The plain twin, one batched product per step."""
    dt = xw.dtype
    T, _, B, H4 = xw.shape
    H = H4 // 4
    wh = wh.to(dt).float()
    h = torch.zeros(2, B, H, dtype=dt, device=xw.device)
    c = torch.zeros_like(h)
    hs = torch.empty(T, 2, B, H, dtype=dt, device=xw.device)
    for t in range(T):
        gates = xw[t].float() + torch.bmm(h.float(), wh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = (torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)).to(dt)
        h = (torch.sigmoid(o) * torch.tanh(c.float())).to(dt)
        hs[t] = h
    return hs


def _launch(xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    global launches
    from clair3_tpu_torch.ops._build import check, load_library

    dt, dev = xw.dtype, xw.device
    if dt not in _DTYPE_CODE:
        raise ValueError(f"bilstm kernel: unsupported dtype {dt}")
    T, two, B, H4 = xw.shape
    H = H4 // 4
    if two != 2 or H4 != 4 * H or tuple(wh.shape) != (2, H, H4) or 4 * H > 1024:
        raise ValueError(f"bilstm kernel: xw {tuple(xw.shape)} and wh "
                         f"{tuple(wh.shape)} are not [T, 2, B, 4H] / [2, H, 4H], H <= 256")
    if wh.device != dev:
        raise ValueError(f"bilstm kernel: wh on {wh.device}, xw on {dev}")
    hs = torch.empty(T, 2, B, H, dtype=dt, device=dev)
    if T == 0 or B == 0:
        return hs
    xw, wh = xw.contiguous(), wh.to(dt).contiguous()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    rc = load_library().clair3t_bilstm(
        _DTYPE_CODE[dt], dev.index if dev.index is not None else torch.cuda.current_device(),
        ptr(xw), ptr(wh), ptr(hs), T, B, H,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    check(rc, "bilstm")
    launches += 1
    return hs


def bilstm_recurrence(xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """``xw [T, 2, B, 4H]`` (slot 1 time-reversed), ``wh [2, H, 4H]`` ->
    ``hs [T, 2, B, H]`` in ``xw.dtype`` (slot 1 still reversed)."""
    if xw.device.type == "cpu":
        return bilstm_recurrence_reference(xw, wh)
    return _launch(xw, wh)
