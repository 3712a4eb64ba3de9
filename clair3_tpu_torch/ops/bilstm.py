"""One bidirectional LSTM layer's recurrence as one kernel: wrappers and
plain twins.

Counterpart of ``clair3_tpu/ops/pallas_lstm.py::bilstm_pallas``.  Rounding
points of ``pallas_lstm._kernel``: float32 gate sums of ``x_t + h @ wh``;
c, then h from the rounded c, stored in the input dtype after every step.
Two layouts, one kernel (``csrc/bilstm.cu``, which takes strides):

* ``bilstm_recurrence``: the TPU layout, ``xw [T, 2, B, 4H]`` with slot 1
  already reversed in time -> ``hs [T, 2, B, H]`` with slot 1 still
  reversed;
* ``bilstm_batch_major``: ``BiLSTM``'s, ``xw [B, T, 8H]`` (both directions'
  projections side by side, in natural time) -> ``[B, T, 2H]`` in torch
  order; the kernel walks direction 1 backwards and writes it back in
  natural time, so neither side is copied.

At bf16 and ``H`` in ``TC_WIDTHS`` the kernel runs on the tensor cores and
reads ``wh`` packed by ``pack_wh_fragments``; otherwise (f32, other widths)
its SIMT route reads ``wh`` as it is.  A tensor on the CPU goes to the
plain twin, a tensor on the card to the kernel; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

# kernel launches by the wrappers (plain CPU calls do not count)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# hidden widths of the tensor-core route (the pileup net's two layers)
TC_WIDTHS = (128, 160)


def bilstm_recurrence_reference(xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """The plain twin, one batched product per step (TPU layout)."""
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


def time_major(xw: torch.Tensor) -> torch.Tensor:
    """``[B, T, 8H]`` -> the TPU layout ``[T, 2, B, 4H]``, slot 1 reversed."""
    B, T, H8 = xw.shape
    x = xw.view(B, T, 2, H8 // 2).permute(1, 2, 0, 3)
    return torch.stack([x[:, 0], x[:, 1].flip(0)], dim=1)


def batch_major(hs: torch.Tensor) -> torch.Tensor:
    """``[T, 2, B, H]`` (slot 1 reversed) -> ``[B, T, 2H]`` in torch order
    (``[h_fwd(t); h_bwd(t)]``)."""
    fwd = hs[:, 0].transpose(0, 1)
    bwd = hs[:, 1].flip(0).transpose(0, 1)     # un-reverse the backward walk
    return torch.cat([fwd, bwd], dim=-1)


def bilstm_batch_major_reference(xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """The plain twin of the batch-major layout: the TPU-layout twin on a
    permuted, flipped copy."""
    return batch_major(bilstm_recurrence_reference(time_major(xw), wh))


def pack_wh_fragments(wh: torch.Tensor, gates: int = 4) -> torch.Tensor:
    """``wh [..., K, N]`` (K a multiple of 16, N of 16 * gates) in the order
    the tensor-core kernels read it: ``[..., K/16 (k16 step), N/(16 gates)
    (warp), gates, 32 (lane), 2 (n8 tile), 4]``.  With ``N = gates * H``,
    warp w owns units ``[16w, 16w + 16)`` of every gate; its n8 tile s of
    gate q holds columns ``q*H + 16w + 8s + [0, 8)``.  Lane ``4g + p``
    holds, of k16 step kk, the mma.sync m16n8k16 B fragment of column
    ``q*H + 16w + 8s + g``: rows ``kk*16 + 2p + (0, 1, 8, 9)``, so one
    16-byte load gives it both tiles of a gate.  K2 packs ``wh [2, H, 4H]``;
    K1 also ``wi`` (K = input width) and, with ``gates=1``, its dense
    ``[T*2*H2, D]``.  One permuted copy."""
    *lead, K, N = wh.shape
    L = len(lead)
    # k = 16 kk + 8 kh + 2 p + e;  column = q H + 16 w + 8 s + g
    v = wh.reshape(*lead, K // 16, 2, 4, 2, gates, N // (16 * gates), 2, 8)  # kk kh p e q w s g
    order = [L, L + 5, L + 4, L + 7, L + 2, L + 6, L + 1, L + 3]              # kk w q g p s kh e
    packed = v.permute(*range(L), *order)
    return packed.reshape(*lead, K // 16, N // (16 * gates), gates, 32, 2, 4)


def _launch(xw, wh, hs, T: int, B: int, H: int, xs, hstr, reverse1: bool) -> torch.Tensor:
    """Launch on ``hs`` (allocated by the caller); ``xs`` and ``hstr`` are
    the (time, direction, row) element strides of ``xw`` and ``hs``."""
    global launches
    from clair3_tpu_torch.ops._build import check, load_library

    dt, dev = xw.dtype, xw.device
    if dt not in _DTYPE_CODE:
        raise ValueError(f"bilstm kernel: unsupported dtype {dt}")
    if tuple(wh.shape) != (2, H, 4 * H) or 4 * H > 1024:
        raise ValueError(f"bilstm kernel: wh {tuple(wh.shape)} is not [2, H, 4H], H <= 256")
    if wh.device != dev:
        raise ValueError(f"bilstm kernel: wh on {wh.device}, xw on {dev}")
    if xw.stride(-1) != 1:
        raise ValueError("bilstm kernel: the last dimension of xw is not contiguous")
    if T == 0 or B == 0:
        return hs
    packed = dt == torch.bfloat16 and H in TC_WIDTHS
    if packed and (xw.data_ptr() % 4 or any(s % 2 for s in xs)):
        raise ValueError("bilstm kernel: bf16 xw rows are not 4-byte aligned")
    w = pack_wh_fragments(wh.to(dt)) if packed else wh.to(dt).contiguous()
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    rc = load_library().clair3t_bilstm(
        _DTYPE_CODE[dt], dev.index if dev.index is not None else torch.cuda.current_device(),
        ptr(xw), ptr(w), ptr(hs), T, B, H, *xs, *hstr, int(reverse1), int(packed),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    check(rc, "bilstm")
    launches += 1
    return hs


def bilstm_recurrence(xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """``xw [T, 2, B, 4H]`` (slot 1 time-reversed), ``wh [2, H, 4H]`` ->
    ``hs [T, 2, B, H]`` in ``xw.dtype`` (slot 1 still reversed)."""
    if xw.device.type == "cpu":
        return bilstm_recurrence_reference(xw, wh)
    T, two, B, H4 = xw.shape
    if two != 2 or H4 % 4:
        raise ValueError(f"bilstm kernel: xw {tuple(xw.shape)} is not [T, 2, B, 4H]")
    hs = torch.empty(T, 2, B, H4 // 4, dtype=xw.dtype, device=xw.device)
    return _launch(xw, wh, hs, T, B, H4 // 4, xw.stride()[:3], hs.stride()[:3], reverse1=False)


def bilstm_batch_major(xw: torch.Tensor, wh: torch.Tensor) -> torch.Tensor:
    """``xw [B, T, 8H]`` (``[:, :, :4H]`` forward, ``[:, :, 4H:]`` backward,
    both in natural time), ``wh [2, H, 4H]`` -> ``[B, T, 2H]`` in torch
    order, in ``xw.dtype``."""
    if xw.device.type == "cpu":
        return bilstm_batch_major_reference(xw, wh)
    B, T, H8 = xw.shape
    if H8 % 8:
        raise ValueError(f"bilstm kernel: xw {tuple(xw.shape)} is not [B, T, 8H]")
    H = H8 // 8
    hs = torch.empty(B, T, 2 * H, dtype=xw.dtype, device=xw.device)
    return _launch(xw, wh, hs, T, B, H, (xw.stride(1), 4 * H, xw.stride(0)),
                   (2 * H, H, T * 2 * H), reverse1=True)
