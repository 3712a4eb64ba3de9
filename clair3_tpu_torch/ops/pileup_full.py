"""The whole pileup net as one kernel: wrapper and plain twins.

Counterpart of ``clair3_tpu/ops/pallas_pileup.py`` (``pileup_full_pallas``,
``pileup_trunk_pallas``).  The CUDA kernel is ``csrc/pileup_full.cu``; the
plain versions below compute the same function with the same rounding
points:

* the input counts are cast to the compute dtype;
* every product accumulates in float32;
* the LSTM h and c states are stored in the compute dtype after each step;
* the heads round to the compute dtype where the Pallas kernel does
  (``pallas_pileup.py:176-187``).

``pileup_full`` and ``pileup_trunk`` take a tensor on the CPU to the plain
version and launch the kernel for a tensor on the card; nothing falls back.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

# kernel launches by pileup_full/pileup_trunk (plain CPU calls do not count)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEADS = 4


def _round(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Round a float32 tensor to the compute dtype and widen it back."""
    return v.to(dt).float()


def _lstm_step(gates: torch.Tensor, c: torch.Tensor, dt: torch.dtype):
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(dt), c_new.to(dt)


def pileup_trunk_reference(x, wi1, wh1, b1, wi2, wh2, b2, wd, bd,
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Post-SELU Dense-D trunk ``[B, D]`` in float32 (values rounded as the
    kernel stores them), mirroring ``pallas_pileup._trunk_compute``."""
    dt = compute_dtype
    f = lambda w: w.to(dt).float()  # noqa: E731 - operand as the kernel reads it
    x = f(x)
    B, T, _ = x.shape
    H1, H2 = wh1.shape[1], wh2.shape[1]
    wi1, wh1, b1, wi2, wh2, b2, wd, bd = map(
        f, (wi1, wh1, b1, wi2, wh2, b2, wd, bd))

    h = torch.zeros(2, B, H1, dtype=dt, device=x.device)
    c = torch.zeros_like(h)
    h1_seq = torch.empty(T, B, 2 * H1, dtype=dt, device=x.device)
    for t in range(T):
        x2 = torch.stack([x[:, t], x[:, T - 1 - t]])        # [2, B, C]
        gates = (torch.bmm(x2, wi1) + torch.bmm(h.float(), wh1)
                 + b1[:, None, :])
        h, c = _lstm_step(gates, c, dt)
        h1_seq[t, :, :H1] = h[0]
        h1_seq[T - 1 - t, :, H1:] = h[1]

    h = torch.zeros(2, B, H2, dtype=dt, device=x.device)
    c = torch.zeros_like(h)
    acc = torch.zeros(B, wd.shape[-1], device=x.device)
    for t in range(T):
        x2 = torch.stack([h1_seq[t], h1_seq[T - 1 - t]]).float()
        gates = (torch.bmm(x2, wi2) + torch.bmm(h.float(), wh2)
                 + b2[:, None, :])
        h, c = _lstm_step(gates, c, dt)
        # flatten order of reshape(B, T*2H2): row t*2H2+j of the dense
        # multiplies h_fwd(t) for j < H2 and h_bwd(t) for j >= H2
        acc = acc + h[0].float() @ wd[t, :H2] + h[1].float() @ wd[T - 1 - t, H2:]
    return F.selu(acc + bd)


def pileup_full_reference(x, wi1, wh1, b1, wi2, wh2, b2, wd, bd,
                          head_weights: Sequence[torch.Tensor],
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Probabilities ``[B, sum(head dims)]`` float32, mirroring
    ``pallas_pileup._make_full_kernel``."""
    dt = compute_dtype
    trunk = _round(pileup_trunk_reference(x, wi1, wh1, b1, wi2, wh2, b2, wd,
                                          bd, compute_dtype=dt), dt)
    probs = []
    for i in range(len(head_weights) // 4):
        w5, b5, wo, bo = (w.to(dt).float() for w in head_weights[4 * i: 4 * i + 4])
        h = _round(F.selu(_round(trunk @ w5 + b5, dt)), dt)
        logits = _round(h @ wo + bo, dt)
        probs.append(torch.softmax(F.selu(logits), dim=-1))
    return torch.cat(probs, dim=-1)


def _launch(x, trunk_weights, head_weights, dt):
    """Prepare operands, allocate the output and scratch, launch the kernel."""
    global launches
    from clair3_tpu_torch.ops._build import check, load_library

    if dt not in _DTYPE_CODE:
        raise ValueError(f"pileup kernel: unsupported compute dtype {dt}")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"pileup kernel: input on {dev}, expected a CUDA device")
    ops = [w.to(dt).contiguous() for w in (x,) + tuple(trunk_weights)]
    x, wi1, wh1, b1, wi2, wh2, b2, wd, bd = ops
    B, T, C = x.shape
    H1, H2, D = wh1.shape[1], wh2.shape[1], wd.shape[-1]
    expect = {"wi1": (2, C, 4 * H1), "wh1": (2, H1, 4 * H1), "b1": (2, 4 * H1),
              "wi2": (2, 2 * H1, 4 * H2), "wh2": (2, H2, 4 * H2),
              "b2": (2, 4 * H2), "wd": (T, 2 * H2, D), "bd": (D,)}
    for name, w in zip(expect, ops[1:]):
        if tuple(w.shape) != expect[name]:
            raise ValueError(f"pileup kernel: {name} has shape "
                             f"{tuple(w.shape)}, expected {expect[name]}")

    n_heads = len(head_weights) // 4
    if len(head_weights) % 4 or n_heads > _MAX_HEADS:
        raise ValueError("pileup kernel: head_weights must be (w5, b5, wo, bo)"
                         f" for at most {_MAX_HEADS} heads")
    L5 = head_weights[0].shape[1] if n_heads else 1
    dims = [int(head_weights[4 * i + 3].shape[0]) for i in range(n_heads)]
    offsets = [sum(dims[:i]) for i in range(_MAX_HEADS + 1)]
    if n_heads:
        w5 = torch.stack([head_weights[4 * i] for i in range(n_heads)])
        b5 = torch.stack([head_weights[4 * i + 1] for i in range(n_heads)])
        wo = torch.cat([head_weights[4 * i + 2] for i in range(n_heads)], dim=1)
        bo = torch.cat([head_weights[4 * i + 3] for i in range(n_heads)])
        w5, b5, wo, bo = (w.to(dev, dt).contiguous() for w in (w5, b5, wo, bo))
        if (tuple(w5.shape) != (n_heads, D, L5) or tuple(b5.shape) != (n_heads, L5)
                or tuple(wo.shape) != (L5, offsets[n_heads])):
            raise ValueError("pileup kernel: head weight shapes do not chain "
                             f"({tuple(w5.shape)}, {tuple(b5.shape)}, {tuple(wo.shape)})")
        out = torch.empty(B, offsets[n_heads], dtype=torch.float32, device=dev)
    else:
        w5 = b5 = wo = bo = None
        out = torch.empty(B, D, dtype=dt, device=dev)
    for w in ops + [w for w in (w5, b5, wo, bo) if w is not None]:
        if w.device != dev:
            raise ValueError(f"pileup kernel: operand on {w.device}, input on {dev}")
    if B == 0:
        return out
    h1_seq = torch.empty(T, B, 2 * H1, dtype=dt, device=dev)

    ptr = lambda t: ctypes.c_void_p(t.data_ptr() if t is not None else 0)  # noqa: E731
    lib = load_library()
    rc = lib.clair3t_pileup_full(
        _DTYPE_CODE[dt], dev.index if dev.index is not None else torch.cuda.current_device(),
        *(ptr(t) for t in (x, wi1, wh1, b1, wi2, wh2, b2, wd, bd, w5, b5, wo, bo,
                           h1_seq, out)),
        B, T, C, H1, H2, D, L5, n_heads, *offsets,
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    check(rc, "pileup_full")
    launches += 1
    return out


def pileup_full(x, wi1, wh1, b1, wi2, wh2, b2, wd, bd,
                head_weights: Sequence[torch.Tensor],
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The whole pileup net: ``x [B, T, C]`` counts to probabilities
    ``[B, sum(head dims)]`` float32.  ``wd`` is the L4 kernel reshaped to
    ``[T, 2*H2, D]``; ``head_weights`` is ``(w5, b5, wo, bo)`` per head."""
    trunk = (wi1, wh1, b1, wi2, wh2, b2, wd, bd)
    if x.device.type == "cpu":
        return pileup_full_reference(x, *trunk, head_weights,
                                     compute_dtype=compute_dtype)
    return _launch(x, trunk, tuple(head_weights), compute_dtype)


def pileup_trunk(x, wi1, wh1, b1, wi2, wh2, b2, wd, bd,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The trunk only: post-SELU ``[B, D]`` in the compute dtype (the
    kernel's ``n_heads = 0`` mode)."""
    trunk = (wi1, wh1, b1, wi2, wh2, b2, wd, bd)
    if x.device.type == "cpu":
        return pileup_trunk_reference(x, *trunk,
                                      compute_dtype=compute_dtype).to(compute_dtype)
    return _launch(x, trunk, (), compute_dtype)
