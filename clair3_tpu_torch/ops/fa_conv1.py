"""The full-alignment net's first ConvBNRelu as one kernel: wrapper and
plain twin.

Counterpart of ``clair3_tpu/ops/pallas_fa.py::fa_conv1_pallas``:
``relu(BN(conv3x3/s2/p1(x / norm) + bias))`` on the raw int8
``[B, D, W, C]`` tensor, inference only.  The /norm, the conv bias and the
BatchNorm affine fold into one weight tensor and one bias vector, in the
Pallas kernel's order and with its rounding points:

* fold in float32; round ``w_eff`` to the compute dtype;
* cast the int8 input to the compute dtype (exact);
* sum the products in float32; add ``b_eff`` in float32; ReLU;
* round once to the compute dtype.

The TPU kernel phrases the convolution as a banded matmul, an 11x FLOP
premium that suits the TPU's matrix unit (``pallas_fa.py:1-17``).  The
CUDA kernels (``csrc/fa_conv1.cu``) do not: at bf16 an implicit GEMM on
the tensor cores, ``out^T[F, pixels] = pack_weights(w_eff)^T . im2col(x)^T``
with K in the order ``im2col`` gives (two functions here that the CPU
tests hold against the twin); at f32 the direct 3x3/stride-2 convolution.

``fa_conv1`` takes a tensor on the CPU to the plain twin and launches the
kernel for a tensor on the card; nothing falls back.  Both return the
JAX layout ``[B, ceil(D/2), ceil(W/2), F]`` as a view of NCHW memory, so
``.permute(0, 3, 1, 2)`` hands the net a contiguous NCHW tensor.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# kernel launches by fa_conv1 (plain CPU calls do not count)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def fold_bn(kernel, bias, gamma, beta, mean, var, eps: float, norm: float,
            compute_dtype: torch.dtype):
    """``(w_eff [3, 3, C, F]`` in the compute dtype, ``b_eff [F]`` float32),
    as ``pallas_fa.py:124-128`` folds them."""
    inv_std = gamma.float() * torch.rsqrt(var.float() + eps)
    w_eff = (kernel.float() * (inv_std / norm)).to(compute_dtype)
    b_eff = beta.float() + (bias.float() - mean.float()) * inv_std
    return w_eff, b_eff


def fa_conv1_reference(x, kernel, bias, gamma, beta, mean, var, eps: float = 1e-3,
                       norm: float = 100.0, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The plain twin: ``F.conv2d`` in float32 on the rounded operands."""
    w_eff, b_eff = fold_bn(kernel, bias, gamma, beta, mean, var, eps, norm, compute_dtype)
    xin = x.to(compute_dtype).float().permute(0, 3, 1, 2)
    y = F.conv2d(xin, w_eff.float().permute(3, 2, 0, 1), stride=2, padding=1)
    y = F.relu(y + b_eff.view(1, -1, 1, 1))
    return y.to(compute_dtype).permute(0, 2, 3, 1)


def pack_weights(w_eff: torch.Tensor) -> torch.Tensor:
    """``w_eff [3, 3, C, F]`` (C = 8 or 9) as the ``[K, F]`` matrix the bf16
    kernel reads, rows in ``im2col``'s K order: taps ``3*dy + dx`` 0..9 (tap
    9 zero) x channels 0..7, then for C = 9 channel 8 of taps 0..15 (taps
    9..15 zero).  K = 80 or 96, a multiple of the mma's k16."""
    C, Fo = w_eff.shape[2], w_eff.shape[3]
    if C not in (8, 9):
        raise ValueError(f"fa_conv1: the bf16 kernel takes 8 or 9 channels, got {C}")
    w = w_eff.reshape(9, C, Fo)
    main = w.new_zeros(10, 8, Fo)
    main[:9] = w[:, :8]
    rows = [main.reshape(80, Fo)]
    if C == 9:
        extra = w.new_zeros(16, Fo)
        extra[:9] = w[:, 8]
        rows.append(extra)
    return torch.cat(rows).contiguous()


def im2col(x: torch.Tensor) -> torch.Tensor:
    """``x [B, D, W, C]`` (C = 8 or 9) as ``[B, ceil(D/2), ceil(W/2), K]``
    float32 patches of the 3x3/stride-2/pad-1 window, in the K order of
    ``pack_weights``: ``im2col(x) @ pack_weights(w_eff)`` is the conv."""
    B, D, W, C = x.shape
    dout, wout = -(-D // 2), -(-W // 2)
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    taps = torch.stack([xp[:, dy: dy + 2 * dout - 1: 2, dx: dx + 2 * wout - 1: 2]
                        for dy in range(3) for dx in range(3)], dim=3)  # [.., 9, C]
    cols = [F.pad(taps[..., :8], (0, 0, 0, 1)).flatten(-2)]
    if C == 9:
        cols.append(F.pad(taps[..., 8], (0, 7)))
    return torch.cat(cols, dim=-1)


def prepare(kernel, bias, gamma, beta, mean, var, eps: float = 1e-3, norm: float = 100.0,
            compute_dtype=torch.bfloat16):
    """The kernel's weight operands: ``(w, b_eff)``, with ``w`` the packed
    ``[K, F]`` bf16 matrix at bf16 and ``w_eff [3, 3, C, F]`` at f32."""
    w_eff, b_eff = fold_bn(kernel, bias, gamma, beta, mean, var, eps, norm, compute_dtype)
    if compute_dtype == torch.bfloat16:
        w_eff = pack_weights(w_eff)
    return w_eff, b_eff


def fa_conv1_prepared(x, w, b_eff, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Launch the kernel on ``prepare``'s operands (CUDA tensors only)."""
    global launches
    from clair3_tpu_torch.ops._build import check, load_library

    dt = compute_dtype
    if dt not in _DTYPE_CODE:
        raise ValueError(f"fa_conv1 kernel: unsupported compute dtype {dt}")
    dev = x.device
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"fa_conv1 kernel: x must be int8 [B, D, W, C], got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, D, W, C = x.shape
    Fo = b_eff.shape[0]
    want = (3, 3, C, Fo) if dt == torch.float32 else (80 if C == 8 else 96, 64)
    if tuple(w.shape) != want or w.dtype != dt or b_eff.shape != (Fo,):
        raise ValueError(f"fa_conv1 kernel: weights {w.dtype} {tuple(w.shape)} / bias "
                         f"{tuple(b_eff.shape)} do not fit x {tuple(x.shape)} at {dt}")
    for t in (w, b_eff):
        if t.device != dev:
            raise ValueError(f"fa_conv1 kernel: operand on {t.device}, input on {dev}")
    dout, wout = -(-D // 2), -(-W // 2)
    out = torch.empty(B, Fo, dout, wout, dtype=dt, device=dev)
    if B > 0:
        x, w, b_eff = x.contiguous(), w.contiguous(), b_eff.float().contiguous()
        if x.data_ptr() % 16:  # the bf16 kernel stages 16-byte chunks
            x = x.clone()
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        rc = load_library().clair3t_fa_conv1(
            _DTYPE_CODE[dt], dev.index if dev.index is not None else torch.cuda.current_device(),
            ptr(x), ptr(w), ptr(b_eff), ptr(out), B, D, W, C, Fo,
            ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
        check(rc, "fa_conv1")
        launches += 1
    return out.permute(0, 2, 3, 1)


def fa_conv1(x, kernel, bias, gamma, beta, mean, var, eps: float = 1e-3,
             norm: float = 100.0, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """``x [B, D, W, C]`` int8; ``kernel [3, 3, C, F]``; conv ``bias``, BN
    ``gamma``/``beta``/``mean``/``var`` ``[F]``.  Returns
    ``[B, ceil(D/2), ceil(W/2), F]`` in the compute dtype."""
    if x.device.type == "cpu":
        return fa_conv1_reference(x, kernel, bias, gamma, beta, mean, var, eps=eps,
                                  norm=norm, compute_dtype=compute_dtype)
    w, b_eff = prepare(kernel, bias, gamma, beta, mean, var, eps, norm, compute_dtype)
    return fa_conv1_prepared(x, w, b_eff, compute_dtype)
