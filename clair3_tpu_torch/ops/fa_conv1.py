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
premium that suits the TPU's matrix unit (``pallas_fa.py:1-17``); the
CUDA kernel (``csrc/fa_conv1.cu``) computes the direct 3x3/stride-2
convolution instead.

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


def _launch(x, w_eff, b_eff, dt):
    global launches
    from clair3_tpu_torch.ops._build import check, load_library

    if dt not in _DTYPE_CODE:
        raise ValueError(f"fa_conv1 kernel: unsupported compute dtype {dt}")
    dev = x.device
    if x.dtype != torch.int8 or x.dim() != 4:
        raise ValueError(f"fa_conv1 kernel: x must be int8 [B, D, W, C], got "
                         f"{x.dtype} {tuple(x.shape)}")
    B, D, W, C = x.shape
    Fo = w_eff.shape[-1]
    if tuple(w_eff.shape) != (3, 3, C, Fo) or tuple(b_eff.shape) != (Fo,):
        raise ValueError(f"fa_conv1 kernel: weights {tuple(w_eff.shape)} / bias "
                         f"{tuple(b_eff.shape)} do not fit x {tuple(x.shape)}")
    for t in (w_eff, b_eff):
        if t.device != dev:
            raise ValueError(f"fa_conv1 kernel: operand on {t.device}, input on {dev}")
    dout, wout = -(-D // 2), -(-W // 2)
    out = torch.empty(B, Fo, dout, wout, dtype=dt, device=dev)
    if B > 0:
        x, w_eff, b_eff = x.contiguous(), w_eff.contiguous(), b_eff.contiguous()
        ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
        rc = load_library().clair3t_fa_conv1(
            _DTYPE_CODE[dt], dev.index if dev.index is not None else torch.cuda.current_device(),
            ptr(x), ptr(w_eff), ptr(b_eff), ptr(out), B, D, W, C, Fo,
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
    w_eff, b_eff = fold_bn(kernel, bias, gamma, beta, mean, var, eps, norm, compute_dtype)
    return _launch(x, w_eff, b_eff, compute_dtype)
