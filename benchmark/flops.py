"""Operations and bytes of the two Clair3 nets per candidate row, worked
out from the shapes in a configuration's ``architecture``, and the
published peaks of one NVIDIA H100 SXM (dense, no sparsity, at 700 W).

A multiply-add counts 2 operations.  Counted: every matrix product and
convolution (the LSTM's input projections and recurrent products for both
directions, the dense layers and the heads).  Not counted: activations,
gate arithmetic, BatchNorm, pooling and softmax, which add well under 1%.
Bytes: each row's input read once at its wire width (pileup int16, full
alignment int8, at the full matrix depth the net computes on) and its
probabilities written once as float32; the weights, read once per forward
call at bfloat16, are counted per call (``weight_bytes``).
"""

from __future__ import annotations

from typing import Dict

PEAK_BF16_FLOPS = 989e12   # dense bf16 tensor-core rate
PEAK_HBM_BYTES = 3.35e12   # HBM3 bandwidth
WEIGHT_BYTES = 2           # bf16

HEAD_SIZES = (21, 3, 33, 33)


def _heads(width: int, l5: int, n_heads: int) -> int:
    return sum(2 * width * l5 + 2 * l5 * HEAD_SIZES[i] for i in range(n_heads))


def _head_params(width: int, l5: int, n_heads: int) -> int:
    return sum(width * l5 + l5 + l5 * HEAD_SIZES[i] + HEAD_SIZES[i]
               for i in range(n_heads))


def lstm_flops(T: int, C: int, H: int) -> int:
    """One bidirectional LSTM layer over T steps: per direction the input
    projection (C -> 4H) and the recurrent product (H -> 4H) at each step."""
    return 2 * T * (2 * C * 4 * H + 2 * H * 4 * H)


def pileup(arch: Dict) -> Dict[str, float]:
    T, C = arch["positions"], arch["pileup_channels"]
    H1, H2 = arch["lstm_units"]
    D, L5 = arch["pileup_dense"], arch["head_dense"]
    n_heads = arch["pileup_heads"]
    flops = (lstm_flops(T, C, H1) + lstm_flops(T, 2 * H1, H2)
             + 2 * T * 2 * H2 * D + _heads(D, L5, n_heads))
    params = (2 * (C * 4 * H1 + H1 * 4 * H1 + 4 * H1)
              + 2 * (2 * H1 * 4 * H2 + H2 * 4 * H2 + 4 * H2)
              + T * 2 * H2 * D + D + _head_params(D, L5, n_heads))
    out = sum(HEAD_SIZES[:n_heads])
    return {"flops_per_row": float(flops),
            "bytes_per_row": float(T * C * 2 + out * 4),
            "weight_bytes": float(params * WEIGHT_BYTES)}


def _conv_out(n: int) -> int:
    return (n + 1) // 2  # 3x3, stride 2, padding 1


def full_alignment(arch: Dict) -> Dict[str, float]:
    H, W, C = arch["matrix_depth"], arch["positions"], arch["fa_channels"]
    flops = 0
    params = 0
    cin = C
    for cout in arch["conv_channels"]:
        H, W = _conv_out(H), _conv_out(W)
        flops += 2 * H * W * cout * 9 * cin           # strided conv
        flops += 2 * (2 * H * W * cout * 9 * cout)    # residual block
        params += (9 * cin * cout + cout) + 2 * (9 * cout * cout + cout) + 12 * cout
        cin = cout
    pooled = sum(c * c for c in arch["pyramid_cells"]) * cin
    D, L5 = arch["fa_dense"], arch["head_dense"]
    flops += 2 * pooled * D + _heads(D, L5, 4)
    params += pooled * D + D + _head_params(D, L5, 4)
    return {"flops_per_row": float(flops),
            "bytes_per_row": float(arch["matrix_depth"] * arch["positions"] * C + 90 * 4),
            "weight_bytes": float(params * WEIGHT_BYTES)}


def nets(arch: Dict) -> Dict[str, Dict[str, float]]:
    return {"pileup": pileup(arch), "fa": full_alignment(arch)}


def least_seconds(rows: int, calls: int, counts: Dict[str, float]) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over the HBM bandwidth."""
    flops = rows * counts["flops_per_row"]
    nbytes = rows * counts["bytes_per_row"] + calls * counts["weight_bytes"]
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
