"""The whole pileup net as kernels: wrappers and plain twins.

Counterpart of ``clair3_tpu/ops/pallas_pileup.py`` (``pileup_full_pallas``,
``pileup_trunk_pallas``).  The plain versions below compute the same
function with the same rounding points:

* the input counts are cast to the compute dtype;
* every product accumulates in float32;
* the LSTM c is stored in the compute dtype after each step, h is taken
  from the unrounded c and stored in the compute dtype;
* the heads round to the compute dtype where the Pallas kernel does
  (``pallas_pileup.py:176-187``).

Two routes on the card, chosen by dtype, not by failure:

* bf16: three tensor-core launches of ``csrc/pileup_tc.cu``, each with its
  plain twin here: L1 (``pileup_l1_reference``, ``x -> h1seq [B, T,
  2*H1]``), L2 (``pileup_l2_reference``, ``h1seq -> h2seq [B, T, 2*H2]``)
  and L3 (``pileup_head_reference``, the dense as one GEMM, then the trunk
  or the heads and the softmax).  They take only the net's widths
  (``TC_WIDTHS``, ``C <= TC_MAX_C``; ``tc_route``), which every Clair3
  pileup model has; bf16 at other widths raises.  The weights are cast,
  padded and packed in mma.sync B-fragment order once, by
  ``pack_pileup_operands``;
* float32: the one SIMT kernel of ``csrc/pileup_full.cu``, at any width.

``pileup_full_packed`` and ``pileup_trunk_packed`` take packed operands
(``PileupNet`` keeps them); ``pileup_full`` and ``pileup_trunk`` pack and
then call them.  A tensor on the CPU goes to the plain version, a tensor
on the card to the kernels; nothing falls back.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from clair3_tpu_torch.ops.bilstm import pack_wh_fragments

# calls of pileup_full / pileup_trunk (and their packed forms) that launched
# kernels; plain CPU calls do not count
launches = 0
# launches of each kernel, counted where it is launched: a call launches
# pileup_full once (float32) or pileup_l1_tc, pileup_l2_tc and pileup_head
# once each (bf16)
kernel_launches = {"pileup_l1_tc": 0, "pileup_l2_tc": 0, "pileup_head": 0, "pileup_full": 0}

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HEADS = 4
# widths of the tensor-core route; C up to TC_MAX_C (zero-padded to it)
TC_WIDTHS = {"T": 33, "H1": 128, "H2": 160, "D": 128}
TC_MAX_C = 32


def tc_route(dtype: torch.dtype, C: int, T: int, H1: int, H2: int, D: int) -> bool:
    """Whether these operands run on the tensor-core launches (bf16 at the
    net's widths); float32 runs the SIMT kernel, bf16 at other widths
    raises on the card."""
    return (dtype == torch.bfloat16 and 0 < C <= TC_MAX_C
            and dict(T=T, H1=H1, H2=H2, D=D) == TC_WIDTHS)


def _round(v: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Round a float32 tensor to the compute dtype and widen it back."""
    return v.to(dt).float()


def _lstm_step(gates: torch.Tensor, c: torch.Tensor, dt: torch.dtype):
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(dt), c_new.to(dt)


def _bilstm_layer(inp, wi, wh, b, dt) -> torch.Tensor:
    """Both directions of one layer over ``inp [B, T, K]`` (float32 values
    of the compute dtype); weights already rounded.  ``[B, T, 2H]`` in torch
    order (``[h_fwd(t); h_bwd(t)]``), in ``dt``."""
    B, T, _ = inp.shape
    H = wh.shape[1]
    h = torch.zeros(2, B, H, dtype=dt, device=inp.device)
    c = torch.zeros_like(h)
    seq = torch.empty(B, T, 2 * H, dtype=dt, device=inp.device)
    for t in range(T):
        x2 = torch.stack([inp[:, t], inp[:, T - 1 - t]])     # [2, B, K]
        gates = torch.bmm(x2, wi) + torch.bmm(h.float(), wh) + b[:, None, :]
        h, c = _lstm_step(gates, c, dt)
        seq[:, t, :H] = h[0]
        seq[:, T - 1 - t, H:] = h[1]
    return seq


def pileup_l1_reference(x, wi1, wh1, b1, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Layer 1 (L1's twin): counts ``[B, T, C]`` -> ``h1seq [B, T, 2*H1]``."""
    f = lambda w: w.to(compute_dtype).float()  # noqa: E731 - operand as the kernel reads it
    return _bilstm_layer(f(x), f(wi1), f(wh1), f(b1), compute_dtype)


def pileup_l2_reference(h1seq, wi2, wh2, b2, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Layer 2 (L2's twin): ``h1seq`` -> ``h2seq [B, T, 2*H2]``."""
    f = lambda w: w.to(compute_dtype).float()  # noqa: E731
    return _bilstm_layer(f(h1seq), f(wi2), f(wh2), f(b2), compute_dtype)


def _heads_reference(trunk: torch.Tensor, head_weights, dt) -> torch.Tensor:
    """Probabilities from the trunk (float32 values of ``dt``)."""
    probs = []
    for i in range(len(head_weights) // 4):
        w5, b5, wo, bo = (w.to(dt).float() for w in head_weights[4 * i: 4 * i + 4])
        h = _round(F.selu(_round(trunk @ w5 + b5, dt)), dt)
        logits = _round(h @ wo + bo, dt)
        probs.append(torch.softmax(F.selu(logits), dim=-1))
    return torch.cat(probs, dim=-1)


def pileup_head_reference(h2seq, wd, bd, head_weights: Sequence[torch.Tensor] = (),
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """L3's twin: ``h2seq [B, T, 2*H2]`` flattened times ``wd`` as one
    product (float32 sums), ``+ bd``, SELU; with heads, probabilities
    ``[B, O]`` float32, else the trunk ``[B, D]`` in the compute dtype."""
    dt = compute_dtype
    B = h2seq.shape[0]
    D = wd.shape[-1]
    trunk = F.selu(h2seq.to(dt).float().reshape(B, -1) @ wd.to(dt).float().reshape(-1, D)
                   + bd.to(dt).float())
    if not head_weights:
        return trunk.to(dt)
    return _heads_reference(_round(trunk, dt), head_weights, dt)


def pileup_trunk_reference(x, wi1, wh1, b1, wi2, wh2, b2, wd, bd,
                           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Post-SELU Dense-D trunk ``[B, D]`` in float32 (values unrounded),
    mirroring ``pallas_pileup._trunk_compute``: the dense accumulated step
    by step, as the Pallas kernel sums it."""
    dt = compute_dtype
    h1 = pileup_l1_reference(x, wi1, wh1, b1, dt)
    h2 = pileup_l2_reference(h1, wi2, wh2, b2, dt).float()
    wd = wd.to(dt).float()
    T, H2 = h2.shape[1], wh2.shape[1]
    acc = torch.zeros(h2.shape[0], wd.shape[-1], device=h2.device)
    for t in range(T):
        # flatten order of reshape(B, T*2H2): row t*2H2+j of the dense
        # multiplies h_fwd(t) for j < H2 and h_bwd(t) for j >= H2
        acc = acc + h2[:, t, :H2] @ wd[t, :H2] + h2[:, T - 1 - t, H2:] @ wd[T - 1 - t, H2:]
    return F.selu(acc + bd.to(dt).float())


def pileup_full_reference(x, wi1, wh1, b1, wi2, wh2, b2, wd, bd,
                          head_weights: Sequence[torch.Tensor],
                          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Probabilities ``[B, sum(head dims)]`` float32, mirroring
    ``pallas_pileup._make_full_kernel``."""
    dt = compute_dtype
    trunk = _round(pileup_trunk_reference(x, wi1, wh1, b1, wi2, wh2, b2, wd,
                                          bd, compute_dtype=dt), dt)
    return _heads_reference(trunk, head_weights, dt)


@dataclass(frozen=True)
class PackedPileup:
    """The net's operands, cast to ``dtype`` on ``device`` once.

    ``trunk`` (wi1, wh1, b1, wi2, wh2, b2, wd, bd) and ``heads`` ((w5, b5,
    wo, bo) per head) as the plain versions take them; the heads also side
    by side (``w5 [NH, D, L5]``, ``b5 [NH, L5]``, ``wo [L5, O]``, ``bo
    [O]``) with their column ``offsets``.  On the tensor-core route
    (``tc``), ``frags`` holds wi1 (zero-padded to 32 rows), wh1, wi2, wh2
    and wd in B-fragment order (``pack_wh_fragments``)."""

    dtype: torch.dtype
    device: torch.device
    trunk: tuple
    heads: tuple
    stacked: Optional[tuple]
    offsets: tuple
    tc: bool
    frags: Optional[dict]

    @property
    def n_heads(self) -> int:
        return len(self.heads) // 4


def pack_pileup_operands(trunk: Sequence[torch.Tensor], heads: Sequence[torch.Tensor],
                         dtype: torch.dtype, device) -> PackedPileup:
    """Cast, check, pad and pack the net's operands for ``dtype`` on
    ``device``; ``trunk`` is ``(wi1, wh1, b1, wi2, wh2, b2, wd, bd)`` with
    ``wd [T, 2*H2, D]``, ``heads`` ``(w5, b5, wo, bo)`` per head."""
    if dtype not in _DTYPES:
        raise ValueError(f"pileup kernel: unsupported compute dtype {dtype}")
    ops = tuple(w.detach().to(device, dtype).contiguous() for w in trunk)
    device = ops[0].device  # with its index: "cuda" -> "cuda:0"
    wi1, wh1, b1, wi2, wh2, b2, wd, bd = ops
    C, H1, H2 = wi1.shape[1], wh1.shape[1], wh2.shape[1]
    T, D = wd.shape[0], wd.shape[-1]
    expect = {"wi1": (2, C, 4 * H1), "wh1": (2, H1, 4 * H1), "b1": (2, 4 * H1),
              "wi2": (2, 2 * H1, 4 * H2), "wh2": (2, H2, 4 * H2),
              "b2": (2, 4 * H2), "wd": (T, 2 * H2, D), "bd": (D,)}
    for name, w in zip(expect, ops):
        if tuple(w.shape) != expect[name]:
            raise ValueError(f"pileup kernel: {name} has shape "
                             f"{tuple(w.shape)}, expected {expect[name]}")

    n_heads = len(heads) // 4
    if len(heads) % 4 or n_heads > _MAX_HEADS:
        raise ValueError("pileup kernel: head_weights must be (w5, b5, wo, bo)"
                         f" for at most {_MAX_HEADS} heads")
    hw = tuple(w.detach().to(device, dtype).contiguous() for w in heads)
    dims = [int(hw[4 * i + 3].shape[0]) for i in range(n_heads)]
    offsets = tuple(sum(dims[:i]) for i in range(_MAX_HEADS + 1))
    stacked = None
    if n_heads:
        L5 = hw[0].shape[1]
        w5 = torch.stack(hw[0::4])
        b5 = torch.stack(hw[1::4])
        wo = torch.cat(hw[2::4], dim=1).contiguous()
        bo = torch.cat(hw[3::4])
        if (tuple(w5.shape) != (n_heads, D, L5) or tuple(b5.shape) != (n_heads, L5)
                or tuple(wo.shape) != (L5, offsets[n_heads])):
            raise ValueError("pileup kernel: head weight shapes do not chain "
                             f"({tuple(w5.shape)}, {tuple(b5.shape)}, {tuple(wo.shape)})")
        stacked = (w5, b5, wo, bo)

    tc = tc_route(dtype, C, T, H1, H2, D)
    frags = None
    if tc:
        wi1p = F.pad(wi1, (0, 0, 0, TC_MAX_C - C))          # [2, 32, 4*H1]
        frags = {"wi1": pack_wh_fragments(wi1p), "wh1": pack_wh_fragments(wh1),
                 "wi2": pack_wh_fragments(wi2), "wh2": pack_wh_fragments(wh2),
                 "wd": pack_wh_fragments(wd.reshape(T * 2 * H2, D), gates=1)}
    return PackedPileup(dtype, device, ops, hw, stacked, offsets, tc, frags)


def _device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _stream(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _check_input(t: torch.Tensor, packed: PackedPileup, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"pileup kernel: {what} on {t.device}, expected a CUDA device")
    if t.device != packed.device:
        raise ValueError(f"pileup kernel: {what} on {t.device}, operands on {packed.device}")


def _check_tc(t: torch.Tensor, packed: PackedPileup, what: str, width: int) -> None:
    """A tensor-core launch's input: ``[B, T, width]``, contiguous, in the
    compute dtype, on the packed operands' device, packed for that route."""
    _check_input(t, packed, what)
    if not packed.tc:
        raise ValueError("pileup kernel: the operands are not packed for the tensor-core route")
    T = packed.trunk[6].shape[0]
    if (t.dim() != 3 or tuple(t.shape[1:]) != (T, width) or t.dtype != packed.dtype
            or not t.is_contiguous()):
        raise ValueError(f"pileup kernel: {what} {tuple(t.shape)} {t.dtype} is not a "
                         f"contiguous [B, {T}, {width}] {packed.dtype} tensor")


def _empty_out(B: int, packed: PackedPileup, n_heads: int, device) -> torch.Tensor:
    """Probabilities ``[B, O]`` float32, or the trunk ``[B, D]`` in the
    compute dtype when ``n_heads`` is 0."""
    if n_heads:
        return torch.empty(B, packed.offsets[n_heads], dtype=torch.float32, device=device)
    return torch.empty(B, packed.trunk[6].shape[-1], dtype=packed.dtype, device=device)


def launch_l1(x: torch.Tensor, packed: PackedPileup) -> torch.Tensor:
    """L1 on the card: ``x [B, T, C]`` (compute dtype, contiguous) ->
    ``h1seq [B, T, 2*H1]``."""
    from clair3_tpu_torch.ops._build import check, load_library

    _check_tc(x, packed, "x", packed.trunk[0].shape[1])
    B, T, C = x.shape
    H1 = packed.trunk[1].shape[1]
    h1seq = torch.empty(B, T, 2 * H1, dtype=packed.dtype, device=x.device)
    if B:
        fr = packed.frags
        check(load_library().clair3t_pileup_l1_tc(
            _device_index(x.device), _ptr(x), _ptr(fr["wi1"]), _ptr(fr["wh1"]),
            _ptr(packed.trunk[2]), _ptr(h1seq), B, T, C, H1,
            _stream(x.device)), "pileup_l1_tc")
        kernel_launches["pileup_l1_tc"] += 1
    return h1seq


def launch_l2(h1seq: torch.Tensor, packed: PackedPileup) -> torch.Tensor:
    """L2 on the card: ``h1seq [B, T, 2*H1]`` -> ``h2seq [B, T, 2*H2]``."""
    from clair3_tpu_torch.ops._build import check, load_library

    _check_tc(h1seq, packed, "h1seq", 2 * packed.trunk[1].shape[1])
    B, T, _ = h1seq.shape
    H1, H2 = packed.trunk[1].shape[1], packed.trunk[4].shape[1]
    h2seq = torch.empty(B, T, 2 * H2, dtype=packed.dtype, device=h1seq.device)
    if B:
        fr = packed.frags
        check(load_library().clair3t_pileup_l2_tc(
            _device_index(h1seq.device), _ptr(h1seq), _ptr(fr["wi2"]), _ptr(fr["wh2"]),
            _ptr(packed.trunk[5]), _ptr(h2seq), B, T, H1, H2,
            _stream(h1seq.device)), "pileup_l2_tc")
        kernel_launches["pileup_l2_tc"] += 1
    return h2seq


def launch_head(h2seq: torch.Tensor, packed: PackedPileup, with_heads: bool = True) -> torch.Tensor:
    """L3 on the card: ``h2seq [B, T, 2*H2]`` -> probabilities ``[B, O]``
    float32, or the trunk ``[B, D]`` in the compute dtype when
    ``with_heads`` is false (or the net has none)."""
    from clair3_tpu_torch.ops._build import check, load_library

    _check_tc(h2seq, packed, "h2seq", 2 * packed.trunk[4].shape[1])
    B, T, _ = h2seq.shape
    H2, D = packed.trunk[4].shape[1], packed.trunk[6].shape[-1]
    n_heads = packed.n_heads if with_heads else 0
    w5, b5, wo, bo = packed.stacked if n_heads else (None,) * 4
    out = _empty_out(B, packed, n_heads, h2seq.device)
    if B:
        L5 = w5.shape[-1] if n_heads else 1
        check(load_library().clair3t_pileup_head(
            _device_index(h2seq.device), _ptr(h2seq), _ptr(packed.frags["wd"]),
            _ptr(packed.trunk[7]), *(_ptr(t) for t in (w5, b5, wo, bo)), _ptr(out),
            B, T, H2, D, L5, n_heads, *packed.offsets, _stream(h2seq.device)), "pileup_head")
        kernel_launches["pileup_head"] += 1
    return out


def _launch_simt(x: torch.Tensor, packed: PackedPileup, n_heads: int) -> torch.Tensor:
    """The float32 SIMT kernel on ``x [B, T, C]`` (B > 0)."""
    from clair3_tpu_torch.ops._build import check, load_library

    B, T, C = x.shape
    wi1, wh1, b1, wi2, wh2, b2, wd, bd = packed.trunk
    H1, H2, D = wh1.shape[1], wh2.shape[1], wd.shape[-1]
    w5, b5, wo, bo = packed.stacked if n_heads else (None,) * 4
    L5 = w5.shape[-1] if n_heads else 1
    h1_seq = torch.empty(T, B, 2 * H1, dtype=packed.dtype, device=x.device)
    out = _empty_out(B, packed, n_heads, x.device)
    check(load_library().clair3t_pileup_full(
        _device_index(x.device),
        *(_ptr(t) for t in (x, wi1, wh1, b1, wi2, wh2, b2, wd, bd, w5, b5, wo, bo,
                            h1_seq, out)),
        B, T, C, H1, H2, D, L5, n_heads, *packed.offsets, _stream(x.device)), "pileup_full")
    kernel_launches["pileup_full"] += 1
    return out


def _run(x: torch.Tensor, packed: PackedPileup, with_heads: bool) -> torch.Tensor:
    """Launch the route's kernels on ``x``: one call is the SIMT kernel
    (float32) or L1, L2 and L3 (bf16)."""
    global launches
    if packed.dtype == torch.bfloat16 and not packed.tc:
        wi1, wh1, wh2, wd = (packed.trunk[i] for i in (0, 1, 4, 6))
        raise ValueError(
            "pileup kernel: bf16 runs on the tensor-core launches, which take the net's "
            f"widths {TC_WIDTHS} and C <= {TC_MAX_C}; these operands have T={wd.shape[0]}, "
            f"H1={wh1.shape[1]}, H2={wh2.shape[1]}, D={wd.shape[-1]}, C={wi1.shape[1]} "
            "(use float32)")
    _check_input(x, packed, "input")
    x = x.to(packed.dtype).contiguous()
    B, T, C = x.shape
    wi1, wd = packed.trunk[0], packed.trunk[6]
    if (T, C) != (wd.shape[0], wi1.shape[1]):
        raise ValueError(f"pileup kernel: input {tuple(x.shape)} does not match the "
                         f"weights (T={wd.shape[0]}, C={wi1.shape[1]})")
    n_heads = packed.n_heads if with_heads else 0
    if B == 0:
        return _empty_out(B, packed, n_heads, x.device)
    if packed.tc:
        out = launch_head(launch_l2(launch_l1(x, packed), packed), packed, with_heads)
    else:
        out = _launch_simt(x, packed, n_heads)
    launches += 1
    return out


def _launch(x, trunk_weights, head_weights, dt):
    """Pack the operands for ``x``'s device and launch: the route of
    ``pileup_full`` and, with no heads, ``pileup_trunk``."""
    if x.device.type != "cuda":
        raise ValueError(f"pileup kernel: input on {x.device}, expected a CUDA device")
    packed = pack_pileup_operands(trunk_weights, head_weights, dt, x.device)
    return _run(x, packed, with_heads=True)


def pileup_full_packed(x: torch.Tensor, packed: PackedPileup) -> torch.Tensor:
    """The whole pileup net on packed operands: ``x [B, T, C]`` counts to
    probabilities ``[B, sum(head dims)]`` float32."""
    if x.device.type == "cpu":
        return pileup_full_reference(x, *packed.trunk, packed.heads,
                                     compute_dtype=packed.dtype)
    return _run(x, packed, with_heads=True)


def pileup_trunk_packed(x: torch.Tensor, packed: PackedPileup) -> torch.Tensor:
    """The trunk only, on packed operands: post-SELU ``[B, D]`` in the
    compute dtype."""
    if x.device.type == "cpu":
        return pileup_trunk_reference(x, *packed.trunk,
                                      compute_dtype=packed.dtype).to(packed.dtype)
    return _run(x, packed, with_heads=False)


def pileup_full(x, wi1, wh1, b1, wi2, wh2, b2, wd, bd,
                head_weights: Sequence[torch.Tensor],
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The whole pileup net: ``x [B, T, C]`` counts to probabilities
    ``[B, sum(head dims)]`` float32.  ``wd`` is the L4 kernel reshaped to
    ``[T, 2*H2, D]``; ``head_weights`` is ``(w5, b5, wo, bo)`` per head.
    Packs the operands, then runs ``pileup_full_packed``."""
    trunk = (wi1, wh1, b1, wi2, wh2, b2, wd, bd)
    if x.device.type == "cpu":
        return pileup_full_reference(x, *trunk, head_weights,
                                     compute_dtype=compute_dtype)
    return _launch(x, trunk, tuple(head_weights), compute_dtype)


def pileup_trunk(x, wi1, wh1, b1, wi2, wh2, b2, wd, bd,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The trunk only: post-SELU ``[B, D]`` in the compute dtype (the
    counterpart of ``pileup_trunk_pallas``)."""
    trunk = (wi1, wh1, b1, wi2, wh2, b2, wd, bd)
    if x.device.type == "cpu":
        return pileup_trunk_reference(x, *trunk,
                                      compute_dtype=compute_dtype).to(compute_dtype)
    return _launch(x, trunk, (), compute_dtype)
