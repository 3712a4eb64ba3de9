"""Affine-gap local alignment (Gotoh), C++ fast path + Python fallback.

Replaces the reference's vendored striped Smith-Waterman
(preprocess/realign/ssw.c, DeepVariant-derived) for the Illumina
realignment path.  CIGAR ops use BAM codes (M=0, I=1, D=2, S=4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

# default scoring (match, mismatch, gap open, gap extend penalties)
MATCH = 4
MISMATCH = 6
GAP_OPEN = 8
GAP_EXTEND = 2


@dataclass
class Alignment:
    score: int
    query_start: int
    query_end: int
    target_start: int
    target_end: int
    cigar: List[Tuple[int, int]]  # aligned region only, no clips

    def full_cigar(self, query_len: int) -> List[Tuple[int, int]]:
        """CIGAR including soft clips for the unaligned query ends."""
        out: List[Tuple[int, int]] = []
        if self.query_start > 0:
            out.append((4, self.query_start))
        out.extend(self.cigar)
        if self.query_end < query_len:
            out.append((4, query_len - self.query_end))
        return out


def _align_python(query: str, target: str, match: int, mismatch: int,
                  gap_open: int, gap_extend: int) -> Alignment:
    n, m = len(query), len(target)
    NEG = -(1 << 28)
    H = [[0] * (m + 1) for _ in range(n + 1)]
    E = [[NEG] * (m + 1) for _ in range(n + 1)]
    F = [[NEG] * (m + 1) for _ in range(n + 1)]
    best, bi, bj = 0, 0, 0
    for i in range(1, n + 1):
        qc = query[i - 1]
        Hi, Hi1, Ei, Fi, Fi1 = H[i], H[i - 1], E[i], F[i], F[i - 1]
        for j in range(1, m + 1):
            e = max(Hi[j - 1] - gap_open, Ei[j - 1] - gap_extend)
            f = max(Hi1[j] - gap_open, Fi1[j] - gap_extend)
            s = match if qc == target[j - 1] else -mismatch
            h = max(0, Hi1[j - 1] + s, e, f)
            Ei[j] = e
            Fi[j] = f
            Hi[j] = h
            if h > best:
                best, bi, bj = h, i, j
    if best == 0:
        return Alignment(0, 0, 0, 0, 0, [])
    cigar: List[Tuple[int, int]] = []

    def push(op: int, length: int = 1) -> None:
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + length)
        else:
            cigar.append((op, length))

    i, j, state = bi, bj, 0
    while i > 0 and j > 0:
        if state == 0:
            h = H[i][j]
            if h == 0:
                break
            s = match if query[i - 1] == target[j - 1] else -mismatch
            if h == H[i - 1][j - 1] + s:
                push(0)
                i -= 1
                j -= 1
            elif h == E[i][j]:
                state = 1
            else:
                state = 2
        elif state == 1:
            push(2)
            e_old = E[i][j]
            j -= 1
            state = 0 if e_old == H[i][j] - gap_open else 1
        else:
            push(1)
            f_old = F[i][j]
            i -= 1
            state = 0 if f_old == H[i][j] - gap_open else 2
    cigar.reverse()
    return Alignment(best, i, bi, j, bj, cigar)


_native_checked = False
_native_fn = None


def _get_native():
    global _native_checked, _native_fn
    if _native_checked:
        return _native_fn
    _native_checked = True
    try:
        import ctypes

        from clair3_tpu_torch.native import get_lib

        lib = get_lib()

        class _AlignOut(ctypes.Structure):
            _fields_ = [
                ("score", ctypes.c_int32),
                ("query_start", ctypes.c_int32),
                ("query_end", ctypes.c_int32),
                ("target_start", ctypes.c_int32),
                ("target_end", ctypes.c_int32),
                ("cigar", ctypes.POINTER(ctypes.c_uint32)),
                ("n_cigar", ctypes.c_int32),
            ]

        lib.clair3t_align.restype = ctypes.POINTER(_AlignOut)
        lib.clair3t_align.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ]
        lib.clair3t_align_free.argtypes = [ctypes.POINTER(_AlignOut)]

        def native_align(query, target, match, mismatch, gap_open, gap_extend):
            out_p = lib.clair3t_align(
                query.encode(), len(query), target.encode(), len(target),
                match, mismatch, gap_open, gap_extend)
            o = out_p.contents
            try:
                cigar = [((o.cigar[k] & 0xF), (o.cigar[k] >> 4))
                         for k in range(o.n_cigar)]
                return Alignment(o.score, o.query_start, o.query_end,
                                 o.target_start, o.target_end, cigar)
            finally:
                lib.clair3t_align_free(out_p)

        _native_fn = native_align
    except Exception:
        _native_fn = None
    return _native_fn


def affine_local_align(
    query: str, target: str,
    match: int = MATCH, mismatch: int = MISMATCH,
    gap_open: int = GAP_OPEN, gap_extend: int = GAP_EXTEND,
    use_native: Optional[bool] = None,
) -> Alignment:
    if use_native is None:
        fn = _get_native()
    elif use_native:
        fn = _get_native()
        if fn is None:
            raise RuntimeError("native aligner unavailable")
    else:
        fn = None
    if fn is not None:
        return fn(query, target, match, mismatch, gap_open, gap_extend)
    return _align_python(query, target, match, mismatch, gap_open, gap_extend)
