"""rANS 4x8 codec (CRAM 3.0 block compression method 4).

Implements the rANS-static byte-wise order-0 and order-1 entropy coder used
by CRAM 3.0 (reference behavior: htslib cram/rANS_static docs and the CRAM
3.0 specification section 13.4): 4 interleaved 32-bit states, 12-bit
normalized frequencies, byte-wise renormalization at 2^23.

Stream layout:
  byte 0   : order (0 or 1)
  4 bytes  : compressed size (LE, excluding this 9-byte prefix)
  4 bytes  : uncompressed size (LE)
  ...      : frequency table, then 4 initial states (LE u32), then bytes
"""

from __future__ import annotations

import struct
from typing import List, Tuple

RANS_L = 1 << 23      # renormalization lower bound
TF_SHIFT = 12
TOTFREQ = 1 << TF_SHIFT


# ---------------------------------------------------------------------------
# frequency tables
# ---------------------------------------------------------------------------

def _normalize(freqs: List[int], total: int = TOTFREQ) -> List[int]:
    """Scale counts so they sum exactly to `total`, keeping nonzero counts
    nonzero."""
    t = sum(freqs)
    if t == 0:
        return freqs
    out = [0] * 256
    # initial scale
    acc = 0
    for i, f in enumerate(freqs):
        if f:
            nf = max(1, (f * total) // t)
            out[i] = nf
            acc += nf
    # fix to exact total by adjusting the most frequent symbol
    big = max(range(256), key=lambda i: out[i])
    out[big] += total - acc
    if out[big] <= 0:
        raise ValueError("cannot normalize frequency table")
    return out


def _write_freq(buf: bytearray, f: int) -> None:
    if f > 127:
        buf.append((f >> 8) | 0x80)
        buf.append(f & 0xFF)
    else:
        buf.append(f)


def _read_freq(data: bytes, p: int) -> Tuple[int, int]:
    if data[p] >= 128:
        return ((data[p] & 0x7F) << 8) | data[p + 1], p + 2
    return data[p], p + 1


def _write_freq_table(buf: bytearray, F: List[int]) -> None:
    """RLE symbol table: symbol byte, then (after a symbol that starts a
    consecutive run) one run-length byte; 0x00 terminator."""
    rle = 0
    for j in range(256):
        if not F[j]:
            continue
        if rle:
            rle -= 1
        else:
            buf.append(j)
            if j and F[j - 1]:
                # start of a consecutive run: count following symbols
                run = 0
                k = j + 1
                while k < 256 and F[k]:
                    run += 1
                    k += 1
                rle = run
                buf.append(run)
        _write_freq(buf, F[j])
    buf.append(0)


def _read_freq_table(data: bytes, p: int) -> Tuple[List[int], int]:
    F = [0] * 256
    j = data[p]
    p += 1
    rle = 0
    while True:
        f, p = _read_freq(data, p)
        F[j] = f
        if rle:
            rle -= 1
            j += 1
        else:
            nxt = data[p]
            if nxt == j + 1:
                j = nxt
                p += 1
                rle = data[p]
                p += 1
            else:
                j = nxt
                p += 1
        if j == 0:
            break
    return F, p


def _cumulative(F: List[int]) -> List[int]:
    C = [0] * 257
    for i in range(256):
        C[i + 1] = C[i] + F[i]
    return C


def _sym_lookup(F: List[int], C: List[int]) -> bytes:
    """4096-entry slot -> symbol table."""
    tab = bytearray(TOTFREQ)
    for s in range(256):
        if F[s]:
            tab[C[s]: C[s] + F[s]] = bytes([s]) * F[s]
    return bytes(tab)


# ---------------------------------------------------------------------------
# order-0
# ---------------------------------------------------------------------------

def _encode_o0(data: bytes) -> bytes:
    n = len(data)
    counts = [0] * 256
    for b in data:
        counts[b] += 1
    F = _normalize(counts)
    C = _cumulative(F)
    head = bytearray()
    _write_freq_table(head, F)

    states = [RANS_L] * 4
    out = bytearray()  # emitted in reverse
    x_max_base = (RANS_L >> TF_SHIFT) << 8
    for i in range(n - 1, -1, -1):
        s = data[i]
        j = i & 3
        x = states[j]
        x_max = x_max_base * F[s]
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // F[s]) << TF_SHIFT) + C[s] + (x % F[s])
    tail = struct.pack("<4I", *states) + bytes(reversed(out))
    return bytes(head) + tail


def _decode_o0(data: bytes, out_sz: int) -> bytes:
    F, p = _read_freq_table(data, 0)
    C = _cumulative(F)
    tab = _sym_lookup(F, C)
    states = list(struct.unpack_from("<4I", data, p))
    p += 16
    out = bytearray(out_sz)
    ln = len(data)
    for i in range(out_sz):
        j = i & 3
        x = states[j]
        slot = x & (TOTFREQ - 1)
        s = tab[slot]
        out[i] = s
        x = F[s] * (x >> TF_SHIFT) + slot - C[s]
        while x < RANS_L and p < ln:
            x = (x << 8) | data[p]
            p += 1
        states[j] = x
    return bytes(out)


# ---------------------------------------------------------------------------
# order-1
# ---------------------------------------------------------------------------

def _encode_o1(data: bytes) -> bytes:
    n = len(data)
    counts = [[0] * 256 for _ in range(256)]
    # each of the 4 states covers a contiguous quarter with context = last
    # byte (initial context 0)
    isz4 = n >> 2
    starts = [0, isz4, 2 * isz4, 3 * isz4]
    for q in range(4):
        last = 0
        lo = starts[q]
        hi = starts[q + 1] if q < 3 else n
        for i in range(lo, hi):
            counts[last][data[i]] += 1
            last = data[i]
    F = [None] * 256
    C = [None] * 256
    for ctx in range(256):
        if sum(counts[ctx]):
            F[ctx] = _normalize(counts[ctx])
            C[ctx] = _cumulative(F[ctx])

    head = bytearray()
    # outer RLE over contexts, inner full table per context
    rle = 0
    for ctx in range(256):
        if F[ctx] is None:
            continue
        if rle:
            rle -= 1
        else:
            head.append(ctx)
            if ctx and F[ctx - 1] is not None:
                run = 0
                k = ctx + 1
                while k < 256 and F[k] is not None:
                    run += 1
                    k += 1
                rle = run
                head.append(run)
        _write_freq_table(head, F[ctx])
    head.append(0)

    states = [RANS_L] * 4
    out = bytearray()
    x_max_base = (RANS_L >> TF_SHIFT) << 8

    def enc(q: int, i: int, lo: int) -> None:
        s = data[i]
        last = data[i - 1] if i - 1 >= lo else 0
        Fc, Cc = F[last], C[last]
        x = states[q]
        x_max = x_max_base * Fc[s]
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        states[q] = ((x // Fc[s]) << TF_SHIFT) + Cc[s] + (x % Fc[s])

    # Exact reverse of the decoder's lockstep consumption: the tail
    # (n - 4*isz4, decoded last by state 3) first, then steps isz4-1..0 with
    # states 3,2,1,0 inside each step.
    for i in range(n - 1, 4 * isz4 - 1, -1):
        enc(3, i, starts[3])
    for step in range(isz4 - 1, -1, -1):
        for q in (3, 2, 1, 0):
            enc(q, starts[q] + step, starts[q])
    tail = struct.pack("<4I", *states) + bytes(reversed(out))
    return bytes(head) + tail


def _decode_o1(data: bytes, out_sz: int) -> bytes:
    p = 0
    F = [None] * 256
    C = [None] * 256
    tab = [None] * 256
    ctx = data[p]
    p += 1
    rle = 0
    while True:
        Fc, p = _read_freq_table(data, p)
        F[ctx] = Fc
        C[ctx] = _cumulative(Fc)
        tab[ctx] = _sym_lookup(Fc, C[ctx])
        if rle:
            rle -= 1
            ctx += 1
        else:
            nxt = data[p]
            if nxt == ctx + 1:
                ctx = nxt
                p += 1
                rle = data[p]
                p += 1
            else:
                ctx = nxt
                p += 1
        if ctx == 0:
            break
    states = list(struct.unpack_from("<4I", data, p))
    p += 16
    ln = len(data)
    out = bytearray(out_sz)
    isz4 = out_sz >> 2
    pos = [0, isz4, 2 * isz4, 3 * isz4]
    last = [0, 0, 0, 0]

    def dec(q: int) -> None:
        nonlocal p
        x = states[q]
        Fc = F[last[q]]
        Cc = C[last[q]]
        slot = x & (TOTFREQ - 1)
        s = tab[last[q]][slot]
        out[pos[q]] = s
        x = Fc[s] * (x >> TF_SHIFT) + slot - Cc[s]
        while x < RANS_L and p < ln:
            x = (x << 8) | data[p]
            p += 1
        states[q] = x
        last[q] = s
        pos[q] += 1

    # lockstep: each step advances states 0..3 by one position in their own
    # contiguous quarter; the remainder is decoded by state 3
    for _ in range(isz4):
        for q in range(4):
            dec(q)
    while pos[3] < out_sz:
        dec(3)
    return bytes(out)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def rans_compress(data: bytes, order: int = 0) -> bytes:
    """Compress with rANS 4x8; returns the full CRAM block payload
    (order byte + sizes + stream)."""
    if len(data) == 0:
        body = b""
        return struct.pack("<BII", order, 0, 0) + body
    if len(data) < 4:
        order = 0
    body = _encode_o0(data) if order == 0 else _encode_o1(data)
    return struct.pack("<BII", order, len(body), len(data)) + body


def rans_decompress(payload: bytes) -> bytes:
    """Decompress a CRAM rANS 4x8 block payload (native C++ fast path when
    available; this module's Python decoder is the oracle and fallback)."""
    if len(payload) < 9:
        raise ValueError("truncated rANS stream")
    order, comp_sz, out_sz = struct.unpack_from("<BII", payload, 0)
    if out_sz == 0:
        return b""
    if order not in (0, 1):
        raise ValueError(f"unknown rANS order {order}")
    try:
        from clair3_tpu_torch.native import rans_decode_native

        native = rans_decode_native(payload)
        if native is not None:
            return native
    except ValueError:
        raise
    except Exception:
        pass
    data = payload[9: 9 + comp_sz]
    if order == 0:
        return _decode_o0(data, out_sz)
    return _decode_o1(data, out_sz)
