"""rANS Nx16 codec (CRAM 3.1 block compression method 5).

Implements the rANS-Nx16 entropy coder introduced by CRAM 3.1 (reference
behavior: htslib cram/rANS_static4x16pr.c and the hts-specs CRAMcodecs
document).  Differences from the 3.0 rANS 4x8 codec (`io/rans.py`):

* 16-bit renormalization (states refill one uint16 at a time, lower bound
  2^15) instead of byte-wise at 2^23,
* 4 or 32 interleaved states (flag 0x02 selects 32),
* a flag byte with composable transforms applied before entropy coding:
  striping (0x04), bit-packing of small alphabets (0x40), run-length
  encoding (0x20), and a raw pass-through (0x10),
* uint7 (big-endian base-128 varint) sizes,
* order-1 frequency tables that may themselves be rANS-order-0 compressed.

The decoder supports the full flag set; the encoder emits order-0/order-1
4-state streams with optional PACK/RLE/CAT/STRIPE so roundtrip tests cover
every decode path.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

RANS_L = 1 << 15  # Nx16 renormalization lower bound

F_ORDER1 = 0x01
F_N32 = 0x02
F_STRIPE = 0x04
F_NOSZ = 0x08
F_CAT = 0x10
F_RLE = 0x20
F_PACK = 0x40

TF_SHIFT_O0 = 12
TF_SHIFT_O1 = 12  # we always write 12; decode honours the stored shift


# ---------------------------------------------------------------------------
# uint7 varint (big-endian 7-bit groups, high bit = continuation)
# ---------------------------------------------------------------------------

def write_uint7(v: int) -> bytes:
    if v < 0:
        raise ValueError("uint7 must be non-negative")
    groups = []
    groups.append(v & 0x7F)
    v >>= 7
    while v:
        groups.append((v & 0x7F) | 0x80)
        v >>= 7
    return bytes(reversed(groups))


def read_uint7(data: bytes, p: int) -> Tuple[int, int]:
    v = 0
    while True:
        c = data[p]
        p += 1
        v = (v << 7) | (c & 0x7F)
        if not (c & 0x80):
            return v, p


# ---------------------------------------------------------------------------
# alphabet + frequency tables (shared by order-0 and order-1)
# ---------------------------------------------------------------------------

def _encode_alphabet(symbols: Sequence[int]) -> bytes:
    """Ascending symbol list with consecutive-run compression; 0-terminated
    (htslib decode_alphabet contract)."""
    out = bytearray()
    syms = sorted(symbols)
    i = 0
    last = -2
    while i < len(syms):
        out.append(syms[i])
        if syms[i] == last + 1:
            # count how many further consecutive symbols follow
            run = 0
            while i + 1 + run < len(syms) and syms[i + 1 + run] == syms[i] + 1 + run:
                run += 1
            out.append(run)
            last = syms[i + run]
            i += run + 1
        else:
            last = syms[i]
            i += 1
    out.append(0)
    return bytes(out)


def _decode_alphabet(data: bytes, p: int) -> Tuple[List[int], int]:
    syms: List[int] = []
    rle = 0
    sym = data[p]
    p += 1
    last = sym
    while True:
        syms.append(sym)
        if rle:
            rle -= 1
            sym += 1
        else:
            sym = data[p]
            p += 1
            if sym == last + 1:
                rle = data[p]
                p += 1
        last = sym
        if sym == 0:
            break
    return syms, p


def _normalize(freqs: List[int], total: int) -> List[int]:
    """Scale counts to sum exactly `total`, keeping nonzero counts >= 1."""
    t = sum(freqs)
    out = [0] * 256
    if t == 0:
        return out
    acc = 0
    for i, f in enumerate(freqs):
        if f:
            nf = max(1, (f * total) // t)
            out[i] = nf
            acc += nf
    big = max(range(256), key=lambda i: out[i])
    out[big] += total - acc
    if out[big] <= 0:
        raise ValueError("cannot normalize frequency table")
    return out


def _cumulative(F: List[int]) -> List[int]:
    C = [0] * 257
    for i in range(256):
        C[i + 1] = C[i] + F[i]
    return C


def _sym_lookup(F: List[int], C: List[int], total: int) -> bytes:
    tab = bytearray(total)
    for s in range(256):
        if F[s]:
            tab[C[s]: C[s] + F[s]] = bytes([s]) * F[s]
    return bytes(tab)


def _write_freqs_o0(F: List[int]) -> bytes:
    syms = [s for s in range(256) if F[s]]
    out = bytearray(_encode_alphabet(syms))
    for s in syms:
        out += write_uint7(F[s])
    return bytes(out)


def _read_freqs_o0(data: bytes, p: int) -> Tuple[List[int], int]:
    syms, p = _decode_alphabet(data, p)
    F = [0] * 256
    for s in syms:
        F[s], p = read_uint7(data, p)
    # stored tables may be un- or differently-normalized; renormalize
    F = _normalize(F, 1 << TF_SHIFT_O0)
    return F, p


# ---------------------------------------------------------------------------
# order-0 rANS Nx16
# ---------------------------------------------------------------------------

def _rans0_encode(data: bytes, N: int) -> bytes:
    n = len(data)
    counts = [0] * 256
    for b in data:
        counts[b] += 1
    F = _normalize(counts, 1 << TF_SHIFT_O0)
    C = _cumulative(F)
    head = bytearray(_write_freqs_o0(F))

    states = [RANS_L] * N
    words: List[int] = []  # uint16 renorm words, reverse order
    x_max_base = (RANS_L >> TF_SHIFT_O0) << 16
    for i in range(n - 1, -1, -1):
        s = data[i]
        j = i % N
        x = states[j]
        x_max = x_max_base * F[s]
        while x >= x_max:
            words.append(x & 0xFFFF)
            x >>= 16
        states[j] = ((x // F[s]) << TF_SHIFT_O0) + C[s] + (x % F[s])
    body = b"".join(struct.pack("<I", st) for st in states)
    body += b"".join(struct.pack("<H", w) for w in reversed(words))
    return bytes(head) + body


def _rans0_decode(data: bytes, p: int, out_sz: int, N: int) -> Tuple[bytes, int]:
    F, p = _read_freqs_o0(data, p)
    C = _cumulative(F)
    tab = _sym_lookup(F, C, 1 << TF_SHIFT_O0)
    states = list(struct.unpack_from(f"<{N}I", data, p))
    p += 4 * N
    mask = (1 << TF_SHIFT_O0) - 1
    ln = len(data)
    out = bytearray(out_sz)
    for i in range(out_sz):
        j = i % N
        x = states[j]
        slot = x & mask
        s = tab[slot]
        out[i] = s
        x = F[s] * (x >> TF_SHIFT_O0) + slot - C[s]
        if x < RANS_L and p + 1 < ln + 1 and p + 2 <= ln:
            x = (x << 16) | (data[p] | (data[p + 1] << 8))
            p += 2
        states[j] = x
    return bytes(out), p


# ---------------------------------------------------------------------------
# order-1 rANS Nx16
# ---------------------------------------------------------------------------

def _rans1_encode(data: bytes, N: int) -> bytes:
    n = len(data)
    shift = TF_SHIFT_O1
    counts = [[0] * 256 for _ in range(256)]
    isz = n // N
    for q in range(N):
        last = 0
        lo = q * isz
        hi = lo + isz if q < N - 1 else n
        for i in range(lo, hi):
            counts[last][data[i]] += 1
            last = data[i]
    ctxs = [c for c in range(256) if sum(counts[c])]
    F = [None] * 256
    C = [None] * 256
    for c in ctxs:
        F[c] = _normalize(counts[c], 1 << shift)
        C[c] = _cumulative(F[c])

    # frequency table body: alphabet (union of contexts and symbols), then
    # per present context a row of uint7 freqs over the alphabet symbols
    alpha = sorted({s for c in ctxs for s in range(256) if counts[c][s]} | set(ctxs))
    tbl = bytearray(_encode_alphabet(alpha))
    for c in alpha:
        for s in alpha:
            tbl += write_uint7(F[c][s] if F[c] is not None else 0)

    head = bytearray()
    if len(tbl) > 1024:
        # compress the table itself with rANS order-0 (flag bit 0)
        comp = _rans0_encode(bytes(tbl), 4)
        head.append((shift << 4) | 1)
        head += write_uint7(len(tbl))
        head += write_uint7(len(comp))
        head += comp
    else:
        head.append(shift << 4)
        head += tbl

    states = [RANS_L] * N
    words: List[int] = []
    x_max_base = (RANS_L >> shift) << 16

    def enc(q: int, i: int, lo: int) -> None:
        s = data[i]
        last = data[i - 1] if i - 1 >= lo else 0
        Fc, Cc = F[last], C[last]
        x = states[q]
        x_max = x_max_base * Fc[s]
        while x >= x_max:
            words.append(x & 0xFFFF)
            x >>= 16
        states[q] = ((x // Fc[s]) << shift) + Cc[s] + (x % Fc[s])

    # reverse of decode order: tail (state N-1) first, then lockstep steps
    for i in range(n - 1, N * isz - 1, -1):
        enc(N - 1, i, (N - 1) * isz)
    for step in range(isz - 1, -1, -1):
        for q in range(N - 1, -1, -1):
            enc(q, q * isz + step, q * isz)
    body = b"".join(struct.pack("<I", st) for st in states)
    body += b"".join(struct.pack("<H", w) for w in reversed(words))
    return bytes(head) + body


def _read_freqs_o1(data: bytes, p: int) -> Tuple[List, List, List, int, int]:
    comp = data[p]
    p += 1
    shift = comp >> 4
    if comp & 1:
        u_len, p = read_uint7(data, p)
        c_len, p = read_uint7(data, p)
        tbl, _ = _rans0_decode(data, p, u_len, 4)
        p += c_len
        src, q = tbl, 0
    else:
        src, q = data, p
    alpha, q = _decode_alphabet(src, q)
    F = [None] * 256
    C = [None] * 256
    tab = [None] * 256
    total = 1 << shift
    for c in alpha:
        row = [0] * 256
        for s in alpha:
            row[s], q = read_uint7(src, q)
        if sum(row):
            row = _normalize(row, total)
            F[c] = row
            C[c] = _cumulative(row)
            tab[c] = _sym_lookup(row, C[c], total)
    if not (comp & 1):
        p = q
    return F, C, tab, shift, p


def _rans1_decode(data: bytes, p: int, out_sz: int, N: int) -> Tuple[bytes, int]:
    F, C, tab, shift, p = _read_freqs_o1(data, p)
    states = list(struct.unpack_from(f"<{N}I", data, p))
    p += 4 * N
    mask = (1 << shift) - 1
    ln = len(data)
    out = bytearray(out_sz)
    isz = out_sz // N
    pos = [q * isz for q in range(N)]
    last = [0] * N

    def dec(q: int) -> None:
        nonlocal p
        x = states[q]
        ctx = last[q]
        slot = x & mask
        s = tab[ctx][slot]
        out[pos[q]] = s
        x = F[ctx][s] * (x >> shift) + slot - C[ctx][s]
        if x < RANS_L and p + 2 <= ln:
            x = (x << 16) | (data[p] | (data[p + 1] << 8))
            p += 2
        states[q] = x
        last[q] = s
        pos[q] += 1

    for _ in range(isz):
        for q in range(N):
            dec(q)
    while pos[N - 1] < out_sz:
        dec(N - 1)
    return bytes(out), p


# ---------------------------------------------------------------------------
# PACK / RLE transforms
# ---------------------------------------------------------------------------

def _pack_encode(data: bytes) -> Optional[Tuple[bytes, bytes]]:
    """Returns (meta_without_len, packed) or None if >16 distinct symbols."""
    syms = sorted(set(data))
    nsym = len(syms)
    if nsym > 16:
        return None
    meta = bytes([nsym]) + bytes(syms)
    idx = {s: i for i, s in enumerate(syms)}
    n = len(data)
    if nsym <= 1:
        packed = b""
    elif nsym <= 2:
        packed = bytearray((n + 7) // 8)
        for i, b in enumerate(data):
            packed[i >> 3] |= idx[b] << (i & 7)
        packed = bytes(packed)
    elif nsym <= 4:
        packed = bytearray((n + 3) // 4)
        for i, b in enumerate(data):
            packed[i >> 2] |= idx[b] << ((i & 3) * 2)
        packed = bytes(packed)
    else:
        packed = bytearray((n + 1) // 2)
        for i, b in enumerate(data):
            packed[i >> 1] |= idx[b] << ((i & 1) * 4)
        packed = bytes(packed)
    return meta, packed


def _pack_decode(packed: bytes, P: Sequence[int], nsym: int, out_sz: int) -> bytes:
    if out_sz == 0:
        return b""
    out = bytearray(out_sz)
    if nsym <= 1:
        if nsym == 0:
            raise ValueError("PACK with empty symbol map")
        return bytes([P[0]]) * out_sz
    if nsym <= 2:
        for i in range(out_sz):
            out[i] = P[(packed[i >> 3] >> (i & 7)) & 1]
    elif nsym <= 4:
        for i in range(out_sz):
            out[i] = P[(packed[i >> 2] >> ((i & 3) * 2)) & 3]
    elif nsym <= 16:
        for i in range(out_sz):
            out[i] = P[(packed[i >> 1] >> ((i & 1) * 4)) & 15]
    else:
        raise ValueError("PACK with >16 symbols")
    return bytes(out)


def _rle_encode(data: bytes) -> Optional[Tuple[bytes, bytes]]:
    """Run-length encode.  Returns (rle_meta, literals) where rle_meta =
    symbol table + uint7 run lengths, literals = data with runs collapsed to
    one occurrence.  Runs are encoded for symbols where RLE wins."""
    n = len(data)
    if n == 0:
        return None
    # score per symbol: bytes saved by run-collapsing vs run-length cost
    saved = [0] * 256
    i = 0
    while i < n:
        j = i
        while j < n and data[j] == data[i]:
            j += 1
        run = j - i
        saved[data[i]] += (run - 1) - 2  # collapse gain minus ~meta cost
        i = j
    rle_syms = [s for s in range(256) if saved[s] > 0]
    if not rle_syms:
        return None
    in_rle = bytearray(256)
    for s in rle_syms:
        in_rle[s] = 1
    meta = bytearray()
    meta.append(len(rle_syms) & 0xFF)  # 0 means 256
    meta += bytes(rle_syms)
    lits = bytearray()
    runs = bytearray()
    i = 0
    while i < n:
        b = data[i]
        lits.append(b)
        if in_rle[b]:
            j = i + 1
            while j < n and data[j] == b:
                j += 1
            runs += write_uint7(j - i - 1)
            i = j
        else:
            i += 1
    return bytes(meta) + bytes(runs), bytes(lits)


def _rle_decode(lits: bytes, rle_meta: bytes, out_sz: int) -> bytes:
    p = 0
    m = rle_meta[p]
    p += 1
    if m == 0:
        m = 256
    in_rle = bytearray(256)
    for _ in range(m):
        in_rle[rle_meta[p]] = 1
        p += 1
    out = bytearray(out_sz)
    j = 0
    for b in lits:
        if j >= out_sz:
            raise ValueError("RLE output overrun")
        out[j] = b
        j += 1
        if in_rle[b]:
            run, p = read_uint7(rle_meta, p)
            if j + run > out_sz:
                raise ValueError("RLE run overrun")
            for _ in range(run):
                out[j] = b
                j += 1
    if j != out_sz:
        raise ValueError(f"RLE produced {j} of {out_sz} bytes")
    return bytes(out)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def rans_nx16_decompress(payload: bytes, out_sz_hint: Optional[int] = None) -> bytes:
    data = payload
    p = 0
    flags = data[p]
    p += 1
    if flags & F_NOSZ:
        if out_sz_hint is None:
            raise ValueError("NoSize stream requires an output-size hint")
        out_sz = out_sz_hint
    else:
        out_sz, p = read_uint7(data, p)

    if flags & F_STRIPE:
        X = data[p]
        p += 1
        clens = []
        for _ in range(X):
            c, p = read_uint7(data, p)
            clens.append(c)
        subs = []
        for j in range(X):
            ulen = out_sz // X + (1 if (out_sz % X) > j else 0)
            subs.append(rans_nx16_decompress(data[p: p + clens[j]], ulen))
            p += clens[j]
        out = bytearray(out_sz)
        for j in range(X):
            out[j::X] = subs[j]
        return bytes(out)

    N = 32 if flags & F_N32 else 4

    pack_meta = None
    if flags & F_PACK:
        final_len = out_sz
        nsym = data[p]
        p += 1
        P = list(data[p: p + nsym])
        p += nsym
        out_sz, p = read_uint7(data, p)
        pack_meta = (P, nsym, final_len)

    rle_meta = None
    if flags & F_RLE:
        rle_out_len = out_sz
        rle_meta_len, p = read_uint7(data, p)
        out_sz, p = read_uint7(data, p)  # literal length
        if rle_meta_len & 1:
            mlen = (rle_meta_len - 1) // 2
            meta = data[p: p + mlen]
            p += mlen
        else:
            c_meta_len, p = read_uint7(data, p)
            meta, _ = _rans0_decode(data, p, rle_meta_len // 2, N)
            p += c_meta_len
        rle_meta = (meta, rle_out_len)

    if flags & F_CAT:
        buf = data[p: p + out_sz]
        if len(buf) != out_sz:
            raise ValueError("truncated CAT data")
        p += out_sz
    elif out_sz == 0:
        buf = b""
    elif flags & F_ORDER1:
        buf, p = _rans1_decode(data, p, out_sz, N)
    else:
        buf, p = _rans0_decode(data, p, out_sz, N)

    if rle_meta is not None:
        meta, rle_out_len = rle_meta
        buf = _rle_decode(buf, meta, rle_out_len)
    if pack_meta is not None:
        P, nsym, final_len = pack_meta
        buf = _pack_decode(buf, P, nsym, final_len)
    return buf


def rans_nx16_compress(data: bytes, flags: int = F_ORDER1,
                       no_size: bool = False) -> bytes:
    """Compress to an rANS-Nx16 stream.

    `flags` requests transforms (ORDER1/PACK/RLE/CAT/STRIPE/N32); transforms
    that cannot apply (e.g. PACK with >16 symbols) are silently dropped,
    matching htslib's adaptive behavior.
    """
    n = len(data)
    out = bytearray()
    eff = flags
    if n < 4 * (32 if eff & F_N32 else 4):
        # too short for interleaved entropy coding: store raw
        eff = (eff | F_CAT) & ~(F_ORDER1 | F_RLE | F_PACK | F_STRIPE)

    if eff & F_STRIPE:
        X = 4
        body = bytearray()
        head = bytearray()
        head.append((F_STRIPE | (F_NOSZ if no_size else 0)) & 0xFF)
        if not no_size:
            head += write_uint7(n)
        head.append(X)
        subs = []
        for j in range(X):
            sub = rans_nx16_compress(data[j::X], (eff & ~F_STRIPE) | F_NOSZ,
                                     no_size=True)
            subs.append(sub)
        for sub in subs:
            head += write_uint7(len(sub))
        for sub in subs:
            body += sub
        return bytes(head) + bytes(body)

    payload = data
    pack_bytes = b""
    if eff & F_PACK:
        packed = _pack_encode(payload)
        if packed is None:
            eff &= ~F_PACK
        else:
            meta, payload = packed
            pack_bytes = meta + write_uint7(len(payload))

    rle_bytes = b""
    if eff & F_RLE:
        r = _rle_encode(payload)
        if r is None:
            eff &= ~F_RLE
        else:
            meta, lits = r
            # store meta uncompressed: length field = 2*len+1 (odd = raw)
            rle_bytes = (write_uint7(2 * len(meta) + 1)
                         + write_uint7(len(lits))
                         + meta)
            payload = lits

    N = 32 if eff & F_N32 else 4
    if len(payload) < 4 * N and not (eff & F_CAT):
        eff = (eff | F_CAT) & ~F_ORDER1

    out.append(eff & 0xFF | (F_NOSZ if no_size else 0))
    if not no_size:
        out += write_uint7(n)
    out += pack_bytes
    out += rle_bytes
    if eff & F_CAT:
        out += payload
    elif len(payload) == 0:
        pass
    elif eff & F_ORDER1:
        out += _rans1_encode(payload, N)
    else:
        out += _rans0_encode(payload, N)
    return bytes(out)
