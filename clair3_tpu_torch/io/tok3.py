"""Name tokeniser codec "tok3" (CRAM 3.1 block compression method 8).

Implements the read-name tokenisation codec introduced by CRAM 3.1
(reference behavior: htslib cram/tokenise_name3.c and the hts-specs
CRAMcodecs document).  Read names are highly structured
(``m64012_190920_173625/1022/ccs``); the codec splits each into tokens
(alpha runs, digit runs, single chars), encodes each token *position* as its
own byte stream expressing the relation to the previous name's token at that
position (MATCH / small numeric DELTA / literal), and entropy-codes every
stream independently with rANS-Nx16 or the adaptive arithmetic coder.

Container layout:

    ulen      uint7   total uncompressed size (names NUL-terminated)
    nnames    uint7   number of names
    use_arith u8      1 = arith streams, 0 = rANS-Nx16 streams
    repeat until exhausted:
        ttype  u8     bit7 = first stream of a new token position,
                      bit6 = duplicate of an earlier stream, bits 0-5 = type
        if dup:  dup_pos u8, dup_type u8
        else:    clen uint7, then clen bytes of compressed stream

Token types: 0 TYPE, 1 ALPHA, 2 CHAR, 3 DZLEN, 4 DIGITS0, 5 DUP, 6 DIFF,
7 DIGITS, 8 DDELTA, 9 DDELTA0, 10 MATCH, 11 NOP, 12 END
(tokenise_name3.h name_type enum).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

from clair3_tpu_torch.io.rans_nx16 import (
    F_ORDER1 as R_ORDER1,
    rans_nx16_compress,
    rans_nx16_decompress,
    read_uint7,
    write_uint7,
)

N_TYPE = 0
N_ALPHA = 1
N_CHAR = 2
N_DZLEN = 3
N_DIGITS0 = 4
N_DUP = 5
N_DIFF = 6
N_DIGITS = 7
N_DDELTA = 8
N_DDELTA0 = 9
N_MATCH = 10
N_NOP = 11
N_END = 12
_NTYPES = 13

T_NEW = 0x80
T_DUP_STREAM = 0x40


# ---------------------------------------------------------------------------
# tokenisation
# ---------------------------------------------------------------------------

def _tokenize(name: bytes) -> List[Tuple[int, bytes]]:
    """Split into (type, text) tokens: digit runs (DIGITS, or DIGITS0 when
    zero-padded/oversized) and non-digit runs (ALPHA, or CHAR when single)."""
    toks: List[Tuple[int, bytes]] = []
    i = 0
    n = len(name)
    while i < n:
        c = name[i]
        if 0x30 <= c <= 0x39:
            j = i
            while j < n and 0x30 <= name[j] <= 0x39:
                j += 1
            run = name[i:j]
            # u32-safe chunks of <= 9 digits
            while run:
                chunk, run = run[:9], run[9:]
                if chunk[0] == 0x30 and len(chunk) > 1:
                    toks.append((N_DIGITS0, chunk))
                else:
                    toks.append((N_DIGITS, chunk))
            i = j
        else:
            j = i
            while j < n and not (0x30 <= name[j] <= 0x39):
                j += 1
            run = name[i:j]
            toks.append((N_CHAR, run) if len(run) == 1 else (N_ALPHA, run))
            i = j
    return toks


class _StreamSet:
    """B[t][type] byte stream builders."""

    def __init__(self):
        self.streams: Dict[Tuple[int, int], bytearray] = {}

    def put(self, t: int, typ: int, data: bytes) -> None:
        self.streams.setdefault((t, typ), bytearray()).extend(data)

    def put_u32(self, t: int, typ: int, v: int) -> None:
        self.put(t, typ, struct.pack("<I", v))


def tok3_compress(data: bytes, use_arith: bool = False) -> bytes:
    """Compress a block of NUL-terminated names."""
    if data and not data.endswith(b"\x00"):
        raise ValueError("tok3 input must be NUL-terminated names")
    names = data.split(b"\x00")[:-1] if data else []
    ss = _StreamSet()
    prev_toks: List[Optional[List[Tuple[int, bytes]]]] = []

    for n, name in enumerate(names):
        if n > 0 and name == names[n - 1]:
            ss.put(0, N_TYPE, bytes([N_DUP]))
            ss.put_u32(0, N_DUP, 1)
            prev_toks.append(prev_toks[-1])
            continue
        dist = 1 if n > 0 else 0
        ss.put(0, N_TYPE, bytes([N_DIFF]))
        ss.put_u32(0, N_DIFF, dist)
        prev = prev_toks[n - dist] if dist and prev_toks[n - dist] else []
        toks = _tokenize(name)
        for t, (typ, text) in enumerate(toks, start=1):
            p = prev[t - 1] if t - 1 < len(prev) else None
            if p is not None and p[1] == text:
                ss.put(t, N_TYPE, bytes([N_MATCH]))
                continue
            if (p is not None and typ == N_DIGITS and p[0] == N_DIGITS):
                d = int(text) - int(p[1])
                if 0 <= d <= 255:
                    ss.put(t, N_TYPE, bytes([N_DDELTA]))
                    ss.put(t, N_DDELTA, bytes([d]))
                    continue
            if (p is not None and typ == N_DIGITS0 and p[0] == N_DIGITS0
                    and len(p[1]) == len(text)):
                d = int(text) - int(p[1])
                if 0 <= d <= 255:
                    ss.put(t, N_TYPE, bytes([N_DDELTA0]))
                    ss.put(t, N_DDELTA0, bytes([d]))
                    continue
            ss.put(t, N_TYPE, bytes([typ]))
            if typ == N_ALPHA:
                ss.put(t, N_ALPHA, text + b"\x00")
            elif typ == N_CHAR:
                ss.put(t, N_CHAR, text)
            elif typ == N_DIGITS:
                ss.put_u32(t, N_DIGITS, int(text))
            else:  # N_DIGITS0
                ss.put_u32(t, N_DIGITS0, int(text))
                ss.put(t, N_DZLEN, bytes([len(text)]))
        ss.put(len(toks) + 1, N_TYPE, bytes([N_END]))
        prev_toks.append(toks)

    out = bytearray()
    out += write_uint7(len(data))
    out += write_uint7(len(names))
    out.append(1 if use_arith else 0)

    if use_arith:
        from clair3_tpu_torch.io.arith import F_ORDER1 as A_ORDER1, arith_compress

        def comp(b: bytes) -> bytes:
            return arith_compress(b, A_ORDER1 if len(b) >= 32 else 0)
    else:
        def comp(b: bytes) -> bytes:
            return rans_nx16_compress(b, R_ORDER1 if len(b) >= 32 else 0)

    seen: Dict[bytes, Tuple[int, int]] = {}
    max_t = max((t for t, _ in ss.streams), default=-1)
    for t in range(max_t + 1):
        first = True
        for typ in range(_NTYPES):
            raw = ss.streams.get((t, typ))
            if raw is None:
                continue
            raw = bytes(raw)
            flag = T_NEW if first else 0
            first = False
            dup = seen.get(raw)
            if dup is not None and dup[0] < 256:
                out.append(typ | flag | T_DUP_STREAM)
                out.append(dup[0])
                out.append(dup[1])
            else:
                blob = comp(raw)
                out.append(typ | flag)
                out += write_uint7(len(blob))
                out += blob
                seen.setdefault(raw, (t, typ))
    return bytes(out)


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------

class _Cursor:
    __slots__ = ("data", "p")

    def __init__(self, data: bytes):
        self.data = data
        self.p = 0

    def byte(self) -> int:
        b = self.data[self.p]
        self.p += 1
        return b

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.data, self.p)[0]
        self.p += 4
        return v

    def cstr(self) -> bytes:
        q = self.data.index(0, self.p)
        s = self.data[self.p: q]
        self.p = q + 1
        return s


def tok3_decompress(payload: bytes) -> bytes:
    data = payload
    p = 0
    ulen, p = read_uint7(data, p)
    nnames, p = read_uint7(data, p)
    use_arith = data[p]
    p += 1

    if use_arith:
        from clair3_tpu_torch.io.arith import arith_decompress as dec
    else:
        dec = rans_nx16_decompress

    streams: Dict[Tuple[int, int], _Cursor] = {}
    raw: Dict[Tuple[int, int], bytes] = {}
    t = -1
    while p < len(data):
        ttype = data[p]
        p += 1
        typ = ttype & 63
        if ttype & T_NEW:
            t += 1
        if t < 0:
            raise ValueError("tok3: stream before first token position")
        if ttype & T_DUP_STREAM:
            dup_pos = data[p]
            dup_type = data[p + 1]
            p += 2
            buf = raw.get((dup_pos, dup_type))
            if buf is None:
                raise ValueError("tok3: duplicate of unknown stream")
        else:
            clen, p = read_uint7(data, p)
            buf = dec(data[p: p + clen])
            p += clen
        raw[(t, typ)] = buf
        streams[(t, typ)] = _Cursor(buf)

    def cur(t: int, typ: int) -> _Cursor:
        c = streams.get((t, typ))
        if c is None:
            raise ValueError(f"tok3: missing stream (pos={t}, type={typ})")
        return c

    names: List[bytes] = []
    toks_per_name: List[List[Tuple[int, bytes]]] = []
    for n in range(nnames):
        ntype = cur(0, N_TYPE).byte()
        if ntype == N_DUP:
            dist = cur(0, N_DUP).u32()
            names.append(names[n - dist])
            toks_per_name.append(toks_per_name[n - dist])
            continue
        if ntype != N_DIFF:
            raise ValueError(f"tok3: name {n} starts with type {ntype}")
        dist = cur(0, N_DIFF).u32()
        prev = toks_per_name[n - dist] if 0 < dist <= n else []
        toks: List[Tuple[int, bytes]] = []
        t = 1
        parts: List[bytes] = []
        while True:
            typ = cur(t, N_TYPE).byte()
            if typ == N_END:
                break
            if typ == N_NOP:
                toks.append((N_NOP, b""))
            elif typ == N_MATCH:
                ptyp, ptext = prev[t - 1]
                toks.append((ptyp, ptext))
                parts.append(ptext)
            elif typ == N_ALPHA:
                s = cur(t, N_ALPHA).cstr()
                toks.append((N_ALPHA, s))
                parts.append(s)
            elif typ == N_CHAR:
                s = bytes([cur(t, N_CHAR).byte()])
                toks.append((N_CHAR, s))
                parts.append(s)
            elif typ == N_DIGITS:
                v = cur(t, N_DIGITS).u32()
                s = str(v).encode()
                toks.append((N_DIGITS, s))
                parts.append(s)
            elif typ == N_DIGITS0:
                v = cur(t, N_DIGITS0).u32()
                ln = cur(t, N_DZLEN).byte()
                s = str(v).encode().rjust(ln, b"0")
                toks.append((N_DIGITS0, s))
                parts.append(s)
            elif typ == N_DDELTA:
                d = cur(t, N_DDELTA).byte()
                v = int(prev[t - 1][1]) + d
                s = str(v).encode()
                toks.append((N_DIGITS, s))
                parts.append(s)
            elif typ == N_DDELTA0:
                d = cur(t, N_DDELTA0).byte()
                ptext = prev[t - 1][1]
                v = int(ptext) + d
                s = str(v).encode().rjust(len(ptext), b"0")
                toks.append((N_DIGITS0, s))
                parts.append(s)
            else:
                raise ValueError(f"tok3: unhandled token type {typ}")
            t += 1
        names.append(b"".join(parts))
        toks_per_name.append(toks)

    out = b"".join(nm + b"\x00" for nm in names)
    if len(out) != ulen:
        # some writers separate with '\n' instead of NUL
        alt = b"".join(nm + b"\n" for nm in names)
        if len(alt) == ulen:
            return alt
        raise ValueError(f"tok3: size mismatch ({len(out)} != {ulen})")
    return out
