"""Adaptive arithmetic codec (CRAM 3.1 block compression method 6).

Implements the order-0/order-1 adaptive range coder introduced by CRAM 3.1
(reference behavior: htslib cram/arith_dynamic.c and the hts-specs
CRAMcodecs document).  Building blocks:

* a carry-propagating byte-wise range coder (Shelwien/Subbotin style:
  32-bit range, 64-bit low catching the carry, renormalize below 2^24;
  the first emitted byte is the initial zero cache, so the decoder primes
  with five bytes),
* an adaptive frequency model (``ModelDecode``: +16 per hit, renormalize
  when the total exceeds 2^16-16, bubble-sort step toward the front),
* the same outer transforms as rANS-Nx16: striping (0x04), NoSize (0x08),
  raw pass-through (0x10), integrated run-length coding (0x20), bit-packing
  (0x40), plus an "external" mode (0x80) that stores a bzip2 stream.

Both directions are implemented so roundtrip tests cover every decode path.
"""

from __future__ import annotations

import bz2
from typing import List, Optional, Tuple

from clair3_tpu_torch.io.rans_nx16 import read_uint7, write_uint7

F_ORDER1 = 0x01
F_STRIPE = 0x04
F_NOSZ = 0x08
F_CAT = 0x10
F_RLE = 0x20
F_PACK = 0x40
F_EXT = 0x80

_MAX_TOTAL = (1 << 16) - 16
_STEP = 16


# ---------------------------------------------------------------------------
# range coder
# ---------------------------------------------------------------------------

class RangeEncoder:
    def __init__(self):
        self.low = 0          # 64-bit; bit 32 catches the carry
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.ffnum = 0
        self.out = bytearray()

    def _shift_low(self) -> None:
        carry = self.low >> 32
        if (self.low & 0xFFFFFFFF) < 0xFF000000 or carry:
            self.out.append((self.cache + carry) & 0xFF)
            while self.ffnum:
                self.out.append((0xFF + carry) & 0xFF)
                self.ffnum -= 1
            self.cache = (self.low >> 24) & 0xFF
        else:
            self.ffnum += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def encode(self, cum: int, freq: int, tot: int) -> None:
        r = self.range // tot
        self.low += cum * r
        self.range = freq * r
        while self.range < (1 << 24):
            self.range <<= 8
            self._shift_low()

    def finish(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class RangeDecoder:
    def __init__(self, data: bytes, p: int = 0):
        self.data = data
        self.p = p
        self.range = 0xFFFFFFFF
        code = 0
        for _ in range(5):
            code = ((code << 8) | self._byte()) & 0xFFFFFFFFFF
        self.code = code & 0xFFFFFFFF  # leading byte is the zero cache

    def _byte(self) -> int:
        if self.p < len(self.data):
            b = self.data[self.p]
            self.p += 1
            return b
        return 0

    def get_freq(self, tot: int) -> int:
        self.range //= tot
        return min(self.code // self.range, tot - 1)

    def decode(self, cum: int, freq: int) -> None:
        self.code -= cum * self.range
        self.range *= freq
        while self.range < (1 << 24):
            self.range <<= 8
            self.code = (self.code << 8) | self._byte()


# ---------------------------------------------------------------------------
# adaptive model
# ---------------------------------------------------------------------------

class SimpleModel:
    """Adaptive symbol model (htslib c_simple_model.h semantics)."""

    __slots__ = ("freqs", "syms", "total")

    def __init__(self, nsym: int):
        self.freqs = [1] * nsym
        self.syms = list(range(nsym))
        self.total = nsym

    def _bump(self, x: int) -> None:
        F = self.freqs
        F[x] += _STEP
        self.total += _STEP
        if self.total > _MAX_TOTAL:
            self.total = 0
            for i in range(len(F)):
                F[i] -= F[i] >> 1
                self.total += F[i]
        if x > 0 and F[x] > F[x - 1]:
            F[x], F[x - 1] = F[x - 1], F[x]
            S = self.syms
            S[x], S[x - 1] = S[x - 1], S[x]

    def encode(self, rc: RangeEncoder, sym: int) -> None:
        x = self.syms.index(sym)
        cum = sum(self.freqs[:x])
        rc.encode(cum, self.freqs[x], self.total)
        self._bump(x)

    def decode(self, rc: RangeDecoder) -> int:
        f = rc.get_freq(self.total)
        x = 0
        acc = 0
        F = self.freqs
        while acc + F[x] <= f:
            acc += F[x]
            x += 1
        rc.decode(acc, F[x])
        sym = self.syms[x]
        self._bump(x)
        return sym


# ---------------------------------------------------------------------------
# order-0 / order-1 / RLE cores
# ---------------------------------------------------------------------------

def _max_sym_byte(data: bytes) -> Tuple[int, int]:
    """(model size, header byte); header 0 encodes a full 256 alphabet."""
    m = (max(data) + 1) if data else 1
    return m, (m & 0xFF)


def _o0_encode(data: bytes) -> bytes:
    nsym, hdr = _max_sym_byte(data)
    model = SimpleModel(nsym)
    rc = RangeEncoder()
    for b in data:
        model.encode(rc, b)
    return bytes([hdr]) + rc.finish()


def _o0_decode(data: bytes, p: int, out_sz: int) -> bytes:
    nsym = data[p] or 256
    p += 1
    model = SimpleModel(nsym)
    rc = RangeDecoder(data, p)
    out = bytearray(out_sz)
    for i in range(out_sz):
        out[i] = model.decode(rc)
    return bytes(out)


def _o1_encode(data: bytes) -> bytes:
    nsym, hdr = _max_sym_byte(data)
    models = [SimpleModel(nsym) for _ in range(nsym)]
    rc = RangeEncoder()
    last = 0
    for b in data:
        models[last].encode(rc, b)
        last = b
    return bytes([hdr]) + rc.finish()


def _o1_decode(data: bytes, p: int, out_sz: int) -> bytes:
    nsym = data[p] or 256
    p += 1
    models = [SimpleModel(nsym) for _ in range(nsym)]
    rc = RangeDecoder(data, p)
    out = bytearray(out_sz)
    last = 0
    for i in range(out_sz):
        last = out[i] = models[last].decode(rc)
    return bytes(out)


def _rle_encode(data: bytes, order: int) -> bytes:
    # run-length chunk models: one per literal for the first chunk, then a
    # shared continuation context (nsym) and a deep-continuation one (nsym+1)
    nsym, hdr = _max_sym_byte(data)
    if order:
        lits = [SimpleModel(nsym) for _ in range(nsym)]
    else:
        lit0 = SimpleModel(nsym)
    runs = [SimpleModel(256) for _ in range(nsym + 2)]
    rc = RangeEncoder()
    n = len(data)
    i = 0
    last = 0
    while i < n:
        b = data[i]
        (lits[last] if order else lit0).encode(rc, b)
        last = b
        j = i + 1
        while j < n and data[j] == b:
            j += 1
        run = j - i - 1
        rctx = b
        while True:
            part = min(run, 255)
            runs[rctx].encode(rc, part)
            run -= part
            rctx = nsym if rctx == b else nsym + 1
            if part != 255:
                break
        i = j
    return bytes([hdr]) + rc.finish()


def _rle_decode(data: bytes, p: int, out_sz: int, order: int) -> bytes:
    nsym = data[p] or 256
    p += 1
    if order:
        lits = [SimpleModel(nsym) for _ in range(nsym)]
    else:
        lit0 = SimpleModel(nsym)
    runs = [SimpleModel(256) for _ in range(nsym + 2)]
    rc = RangeDecoder(data, p)
    out = bytearray(out_sz)
    i = 0
    last = 0
    while i < out_sz:
        b = (lits[last] if order else lit0).decode(rc)
        last = b
        out[i] = b
        i += 1
        run = 0
        rctx = b
        while True:
            part = runs[rctx].decode(rc)
            run += part
            rctx = nsym if rctx == b else nsym + 1
            if part != 255:
                break
        if i + run > out_sz:
            raise ValueError("arith RLE run overrun")
        for _ in range(run):
            out[i] = b
            i += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def arith_decompress(payload: bytes, out_sz_hint: Optional[int] = None) -> bytes:
    data = payload
    p = 0
    flags = data[p]
    p += 1
    if flags & F_NOSZ:
        if out_sz_hint is None:
            raise ValueError("NoSize arith stream requires an output-size hint")
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
            subs.append(arith_decompress(data[p: p + clens[j]], ulen))
            p += clens[j]
        out = bytearray(out_sz)
        for j in range(X):
            out[j::X] = subs[j]
        return bytes(out)

    pack_meta = None
    if flags & F_PACK:
        final_len = out_sz
        nsym = data[p]
        p += 1
        P = list(data[p: p + nsym])
        p += nsym
        out_sz, p = read_uint7(data, p)
        pack_meta = (P, nsym, final_len)

    if flags & F_CAT:
        buf = data[p: p + out_sz]
        if len(buf) != out_sz:
            raise ValueError("truncated arith CAT data")
    elif flags & F_EXT:
        buf = bz2.decompress(data[p:])
        if len(buf) != out_sz:
            raise ValueError("arith EXT size mismatch")
    elif out_sz == 0:
        buf = b""
    elif flags & F_RLE:
        buf = _rle_decode(data, p, out_sz, flags & F_ORDER1)
    elif flags & F_ORDER1:
        buf = _o1_decode(data, p, out_sz)
    else:
        buf = _o0_decode(data, p, out_sz)

    if pack_meta is not None:
        from clair3_tpu_torch.io.rans_nx16 import _pack_decode

        P, nsym, final_len = pack_meta
        buf = _pack_decode(buf, P, nsym, final_len)
    return buf


def arith_compress(data: bytes, flags: int = F_ORDER1,
                   no_size: bool = False) -> bytes:
    n = len(data)
    eff = flags

    if eff & F_STRIPE:
        X = 4
        head = bytearray()
        head.append(F_STRIPE | (F_NOSZ if no_size else 0))
        if not no_size:
            head += write_uint7(n)
        head.append(X)
        subs = [arith_compress(data[j::X], (eff & ~F_STRIPE) | F_NOSZ,
                               no_size=True) for j in range(X)]
        for sub in subs:
            head += write_uint7(len(sub))
        return bytes(head) + b"".join(subs)

    payload = data
    pack_bytes = b""
    if eff & F_PACK:
        from clair3_tpu_torch.io.rans_nx16 import _pack_encode

        packed = _pack_encode(payload)
        if packed is None:
            eff &= ~F_PACK
        else:
            meta, payload = packed
            pack_bytes = meta + write_uint7(len(payload))

    out = bytearray()
    out.append((eff & 0xFF) | (F_NOSZ if no_size else 0))
    if not no_size:
        out += write_uint7(n)
    out += pack_bytes
    if eff & F_CAT:
        out += payload
    elif eff & F_EXT:
        out += bz2.compress(bytes(payload))
    elif len(payload) == 0:
        pass
    elif eff & F_RLE:
        out += _rle_encode(payload, eff & F_ORDER1)
    elif eff & F_ORDER1:
        out += _o1_encode(payload)
    else:
        out += _o0_encode(payload)
    return bytes(out)
