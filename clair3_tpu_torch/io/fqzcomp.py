"""fqzcomp quality codec (CRAM 3.1 block compression method 7).

Implements the FQZComp-derived adaptive quality-string codec of CRAM 3.1
(reference behavior: htslib cram/fqzcomp_qual.c and the hts-specs
CRAMcodecs document).  Qualities are range-coded with one adaptive model
per 16-bit context; the context mixes a shifted window of recent quality
values with optional position (ptab), delta (dtab) and selector components.
Record lengths, reverse flags, duplicate flags and selectors are coded with
their own adaptive models inside the same range-coded stream.

The decoder supports the full parameter surface (multiple parameter sets,
selector table, qmap/qtab/ptab/dtab, dedup, reverse).  The encoder emits a
single-parameter-set stream (quality-history context only) so roundtrip
tests cover the core decode paths; richer parameter blocks are exercised by
dedicated multi-param tests.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from clair3_tpu_torch.io.arith import RangeDecoder, RangeEncoder, SimpleModel

FQZ_VERS = 5

GFLAG_MULTI_PARAM = 1
GFLAG_HAVE_STAB = 2
GFLAG_DO_REV = 4

PFLAG_DO_DEDUP = 2
PFLAG_DO_LEN = 4
PFLAG_DO_SEL = 8
PFLAG_HAVE_QMAP = 16
PFLAG_HAVE_PTAB = 32
PFLAG_HAVE_DTAB = 64
PFLAG_HAVE_QTAB = 128


# ---------------------------------------------------------------------------
# monotone-array coding (htslib store_array/read_array)
# ---------------------------------------------------------------------------

def store_array(values: List[int], size: int) -> bytes:
    """RLE for a monotonically non-decreasing array: for each target value
    j = 0,1,2,... emit the run length of entries equal to j (255-chained)."""
    out = bytearray()
    i = 0
    j = 0
    while i < size:
        run = 0
        while i < size and values[i] == j:
            run += 1
            i += 1
        while run >= 255:
            out.append(255)
            run -= 255
        out.append(run)
        j += 1
    return bytes(out)


def read_array(data: bytes, p: int, size: int) -> tuple:
    values = [0] * size
    z = 0
    j = 0
    while z < size:
        run = 0
        while True:
            r = data[p]
            p += 1
            run += r
            if r != 255:
                break
        while run > 0 and z < size:
            values[z] = j
            z += 1
            run -= 1
        j += 1
    return values, p


# ---------------------------------------------------------------------------
# parameter block
# ---------------------------------------------------------------------------

class FqzParam:
    __slots__ = ("context", "pflags", "max_sym", "qbits", "qshift", "qloc",
                 "sloc", "ploc", "dloc", "qmap", "qtab", "ptab", "dtab",
                 "qmask", "nsym", "fixed_len")

    def __init__(self):
        self.context = 0
        self.pflags = 0
        self.max_sym = 64
        self.qbits = 12
        self.qshift = 5
        self.qloc = 0
        self.sloc = 0
        self.ploc = 0
        self.dloc = 0
        self.qmap: List[int] = []
        self.qtab: List[int] = list(range(256))
        self.ptab: List[int] = [0] * 1024
        self.dtab: List[int] = [0] * 256
        self.qmask = 0
        self.nsym = 0
        self.fixed_len = 0

    def finish(self) -> None:
        self.qmask = (1 << self.qbits) - 1
        self.nsym = self.max_sym if self.max_sym > 0 else 256


def _read_param(data: bytes, p: int):
    pm = FqzParam()
    pm.context = data[p] | (data[p + 1] << 8)
    pm.pflags = data[p + 2]
    pm.max_sym = data[p + 3]
    x = data[p + 4]
    pm.qbits, pm.qshift = x >> 4, x & 15
    x = data[p + 5]
    pm.qloc, pm.sloc = x >> 4, x & 15
    x = data[p + 6]
    pm.ploc, pm.dloc = x >> 4, x & 15
    p += 7
    if pm.pflags & PFLAG_HAVE_QMAP:
        pm.qmap = list(data[p: p + pm.max_sym])
        p += pm.max_sym
    if pm.pflags & PFLAG_HAVE_QTAB:
        pm.qtab, p = read_array(data, p, 256)
    if pm.pflags & PFLAG_HAVE_PTAB:
        pm.ptab, p = read_array(data, p, 1024)
    if pm.pflags & PFLAG_HAVE_DTAB:
        pm.dtab, p = read_array(data, p, 256)
    pm.finish()
    return pm, p


def _write_param(pm: FqzParam) -> bytes:
    out = bytearray()
    out.append(pm.context & 0xFF)
    out.append((pm.context >> 8) & 0xFF)
    out.append(pm.pflags)
    out.append(pm.max_sym & 0xFF)
    out.append((pm.qbits << 4) | pm.qshift)
    out.append((pm.qloc << 4) | pm.sloc)
    out.append((pm.ploc << 4) | pm.dloc)
    if pm.pflags & PFLAG_HAVE_QMAP:
        out += bytes(pm.qmap[: pm.max_sym])
    if pm.pflags & PFLAG_HAVE_QTAB:
        out += store_array(pm.qtab, 256)
    if pm.pflags & PFLAG_HAVE_PTAB:
        out += store_array(pm.ptab, 1024)
    if pm.pflags & PFLAG_HAVE_DTAB:
        out += store_array(pm.dtab, 256)
    return bytes(out)


class _QualModels:
    """Lazily-allocated per-context quality models (up to 2^16 contexts)."""

    def __init__(self, nsym: int):
        self.nsym = nsym
        self.models: Dict[int, SimpleModel] = {}

    def get(self, ctx: int) -> SimpleModel:
        m = self.models.get(ctx)
        if m is None:
            m = SimpleModel(self.nsym)
            self.models[ctx] = m
        return m


def _update_ctx(pm: FqzParam, state: dict, q: int) -> int:
    """fqzcomp_qual.c fqz_update_ctx: mix quality history, position, delta
    and selector into the next 16-bit context."""
    state["qctx"] = ((state["qctx"] << pm.qshift) + pm.qtab[q]) & 0xFFFFFFFF
    last = pm.context
    last += (state["qctx"] & pm.qmask) << pm.qloc
    if pm.pflags & PFLAG_HAVE_PTAB:
        last += pm.ptab[min(1023, state["p"])] << pm.ploc
    if pm.pflags & PFLAG_HAVE_DTAB:
        last += pm.dtab[min(255, state["delta"])] << pm.dloc
    if pm.pflags & PFLAG_DO_SEL:
        last += state["s"] << pm.sloc
    state["p"] -= 1
    state["delta"] += 1 if state["prevq"] != q else 0
    state["prevq"] = q
    return last & 0xFFFF


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def fqzcomp_decompress(payload: bytes, out_sz: int) -> bytes:
    data = payload
    p = 0
    vers = data[p]
    p += 1
    if vers != FQZ_VERS:
        raise ValueError(f"fqzcomp version {vers} unsupported (expect 5)")
    gflags = data[p]
    p += 1
    nparam = 1
    if gflags & GFLAG_MULTI_PARAM:
        nparam = data[p]
        p += 1
    max_sel = nparam - 1 if nparam > 1 else 0
    stab = list(range(256))
    if gflags & GFLAG_HAVE_STAB:
        max_sel = data[p]
        p += 1
        stab, p = read_array(data, p, 256)
    params: List[FqzParam] = []
    for _ in range(nparam):
        pm, p = _read_param(data, p)
        params.append(pm)

    quals = [_QualModels(pm.nsym) for pm in params]
    model_len = [SimpleModel(256) for _ in range(4)]
    model_rev = SimpleModel(2)
    model_dup = SimpleModel(2)
    model_sel = SimpleModel(max_sel + 1)

    rc = RangeDecoder(data, p)
    out = bytearray(out_sz)
    rec_starts: List[tuple] = []  # (start, length, reversed)
    state = {"p": 0, "delta": 0, "prevq": 0, "qctx": 0, "s": 0}
    pm = params[0]
    qm = quals[0]
    ctx = pm.context
    rec_len = 0
    first_len = True
    i = 0
    while i < out_sz:
        if state["p"] == 0:
            # --- new record ---
            s = 0
            if max_sel > 0:
                s = model_sel.decode(rc)
            x = stab[s] if s < 256 else 0
            if x >= nparam:
                raise ValueError("fqzcomp selector out of range")
            pm = params[x]
            qm = quals[x]
            if first_len or (pm.pflags & PFLAG_DO_LEN):
                rec_len = (model_len[0].decode(rc)
                           | (model_len[1].decode(rc) << 8)
                           | (model_len[2].decode(rc) << 16)
                           | (model_len[3].decode(rc) << 24))
                first_len = False
                pm.fixed_len = rec_len
            else:
                rec_len = pm.fixed_len
            if rec_len <= 0 or i + rec_len > out_sz:
                raise ValueError("fqzcomp record length overruns output")
            rev = 0
            if gflags & GFLAG_DO_REV:
                rev = model_rev.decode(rc)
            rec_starts.append((i, rec_len, rev))
            if pm.pflags & PFLAG_DO_DEDUP:
                if model_dup.decode(rc):
                    if not rec_starts or len(rec_starts) < 2:
                        raise ValueError("fqzcomp dup of first record")
                    ps, pl, _ = rec_starts[-2]
                    if pl != rec_len:
                        raise ValueError("fqzcomp dup length mismatch")
                    out[i: i + rec_len] = out[ps: ps + rec_len]
                    i += rec_len
                    continue
            state = {"p": rec_len, "delta": 0, "prevq": 0, "qctx": 0, "s": s}
            ctx = pm.context

        q = qm.get(ctx).decode(rc)
        out[i] = pm.qmap[q] if (pm.pflags & PFLAG_HAVE_QMAP) else q
        i += 1
        ctx = _update_ctx(pm, state, q)

    if gflags & GFLAG_DO_REV:
        for rs, rl, rev in rec_starts:
            if rev:
                out[rs: rs + rl] = out[rs: rs + rl][::-1]
    return bytes(out)


# ---------------------------------------------------------------------------
# encode
# ---------------------------------------------------------------------------

def fqzcomp_compress(data: bytes, lengths: Optional[List[int]] = None) -> bytes:
    """Encode quality bytes.  `lengths` gives per-record lengths (must sum
    to len(data)); omitted, the whole block is one record."""
    n = len(data)
    if lengths is None:
        lengths = [n] if n else []
    if sum(lengths) != n:
        raise ValueError("record lengths do not sum to data size")

    pm = FqzParam()
    pm.context = 0
    pm.pflags = PFLAG_DO_LEN if len(lengths) > 1 else 0
    pm.max_sym = (max(data) + 1) if n else 1
    if pm.max_sym > 255:
        pm.max_sym = 0  # 256 coded as 0
    # quality-history-only context: fit shift to alphabet width
    span = pm.max_sym if pm.max_sym else 256
    shift = max(1, (span - 1).bit_length())
    pm.qshift = min(15, shift)
    pm.qbits = min(15, 2 * pm.qshift)
    pm.qloc = 0
    pm.finish()

    out = bytearray()
    out.append(FQZ_VERS)
    out.append(0)  # gflags: single param, no stab, no rev
    out += _write_param(pm)

    qm = _QualModels(pm.nsym)
    model_len = [SimpleModel(256) for _ in range(4)]
    rc = RangeEncoder()
    i = 0
    first_len = True
    for rec_len in lengths:
        if first_len or (pm.pflags & PFLAG_DO_LEN):
            model_len[0].encode(rc, rec_len & 0xFF)
            model_len[1].encode(rc, (rec_len >> 8) & 0xFF)
            model_len[2].encode(rc, (rec_len >> 16) & 0xFF)
            model_len[3].encode(rc, (rec_len >> 24) & 0xFF)
            first_len = False
        state = {"p": rec_len, "delta": 0, "prevq": 0, "qctx": 0, "s": 0}
        ctx = pm.context
        for _ in range(rec_len):
            q = data[i]
            i += 1
            qm.get(ctx).encode(rc, q)
            ctx = _update_ctx(pm, state, q)
    out += rc.finish()
    return bytes(out)
