"""CRAM 3.0 reader and writer (self-contained, stdlib + io.rans).

The reference supports CRAM input via htslib (reference: README.md:127
"support importing CRAM", run_clair3.py --bam_fn accepts .cram); this module
gives the TPU-native pipeline the same capability without htslib.

Scope:
* Reader: CRAM 3.0 containers, gzip / bzip2 / lzma / rANS-4x8 / raw block
  compression, codecs EXTERNAL / HUFFMAN / BETA / BYTE_ARRAY_LEN /
  BYTE_ARRAY_STOP, reference-based and referenceless records, detached and
  downstream mates, read feature reconstruction (B X I D i S H P N Q b q),
  tag dictionaries.
* Writer: reference-based CRAM 3.0 (used by tests and `bam_to_cram`), one
  slice per container, gzip + rANS blocks.
* ``cram_to_bam``: conversion entry used by the pipeline so the native BAM
  extractors (and their .bai windowed loads) run unchanged on CRAM input.

Coordinates follow the spec: alignment positions inside CRAM are 1-based;
BamRead.pos is 0-based.
"""

from __future__ import annotations

import bz2
import gzip
import lzma
import struct
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from clair3_tpu_torch.io.bam import BamRead, _encode_tags, _parse_tags
from clair3_tpu_torch.io.rans import rans_compress, rans_decompress

CRAM_MAGIC = b"CRAM"

# spec-defined CRAM 3.0 EOF container bytes
CRAM_EOF = bytes.fromhex(
    "0f000000ffffffff0fe0454f4600000000010005bdd94f0001000606010001"
    "000100ee63014b")

# block compression methods (3.1 adds rANS-Nx16, adaptive arithmetic,
# fqzcomp and the name tokeniser)
M_RAW, M_GZIP, M_BZIP2, M_LZMA, M_RANS = 0, 1, 2, 3, 4
M_RANSNX16, M_ARITH, M_FQZCOMP, M_TOK3 = 5, 6, 7, 8

# block content types
CT_FILE_HEADER, CT_COMPRESSION_HEADER, CT_SLICE_HEADER = 0, 1, 2
CT_EXTERNAL, CT_CORE = 4, 5

# codec ids
C_EXTERNAL, C_HUFFMAN, C_BYTE_ARRAY_LEN, C_BYTE_ARRAY_STOP, C_BETA = 1, 3, 4, 5, 6

BASES5 = "ACGTN"


# ---------------------------------------------------------------------------
# ITF8 / LTF8
# ---------------------------------------------------------------------------

def write_itf8(v: int) -> bytes:
    v &= 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([(v >> 8) | 0x80, v & 0xFF])
    if v < 0x200000:
        return bytes([(v >> 16) | 0xC0, (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([(v >> 24) | 0xE0, (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF])
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF, (v >> 12) & 0xFF,
                  (v >> 4) & 0xFF, v & 0x0F])


def read_itf8(data: bytes, p: int) -> Tuple[int, int]:
    b0 = data[p]
    if b0 < 0x80:
        v = b0
        p += 1
    elif b0 < 0xC0:
        v = ((b0 & 0x7F) << 8) | data[p + 1]
        p += 2
    elif b0 < 0xE0:
        v = ((b0 & 0x3F) << 16) | (data[p + 1] << 8) | data[p + 2]
        p += 3
    elif b0 < 0xF0:
        v = ((b0 & 0x1F) << 24) | (data[p + 1] << 16) | (data[p + 2] << 8) | data[p + 3]
        p += 4
    else:
        v = ((b0 & 0x0F) << 28) | (data[p + 1] << 20) | (data[p + 2] << 12) \
            | (data[p + 3] << 4) | (data[p + 4] & 0x0F)
        p += 5
    if v & 0x80000000:  # negative int32
        v -= 1 << 32
    return v, p


def write_ltf8(v: int) -> bytes:
    v &= 0xFFFFFFFFFFFFFFFF
    if v < 0x80:
        return bytes([v])
    for n in range(1, 8):
        if v < (1 << (7 * (n + 1))):
            prefix = (0xFF << (8 - n)) & 0xFF
            return bytes([prefix | (v >> (8 * n))]) + v.to_bytes(8, "big")[-n:]
    return bytes([0xFF]) + v.to_bytes(8, "big")


def read_ltf8(data: bytes, p: int) -> Tuple[int, int]:
    b0 = data[p]
    n = 0
    while n < 8 and (b0 << n) & 0x80:
        n += 1
    if n == 0:
        return b0, p + 1
    if n < 8:
        v = b0 & (0xFF >> (n + 1))
        for k in range(n):
            v = (v << 8) | data[p + 1 + k]
    else:
        v = int.from_bytes(data[p + 1: p + 9], "big")
    p += 1 + n
    if v & (1 << 63):
        v -= 1 << 64
    return v, p


def _write_array_itf8(vals: Sequence[int]) -> bytes:
    out = write_itf8(len(vals))
    for v in vals:
        out += write_itf8(v)
    return out


def _read_array_itf8(data: bytes, p: int) -> Tuple[List[int], int]:
    n, p = read_itf8(data, p)
    out = []
    for _ in range(n):
        v, p = read_itf8(data, p)
        out.append(v)
    return out, p


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

@dataclass
class Block:
    method: int
    content_type: int
    content_id: int
    data: bytes  # uncompressed


def _compress(method: int, data: bytes) -> bytes:
    if method == M_RAW:
        return data
    if method == M_GZIP:
        return gzip.compress(data, 6)
    if method == M_BZIP2:
        return bz2.compress(data)
    if method == M_LZMA:
        return lzma.compress(data)
    if method == M_RANS:
        return rans_compress(data, order=1 if len(data) >= 4 else 0)
    if method == M_RANSNX16:
        from clair3_tpu_torch.io.rans_nx16 import F_ORDER1, rans_nx16_compress

        return rans_nx16_compress(data, F_ORDER1 if len(data) >= 32 else 0)
    if method == M_ARITH:
        from clair3_tpu_torch.io.arith import F_ORDER1 as A_O1, arith_compress

        return arith_compress(data, A_O1 if len(data) >= 32 else 0)
    if method == M_TOK3:
        from clair3_tpu_torch.io.tok3 import tok3_compress

        return tok3_compress(data)
    raise ValueError(f"unsupported compression method {method}")


def _decompress(method: int, data: bytes, raw_size: int) -> bytes:
    if method == M_RAW:
        return data
    if method == M_GZIP:
        return gzip.decompress(data)
    if method == M_BZIP2:
        return bz2.decompress(data)
    if method == M_LZMA:
        return lzma.decompress(data)
    if method == M_RANS:
        return rans_decompress(data)
    if method == M_RANSNX16:
        from clair3_tpu_torch.io.rans_nx16 import rans_nx16_decompress

        return rans_nx16_decompress(data, raw_size)
    if method == M_ARITH:
        from clair3_tpu_torch.io.arith import arith_decompress

        return arith_decompress(data, raw_size)
    if method == M_FQZCOMP:
        from clair3_tpu_torch.io.fqzcomp import fqzcomp_decompress

        return fqzcomp_decompress(data, raw_size)
    if method == M_TOK3:
        from clair3_tpu_torch.io.tok3 import tok3_decompress

        return tok3_decompress(data)
    raise ValueError(
        f"unsupported CRAM block compression method {method} "
        "(supported: raw, gzip, bzip2, lzma, rANS4x8, rANS-Nx16, arith, "
        "fqzcomp, tok3)")


def write_block(block: Block, method: int) -> bytes:
    comp = _compress(method, block.data)
    if len(comp) >= len(block.data):
        method, comp = M_RAW, block.data
    head = bytes([method, block.content_type]) + write_itf8(block.content_id) \
        + write_itf8(len(comp)) + write_itf8(len(block.data))
    body = head + comp
    crc = zlib.crc32(body) & 0xFFFFFFFF
    return body + struct.pack("<I", crc)


def read_block(data: bytes, p: int) -> Tuple[Block, int]:
    method = data[p]
    ctype = data[p + 1]
    cid, q = read_itf8(data, p + 2)
    comp_sz, q = read_itf8(data, q)
    raw_sz, q = read_itf8(data, q)
    comp = data[q: q + comp_sz]
    q += comp_sz
    q += 4  # CRC32 (not verified; bgzf-level corruption already surfaces)
    raw = _decompress(method, comp, raw_sz)
    if len(raw) != raw_sz:
        raise ValueError(f"CRAM block raw size mismatch ({len(raw)} != {raw_sz})")
    return Block(method, ctype, cid, raw), q


# ---------------------------------------------------------------------------
# bit I/O for the core block
# ---------------------------------------------------------------------------

class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.p = 0
        self.bit = 0

    def read(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self.data[self.p]
            v = (v << 1) | ((byte >> (7 - self.bit)) & 1)
            self.bit += 1
            if self.bit == 8:
                self.bit = 0
                self.p += 1
        return v


class BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.nbits = 0

    def write(self, value: int, nbits: int) -> None:
        for k in range(nbits - 1, -1, -1):
            self.cur = (self.cur << 1) | ((value >> k) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.cur)
                self.cur = 0
                self.nbits = 0

    def getvalue(self) -> bytes:
        if self.nbits:
            return bytes(self.out) + bytes([self.cur << (8 - self.nbits)])
        return bytes(self.out)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

class Codec:
    """Decodes ints or byte arrays from the core bit stream / external
    blocks (spec section 13)."""

    def __init__(self, codec_id: int, params: bytes):
        self.id = codec_id
        p = 0
        if codec_id == C_EXTERNAL:
            self.content_id, _ = read_itf8(params, 0)
        elif codec_id == C_HUFFMAN:
            self.alphabet, p = _read_array_itf8(params, 0)
            self.bit_lens, p = _read_array_itf8(params, p)
            self._build_huffman()
        elif codec_id == C_BETA:
            self.offset, p = read_itf8(params, 0)
            self.nbits, p = read_itf8(params, p)
        elif codec_id == C_BYTE_ARRAY_LEN:
            # params: <encoding for lengths><encoding for values>
            self.len_codec, p = _read_codec(params, 0)
            self.val_codec, p = _read_codec(params, p)
        elif codec_id == C_BYTE_ARRAY_STOP:
            self.stop = params[0]
            self.content_id, _ = read_itf8(params, 1)
        else:
            raise ValueError(f"unsupported CRAM codec id {codec_id}")

    def _build_huffman(self):
        # canonical codes: sort by (bit length, symbol order of appearance)
        syms = sorted(range(len(self.alphabet)), key=lambda i: (self.bit_lens[i], i))
        self.codes = {}
        code, prev_len = 0, 0
        for i in syms:
            ln = self.bit_lens[i]
            code <<= (ln - prev_len)
            self.codes[self.alphabet[i]] = (code, ln)
            prev_len = ln
            code += 1
        # decode table: (length, code) -> symbol
        self.dec = {(ln, c): s for s, (c, ln) in self.codes.items()}
        self.max_len = max(self.bit_lens) if self.bit_lens else 0

    # ---- int decode ----
    def read_int(self, core: BitReader, ext: Dict[int, "ByteStream"]) -> int:
        if self.id == C_EXTERNAL:
            v, _ = read_itf8_stream(ext[self.content_id])
            return v
        if self.id == C_HUFFMAN:
            if self.max_len == 0:
                return self.alphabet[0]
            code, ln = 0, 0
            while ln <= self.max_len:
                code = (code << 1) | core.read(1)
                ln += 1
                hit = self.dec.get((ln, code))
                if hit is not None:
                    return hit
            raise ValueError("bad huffman code")
        if self.id == C_BETA:
            return core.read(self.nbits) - self.offset
        raise ValueError(f"codec {self.id} cannot decode ints")

    # ---- byte decode (single byte as int) ----
    def read_byte(self, core: BitReader, ext: Dict[int, "ByteStream"]) -> int:
        if self.id == C_EXTERNAL:
            return ext[self.content_id].read(1)[0]
        return self.read_int(core, ext)

    # ---- byte array decode ----
    def read_bytes(self, core: BitReader, ext: Dict[int, "ByteStream"],
                   length: Optional[int] = None) -> bytes:
        if self.id == C_BYTE_ARRAY_STOP:
            return ext[self.content_id].read_until(self.stop)
        if self.id == C_BYTE_ARRAY_LEN:
            n = self.len_codec.read_int(core, ext)
            vc = self.val_codec
            if vc.id == C_EXTERNAL:
                return ext[vc.content_id].read(n)
            return bytes(vc.read_byte(core, ext) for _ in range(n))
        if self.id == C_EXTERNAL:
            if length is None:
                raise ValueError("EXTERNAL byte array needs explicit length")
            return ext[self.content_id].read(length)
        raise ValueError(f"codec {self.id} cannot decode byte arrays")


def _read_codec(data: bytes, p: int) -> Tuple[Codec, int]:
    cid, p = read_itf8(data, p)
    plen, p = read_itf8(data, p)
    return Codec(cid, data[p: p + plen]), p + plen


def _enc_codec(codec_id: int, params: bytes) -> bytes:
    return write_itf8(codec_id) + write_itf8(len(params)) + params


def enc_external(content_id: int) -> bytes:
    return _enc_codec(C_EXTERNAL, write_itf8(content_id))


def enc_byte_array_stop(stop: int, content_id: int) -> bytes:
    return _enc_codec(C_BYTE_ARRAY_STOP, bytes([stop]) + write_itf8(content_id))


def enc_byte_array_len_external(len_id: int, val_id: int) -> bytes:
    return _enc_codec(C_BYTE_ARRAY_LEN, enc_external(len_id) + enc_external(val_id))


class ByteStream:
    __slots__ = ("data", "p")

    def __init__(self, data: bytes):
        self.data = data
        self.p = 0

    def read(self, n: int) -> bytes:
        out = self.data[self.p: self.p + n]
        if len(out) != n:
            raise ValueError("external block underflow")
        self.p += n
        return out

    def read_until(self, stop: int) -> bytes:
        q = self.data.index(stop, self.p)
        out = self.data[self.p: q]
        self.p = q + 1
        return out


def read_itf8_stream(s: ByteStream) -> Tuple[int, int]:
    v, q = read_itf8(s.data, s.p)
    s.p = q
    return v, q


# ---------------------------------------------------------------------------
# compression header
# ---------------------------------------------------------------------------

@dataclass
class CompressionHeader:
    rn_preserved: bool = True
    ap_delta: bool = True
    ref_required: bool = True
    substitution_matrix: bytes = bytes([0x1B] * 5)
    tag_dict: List[List[Tuple[str, str]]] = field(default_factory=lambda: [[]])
    data_series: Dict[str, Codec] = field(default_factory=dict)
    tag_codecs: Dict[int, Codec] = field(default_factory=dict)

    def sub_base(self, ref_base: str, code: int) -> str:
        """BS code -> substituted base given the reference base."""
        r = BASES5.find(ref_base)
        if r < 0:
            r = 4
        row = self.substitution_matrix[r]
        alts = [b for b in BASES5 if b != BASES5[r]]
        for k, alt in enumerate(alts):
            if ((row >> (6 - 2 * k)) & 3) == code:
                return alt
        return "N"

    def sub_code(self, ref_base: str, read_base: str) -> Optional[int]:
        r = BASES5.find(ref_base)
        if r < 0:
            r = 4
        row = self.substitution_matrix[r]
        alts = [b for b in BASES5 if b != BASES5[r]]
        for k, alt in enumerate(alts):
            if alt == read_base:
                return (row >> (6 - 2 * k)) & 3
        return None


def parse_compression_header(data: bytes) -> CompressionHeader:
    h = CompressionHeader()
    p = 0
    # preservation map
    _size, p = read_itf8(data, p)
    n, p = read_itf8(data, p)
    for _ in range(n):
        key = data[p: p + 2].decode()
        p += 2
        if key == "RN":
            h.rn_preserved = bool(data[p]); p += 1  # noqa: E702
        elif key == "AP":
            h.ap_delta = bool(data[p]); p += 1  # noqa: E702
        elif key == "RR":
            h.ref_required = bool(data[p]); p += 1  # noqa: E702
        elif key == "SM":
            h.substitution_matrix = data[p: p + 5]; p += 5  # noqa: E702
        elif key == "TD":
            blen, p = read_itf8(data, p)
            blob = data[p: p + blen]
            p += blen
            h.tag_dict = []
            for entry in blob.split(b"\x00")[:-1] if blob.endswith(b"\x00") else blob.split(b"\x00"):
                tags = []
                for i in range(0, len(entry), 3):
                    trip = entry[i: i + 3]
                    tags.append((trip[:2].decode(), chr(trip[2])))
                h.tag_dict.append(tags)
            if not h.tag_dict:
                h.tag_dict = [[]]
        else:
            raise ValueError(f"unknown preservation map key {key!r}")
    # data series encodings
    _size, p = read_itf8(data, p)
    n, p = read_itf8(data, p)
    for _ in range(n):
        key = data[p: p + 2].decode()
        p += 2
        codec, p = _read_codec(data, p)
        h.data_series[key] = codec
    # tag encodings
    _size, p = read_itf8(data, p)
    n, p = read_itf8(data, p)
    for _ in range(n):
        key, p = read_itf8(data, p)
        codec, p = _read_codec(data, p)
        h.tag_codecs[key] = codec
    return h


def build_compression_header(h: CompressionHeader,
                             series_params: Dict[str, bytes],
                             tag_params: Dict[int, bytes]) -> bytes:
    pres = bytearray()
    entries = [(b"RN", bytes([int(h.rn_preserved)])),
               (b"AP", bytes([int(h.ap_delta)])),
               (b"RR", bytes([int(h.ref_required)])),
               (b"SM", h.substitution_matrix)]
    td_blob = bytearray()
    for tags in h.tag_dict:
        for name, typ in tags:
            td_blob += name.encode() + typ.encode()
        td_blob += b"\x00"
    entries.append((b"TD", write_itf8(len(td_blob)) + bytes(td_blob)))
    body = write_itf8(len(entries))
    for k, v in entries:
        body += k + v
    pres += write_itf8(len(body)) + body

    ds = write_itf8(len(series_params))
    for key, enc in series_params.items():
        ds = ds + key.encode() + enc
    ds_full = write_itf8(len(ds)) + ds

    tg = write_itf8(len(tag_params))
    for key, enc in tag_params.items():
        tg = tg + write_itf8(key) + enc
    tg_full = write_itf8(len(tg)) + tg
    return bytes(pres) + ds_full + tg_full


# ---------------------------------------------------------------------------
# containers
# ---------------------------------------------------------------------------

@dataclass
class ContainerHeader:
    length: int
    ref_seq_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    bases: int
    n_blocks: int
    landmarks: List[int]


def read_container_header(fh) -> Optional[ContainerHeader]:
    raw = fh.read(4)
    if len(raw) < 4:
        return None
    (length,) = struct.unpack("<i", raw)
    # the rest of the header is ITF8/LTF8; read a bounded chunk
    buf = fh.read(64 * 1024)
    p = 0
    ref_seq_id, p = read_itf8(buf, p)
    start, p = read_itf8(buf, p)
    span, p = read_itf8(buf, p)
    n_records, p = read_itf8(buf, p)
    record_counter, p = read_ltf8(buf, p)
    bases, p = read_ltf8(buf, p)
    n_blocks, p = read_itf8(buf, p)
    landmarks, p = _read_array_itf8(buf, p)
    p += 4  # crc32
    fh.seek(p - len(buf), 1)
    return ContainerHeader(length, ref_seq_id, start, span, n_records,
                           record_counter, bases, n_blocks, landmarks)


def _container_bytes(ref_seq_id: int, start: int, span: int, n_records: int,
                     record_counter: int, bases: int, n_blocks: int,
                     landmarks: List[int], payload: bytes) -> bytes:
    head = write_itf8(ref_seq_id) + write_itf8(start) + write_itf8(span) \
        + write_itf8(n_records) + write_ltf8(record_counter) \
        + write_ltf8(bases) + write_itf8(n_blocks) + _write_array_itf8(landmarks)
    full = struct.pack("<i", len(payload)) + head
    crc = zlib.crc32(full) & 0xFFFFFFFF  # CRC over length + header fields
    return full + struct.pack("<I", crc) + payload


# ---------------------------------------------------------------------------
# slice header
# ---------------------------------------------------------------------------

@dataclass
class SliceHeader:
    ref_seq_id: int
    start: int
    span: int
    n_records: int
    record_counter: int
    n_blocks: int
    content_ids: List[int]
    embedded_ref_id: int
    ref_md5: bytes


def parse_slice_header(data: bytes) -> SliceHeader:
    p = 0
    ref_seq_id, p = read_itf8(data, p)
    start, p = read_itf8(data, p)
    span, p = read_itf8(data, p)
    n_records, p = read_itf8(data, p)
    record_counter, p = read_ltf8(data, p)
    n_blocks, p = read_itf8(data, p)
    content_ids, p = _read_array_itf8(data, p)
    embedded_ref_id, p = read_itf8(data, p)
    ref_md5 = data[p: p + 16]
    return SliceHeader(ref_seq_id, start, span, n_records, record_counter,
                       n_blocks, content_ids, embedded_ref_id, ref_md5)


def build_slice_header(s: SliceHeader) -> bytes:
    return write_itf8(s.ref_seq_id) + write_itf8(s.start) + write_itf8(s.span) \
        + write_itf8(s.n_records) + write_ltf8(s.record_counter) \
        + write_itf8(s.n_blocks) + _write_array_itf8(s.content_ids) \
        + write_itf8(s.embedded_ref_id) + s.ref_md5


# ---------------------------------------------------------------------------
# record reconstruction (decode)
# ---------------------------------------------------------------------------

# BAM cigar op codes
OP_M, OP_I, OP_D, OP_N, OP_S, OP_H, OP_P = 0, 1, 2, 3, 4, 5, 6

_FLAG_MREVERSE = 0x20
_FLAG_MUNMAP = 0x8


class _CigarBuilder:
    def __init__(self):
        self.ops: List[Tuple[int, int]] = []

    def add(self, op: int, ln: int) -> None:
        if ln <= 0:
            return
        if self.ops and self.ops[-1][0] == op:
            self.ops[-1] = (op, self.ops[-1][1] + ln)
        else:
            self.ops.append((op, ln))


def _reconstruct_mapped(rl: int, pos1: int, features, ref_get, comp: CompressionHeader):
    """features: list of (code:str, fpos:int 1-based, payload). Returns
    (seq, cigar, qual_overrides dict)."""
    seq = bytearray(b"N" * rl)
    quals: Dict[int, int] = {}
    cig = _CigarBuilder()
    read_i = 0            # 0-based next unwritten read position
    ref_i = pos1 - 1      # 0-based reference position

    def fill_match(n: int) -> None:
        nonlocal read_i, ref_i
        if n <= 0:
            return
        for k in range(n):
            seq[read_i + k] = ord(ref_get(ref_i + k))
        cig.add(OP_M, n)
        read_i += n
        ref_i += n

    for code, fpos, payload in features:
        fill_match((fpos - 1) - read_i)
        if code == "B":
            base, q = payload
            seq[read_i] = base
            quals[read_i] = q
            cig.add(OP_M, 1)
            read_i += 1
            ref_i += 1
        elif code == "X":
            seq[read_i] = ord(comp.sub_base(ref_get(ref_i), payload))
            cig.add(OP_M, 1)
            read_i += 1
            ref_i += 1
        elif code == "I":
            seq[read_i: read_i + len(payload)] = payload
            cig.add(OP_I, len(payload))
            read_i += len(payload)
        elif code == "i":
            seq[read_i] = payload
            cig.add(OP_I, 1)
            read_i += 1
        elif code == "S":
            seq[read_i: read_i + len(payload)] = payload
            cig.add(OP_S, len(payload))
            read_i += len(payload)
        elif code == "D":
            cig.add(OP_D, payload)
            ref_i += payload
        elif code == "N":
            cig.add(OP_N, payload)
            ref_i += payload
        elif code == "H":
            cig.add(OP_H, payload)
        elif code == "P":
            cig.add(OP_P, payload)
        elif code == "Q":
            quals[fpos - 1] = payload
        elif code == "b":
            seq[read_i: read_i + len(payload)] = payload
            cig.add(OP_M, len(payload))
            read_i += len(payload)
            ref_i += len(payload)
        elif code == "q":
            for k, q in enumerate(payload):
                quals[fpos - 1 + k] = q
        else:
            raise ValueError(f"unknown read feature code {code!r}")
    fill_match(rl - read_i)
    return bytes(seq), cig.ops, quals


class _SliceDecoder:
    def __init__(self, comp: CompressionHeader, sl: SliceHeader,
                 core: Block, externals: Dict[int, Block],
                 refs: List[str], ref_fetch, counter_base: int,
                 name_prefix: str):
        self.comp = comp
        self.sl = sl
        self.core = BitReader(core.data if core else b"")
        self.ext = {cid: ByteStream(b.data) for cid, b in externals.items()}
        self.refs = refs
        self.counter = counter_base
        self.name_prefix = name_prefix
        # per-slice reference cache: contig id -> (seq, offset)
        self._ref_cache: Dict[int, Tuple[str, int]] = {}
        self._ref_fetch = ref_fetch
        if sl.embedded_ref_id >= 0 and sl.embedded_ref_id in externals:
            emb = externals[sl.embedded_ref_id].data.decode("latin-1")
            self._ref_cache[sl.ref_seq_id] = (emb, sl.start - 1)

    def _ref_get(self, tid: int):
        if tid not in self._ref_cache:
            if self._ref_fetch is None:
                self._ref_cache[tid] = ("", 0)
            else:
                self._ref_cache[tid] = (self._ref_fetch(tid), 0)
        seq, off = self._ref_cache[tid]

        def get(pos0: int) -> str:
            i = pos0 - off
            if 0 <= i < len(seq):
                return seq[i].upper()
            return "N"

        return get

    def _ds(self, key: str) -> Codec:
        codec = self.comp.data_series.get(key)
        if codec is None:
            raise ValueError(f"CRAM record needs missing data series {key}")
        return codec

    def _int(self, key: str) -> int:
        return self._ds(key).read_int(self.core, self.ext)

    def _byte(self, key: str) -> int:
        return self._ds(key).read_byte(self.core, self.ext)

    def _bytes(self, key: str, length: Optional[int] = None) -> bytes:
        return self._ds(key).read_bytes(self.core, self.ext, length)

    def records(self) -> List[BamRead]:
        comp, sl = self.comp, self.sl
        out: List[BamRead] = []
        last_pos1 = sl.start
        for i in range(sl.n_records):
            bf = self._int("BF")
            cf = self._int("CF")
            tid = self._int("RI") if sl.ref_seq_id == -2 else sl.ref_seq_id
            rl = self._int("RL")
            ap = self._int("AP")
            if comp.ap_delta:
                pos1 = last_pos1 + ap
                last_pos1 = pos1
            else:
                pos1 = ap
            self._int("RG")  # read group (unused downstream)
            qname = None
            if comp.rn_preserved:
                qname = self._bytes("RN").decode()
            flag = bf
            next_tid, next_pos, tlen = -1, -1, 0
            if cf & 0x2:  # detached
                mf = self._int("MF")
                if not comp.rn_preserved:
                    qname = self._bytes("RN").decode()
                next_tid = self._int("NS")
                next_pos = self._int("NP") - 1
                tlen = self._int("TS")
                if mf & 0x1:
                    flag |= _FLAG_MREVERSE
                if mf & 0x2:
                    flag |= _FLAG_MUNMAP
            elif cf & 0x4:
                self._int("NF")  # mate downstream distance (pairing only)
            if qname is None:
                qname = f"{self.name_prefix}.{self.counter + i}"
            tl = self._int("TL")
            tags: Dict[str, Any] = {}
            for name, typ in comp.tag_dict[tl]:
                key = (ord(name[0]) << 16) | (ord(name[1]) << 8) | ord(typ)
                codec = comp.tag_codecs.get(key)
                if codec is None:
                    raise ValueError(f"missing tag codec for {name}:{typ}")
                raw = codec.read_bytes(self.core, self.ext)
                tags.update(_parse_tags(name.encode() + typ.encode() + raw))

            if not (bf & 0x4):  # mapped
                fn = self._int("FN")
                feats = []
                fpos = 0
                for _ in range(fn):
                    fc = chr(self._byte("FC"))
                    fpos += self._int("FP")
                    if fc == "B":
                        payload = (self._byte("BA"), self._byte("QS"))
                    elif fc == "X":
                        payload = self._byte("BS")
                    elif fc == "I":
                        payload = self._bytes("IN")
                    elif fc == "i":
                        payload = self._byte("BA")
                    elif fc == "S":
                        payload = self._bytes("SC")
                    elif fc == "D":
                        payload = self._int("DL")
                    elif fc == "N":
                        payload = self._int("RS")
                    elif fc == "H":
                        payload = self._int("HC")
                    elif fc == "P":
                        payload = self._int("PD")
                    elif fc == "Q":
                        payload = self._byte("QS")
                    elif fc == "b":
                        payload = self._bytes("BB")
                    elif fc == "q":
                        payload = self._bytes("QQ")
                    else:
                        raise ValueError(f"unknown feature code {fc!r}")
                    feats.append((fc, fpos, payload))
                mapq = self._int("MQ")
                seq_b, cigar, qover = _reconstruct_mapped(
                    rl, pos1, feats, self._ref_get(tid), comp)
                if cf & 0x1:
                    qual = np.frombuffer(self._bytes("QS", rl), np.uint8).copy()
                else:
                    qual = np.full(rl, 0xFF, np.uint8)
                    for k, q in qover.items():
                        qual[k] = q
                out.append(BamRead(qname, flag, tid, pos1 - 1, mapq, cigar,
                                   seq_b.decode("latin-1"), qual, tags,
                                   next_tid, next_pos, tlen))
            else:  # unmapped
                if cf & 0x8:
                    seq = "N" * rl
                else:
                    seq = self._bytes("BA", rl).decode("latin-1")
                if cf & 0x1:
                    qual = np.frombuffer(self._bytes("QS", rl), np.uint8).copy()
                else:
                    qual = np.full(rl, 0xFF, np.uint8)
                out.append(BamRead(qname, flag, tid, pos1 - 1, 0, [], seq,
                                   qual, tags, next_tid, next_pos, tlen))
        return out


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class CramReader:
    """Sequential CRAM 3.0 reader yielding BamRead records.

    ``ref_fn`` (FASTA, required when the file needs the reference — the
    normal case) is used to reconstruct sequences."""

    def __init__(self, path: str, ref_fn: Optional[str] = None):
        self.path = path
        self.ref_fn = ref_fn
        self._fa = None
        with open(path, "rb") as fh:
            magic = fh.read(4)
            if magic != CRAM_MAGIC:
                raise ValueError(f"{path}: not a CRAM file")
            self.major, self.minor = fh.read(1)[0], fh.read(1)[0]
            if self.major not in (2, 3):
                raise ValueError(f"unsupported CRAM major version {self.major}")
            fh.read(20)  # file id
            self._data_start = fh.tell()
            hdr = read_container_header(fh)
            if hdr is None:
                raise ValueError("missing CRAM header container")
            payload = fh.read(hdr.length)
            block, _ = read_block(payload, 0)
            if block.content_type != CT_FILE_HEADER:
                raise ValueError("first CRAM block is not the SAM header")
            (text_len,) = struct.unpack_from("<i", block.data, 0)
            self.header_text = block.data[4: 4 + text_len].decode(errors="replace")
            self._first_data_container = fh.tell()
        self.references: List[str] = []
        self.lengths: List[int] = []
        for line in self.header_text.splitlines():
            if line.startswith("@SQ"):
                name = ln = None
                for fieldv in line.split("\t")[1:]:
                    if fieldv.startswith("SN:"):
                        name = fieldv[3:]
                    elif fieldv.startswith("LN:"):
                        ln = int(fieldv[3:])
                if name is not None:
                    self.references.append(name)
                    self.lengths.append(ln or 0)

    def _fetch_ref(self, tid: int) -> str:
        if self.ref_fn is None:
            raise ValueError(
                f"{self.path} requires the reference FASTA to decode "
                "(pass ref_fn)")
        if self._fa is None:
            from clair3_tpu_torch.io.fasta import FastaFile

            self._fa = FastaFile(self.ref_fn)
        name = self.references[tid]
        return self._fa.fetch(name, 0, self._fa.contig_length(name))

    def __iter__(self):
        counter = 0
        with open(self.path, "rb") as fh:
            fh.seek(self._first_data_container)
            while True:
                pos = fh.tell()
                probe = fh.read(len(CRAM_EOF))
                if len(probe) < len(CRAM_EOF) or probe == CRAM_EOF:
                    return
                fh.seek(pos)
                hdr = read_container_header(fh)
                if hdr is None:
                    return
                payload = fh.read(hdr.length)
                if len(payload) < hdr.length:
                    return
                p = 0
                comp_block, p = read_block(payload, p)
                if comp_block.content_type != CT_COMPRESSION_HEADER:
                    raise ValueError("expected compression header block")
                comp = parse_compression_header(comp_block.data)
                while p < len(payload):
                    sl_block, p = read_block(payload, p)
                    if sl_block.content_type != CT_SLICE_HEADER:
                        raise ValueError("expected slice header block")
                    sl = parse_slice_header(sl_block.data)
                    core = None
                    externals: Dict[int, Block] = {}
                    for _ in range(sl.n_blocks):
                        b, p = read_block(payload, p)
                        if b.content_type == CT_CORE:
                            core = b
                        else:
                            externals[b.content_id] = b
                    dec = _SliceDecoder(comp, sl, core, externals,
                                        self.references, self._fetch_ref,
                                        counter, "cram")
                    for rec in dec.records():
                        yield rec
                    counter += sl.n_records

    def close(self) -> None:
        if self._fa is not None:
            self._fa.close()
            self._fa = None


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

# fixed external content ids for data series
_IDS = {"BF": 1, "CF": 2, "RL": 3, "AP": 4, "RG": 5, "MF": 6, "NS": 7,
        "NP": 8, "TS": 9, "TL": 10, "FN": 11, "FC": 12, "FP": 13, "DL": 14,
        "BA": 15, "BS": 16, "IN": 17, "SC": 18, "HC": 19, "PD": 20, "RS": 21,
        "MQ": 22, "QS": 23, "RN": 24}
_INT_SERIES = ("BF", "CF", "RL", "AP", "RG", "MF", "NS", "NP", "TS", "TL",
               "FN", "FP", "DL", "HC", "PD", "RS", "MQ")
_STOP_SERIES = ("RN", "IN", "SC")  # BYTE_ARRAY_STOP with '\t'
_BYTE_SERIES = ("FC", "BA", "BS", "QS")


class CramWriter:
    """Reference-based CRAM 3.0 writer (one slice per container)."""

    def __init__(self, path: str, references: Sequence[str],
                 lengths: Sequence[int], ref_fn: Optional[str] = None,
                 records_per_slice: int = 4096, header_text: Optional[str] = None,
                 version: Tuple[int, int] = (3, 0),
                 method_override: Optional[int] = None):
        if version not in ((3, 0), (3, 1)):
            raise ValueError(f"unsupported CRAM write version {version}")
        # force every EXTERNAL data block onto one compression method —
        # the codec-matrix property fuzz (tests/test_native_cram.py) uses
        # this to drive each codec through REAL containers
        self.method_override = method_override
        self.path = path
        self.version = version
        # 3.1 stores names NUL-separated so the tok3 codec applies
        self._rn_stop = 0 if version >= (3, 1) else ord("\t")
        self.references = list(references)
        self.lengths = list(lengths)
        self.ref_fn = ref_fn
        self.rps = records_per_slice
        self._fa = None
        self._ref_tid = -9
        self._ref_seq = ""
        self._counter = 0
        self._fh = open(path, "wb")
        self._fh.write(CRAM_MAGIC + bytes(version) + b"clair3_tpu_torch".ljust(20, b"\x00"))
        if header_text is None:
            header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
                f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(references, lengths))
        hdr_data = struct.pack("<i", len(header_text)) + header_text.encode()
        block = write_block(Block(M_RAW, CT_FILE_HEADER, 0, hdr_data), M_GZIP)
        self._fh.write(_container_bytes(0, 0, 0, 0, 0, 0, 1, [0], block))
        self._pending: List[BamRead] = []

    def _ref_base(self, tid: int, pos0: int) -> str:
        if tid != self._ref_tid:
            if self.ref_fn is None:
                self._ref_seq = ""
            else:
                from clair3_tpu_torch.io.fasta import FastaFile

                if self._fa is None:
                    self._fa = FastaFile(self.ref_fn)
                name = self.references[tid]
                self._ref_seq = self._fa.fetch(name, 0, self._fa.contig_length(name))
            self._ref_tid = tid
        if 0 <= pos0 < len(self._ref_seq):
            return self._ref_seq[pos0].upper()
        return "N"

    def write(self, read: BamRead) -> None:
        if self._pending and (len(self._pending) >= self.rps
                              or self._pending[0].tid != read.tid):
            self.flush()
        self._pending.append(read)

    def flush(self) -> None:
        if not self._pending:
            return
        self._write_slice(self._pending)
        self._pending = []

    def close(self) -> None:
        self.flush()
        self._fh.write(CRAM_EOF)
        self._fh.close()
        if self._fa is not None:
            self._fa.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- encoding helpers --
    def _features_for(self, read: BamRead) -> List[Tuple[str, int, Any]]:
        feats: List[Tuple[str, int, Any]] = []
        read_i = 0
        ref_i = read.pos
        comp_sm = CompressionHeader()
        for op, ln in read.cigar:
            if op in (OP_M, 7, 8):
                for k in range(ln):
                    rb = read.seq[read_i + k].upper()
                    fb = self._ref_base(read.tid, ref_i + k)
                    if rb != fb:
                        code = comp_sm.sub_code(fb, rb)
                        if code is not None:
                            feats.append(("X", read_i + k + 1, code))
                        else:  # non-ACGTN read base: store verbatim
                            feats.append(("B", read_i + k + 1,
                                          (ord(read.seq[read_i + k]),
                                           int(read.qual[read_i + k]))))
                read_i += ln
                ref_i += ln
            elif op == OP_I:
                bases = read.seq[read_i: read_i + ln].encode("latin-1")
                feats.append(("I", read_i + 1, bases))
                read_i += ln
            elif op == OP_S:
                bases = read.seq[read_i: read_i + ln].encode("latin-1")
                feats.append(("S", read_i + 1, bases))
                read_i += ln
            elif op == OP_D:
                feats.append(("D", read_i + 1, ln))
                ref_i += ln
            elif op == OP_N:
                feats.append(("N", read_i + 1, ln))
                ref_i += ln
            elif op == OP_H:
                feats.append(("H", read_i + 1, ln))
            elif op == OP_P:
                feats.append(("P", read_i + 1, ln))
            else:
                raise ValueError(f"unsupported cigar op {op}")
        return feats

    def _write_slice(self, reads: List[BamRead]) -> None:
        comp = CompressionHeader()
        # tag dictionary over this slice
        tag_lines: List[Tuple[Tuple[str, str], ...]] = []
        line_index: Dict[Tuple[Tuple[str, str], ...], int] = {}
        read_lines = []
        tag_types: Dict[str, str] = {}
        for r in reads:
            line = []
            for name, val in r.tags.items():
                enc = _encode_tags({name: val})
                typ = chr(enc[2])
                tag_types[name] = typ
                line.append((name, typ))
            key = tuple(line)
            if key not in line_index:
                line_index[key] = len(tag_lines)
                tag_lines.append(key)
            read_lines.append(line_index[key])
        comp.tag_dict = [list(t) for t in tag_lines]

        streams: Dict[str, bytearray] = {k: bytearray() for k in _IDS}
        tag_streams: Dict[str, Tuple[bytearray, bytearray]] = {
            name: (bytearray(), bytearray()) for name in tag_types}

        def put_int(key: str, v: int) -> None:
            streams[key] += write_itf8(v)

        tid = reads[0].tid
        start1 = reads[0].pos + 1
        last1 = start1
        end1 = start1
        bases = 0
        for ri, r in enumerate(reads):
            bf = r.flag
            cf = 0x1 | 0x2  # quals stored + detached
            put_int("BF", bf)
            put_int("CF", cf)
            rl = len(r.seq)
            put_int("RL", rl)
            pos1 = r.pos + 1
            put_int("AP", pos1 - last1)
            last1 = pos1
            put_int("RG", -1)
            streams["RN"] += r.qname.encode() + bytes([self._rn_stop])
            mf = (1 if r.flag & _FLAG_MREVERSE else 0) | \
                 (2 if r.flag & _FLAG_MUNMAP else 0)
            put_int("MF", mf)
            put_int("NS", r.next_tid)
            put_int("NP", r.next_pos + 1)
            put_int("TS", r.tlen)
            put_int("TL", read_lines[ri])
            for name, val in r.tags.items():
                enc = _encode_tags({name: val})[3:]
                lb, vb = tag_streams[name]
                lb += write_itf8(len(enc))
                vb += enc
            if not (r.flag & 0x4):
                feats = self._features_for(r)
                put_int("FN", len(feats))
                prev = 0
                for code, fpos, payload in feats:
                    streams["FC"].append(ord(code))
                    put_int("FP", fpos - prev)
                    prev = fpos
                    if code == "X":
                        streams["BS"].append(payload)
                    elif code == "B":
                        streams["BA"].append(payload[0])
                        streams["QS"].append(payload[1])
                    elif code in ("I", "S"):
                        streams["IN" if code == "I" else "SC"] += payload + b"\t"
                    elif code == "D":
                        put_int("DL", payload)
                    elif code == "N":
                        put_int("RS", payload)
                    elif code == "H":
                        put_int("HC", payload)
                    elif code == "P":
                        put_int("PD", payload)
                streams["MQ"] += write_itf8(r.mapq)
                streams["QS"] += bytes(np.asarray(r.qual, np.uint8).tobytes())
                ref_span = sum(ln for op, ln in r.cigar if op in (OP_M, OP_D, OP_N, 7, 8))
                end1 = max(end1, pos1 + ref_span - 1)
            else:
                streams["BA"] += r.seq.encode("latin-1")
                streams["QS"] += bytes(np.asarray(r.qual, np.uint8).tobytes())
            bases += rl

        # encodings
        series_params: Dict[str, bytes] = {}
        for key in _INT_SERIES:
            series_params[key] = enc_external(_IDS[key])
        for key in _BYTE_SERIES:
            series_params[key] = enc_external(_IDS[key])
        for key in _STOP_SERIES:
            stop = self._rn_stop if key == "RN" else ord("\t")
            series_params[key] = enc_byte_array_stop(stop, _IDS[key])
        tag_params: Dict[int, bytes] = {}
        tag_ids: Dict[str, Tuple[int, int]] = {}
        next_id = 100
        for name, typ in sorted(tag_types.items()):
            key = (ord(name[0]) << 16) | (ord(name[1]) << 8) | ord(typ)
            tag_ids[name] = (next_id, next_id + 1)
            tag_params[key] = enc_byte_array_len_external(next_id, next_id + 1)
            next_id += 2

        comp_data = build_compression_header(comp, series_params, tag_params)
        blocks = write_block(Block(M_RAW, CT_COMPRESSION_HEADER, 0, comp_data), M_GZIP)
        landmark0 = len(blocks)

        ext_blocks: List[bytes] = []
        content_ids: List[int] = []
        for key, cid in _IDS.items():
            data = bytes(streams[key])
            content_ids.append(cid)
            is31 = self.version >= (3, 1)
            if self.method_override is not None:
                # tok3 only fits NUL-separated name streams
                method = self.method_override \
                    if not (self.method_override == M_TOK3 and key != "RN") \
                    else M_GZIP
            elif key in ("QS", "BA") and len(data) >= 64:
                method = M_RANSNX16 if is31 else M_RANS
            elif is31 and key == "RN" and len(data) >= 64:
                method = M_TOK3
            else:
                method = M_GZIP
            ext_blocks.append(write_block(Block(M_RAW, CT_EXTERNAL, cid, data), method))
        tag_method = M_GZIP if self.method_override in (None, M_TOK3) \
            else self.method_override
        for name, (lb, vb) in tag_streams.items():
            lid, vid = tag_ids[name]
            content_ids.append(lid)
            ext_blocks.append(write_block(Block(M_RAW, CT_EXTERNAL, lid, bytes(lb)), tag_method))
            content_ids.append(vid)
            ext_blocks.append(write_block(Block(M_RAW, CT_EXTERNAL, vid, bytes(vb)), tag_method))

        sl = SliceHeader(tid, start1, end1 - start1 + 1, len(reads),
                         self._counter, 1 + len(ext_blocks), content_ids,
                         -1, b"\x00" * 16)
        slice_blocks = write_block(Block(M_RAW, CT_SLICE_HEADER, 0,
                                         build_slice_header(sl)), M_GZIP)
        slice_blocks += write_block(Block(M_RAW, CT_CORE, 0, b""), M_RAW)
        slice_blocks += b"".join(ext_blocks)

        payload = blocks + slice_blocks
        container = _container_bytes(
            tid, start1, end1 - start1 + 1, len(reads), self._counter, bases,
            1 + 1 + 1 + len(ext_blocks), [landmark0], payload)
        self._fh.write(container)
        self._counter += len(reads)


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------

def bam_to_cram(bam_path: str, cram_path: str, ref_fn: str,
                version: Tuple[int, int] = (3, 0)) -> str:
    """Re-encode a BAM as reference-based CRAM 3.0 or 3.1."""
    from clair3_tpu_torch.io.bam import BamReader

    bam = BamReader(bam_path)
    with CramWriter(cram_path, bam.references, bam.lengths, ref_fn=ref_fn,
                    header_text=bam.header_text or None, version=version) as w:
        for read in bam:  # every record, unfiltered, file order
            w.write(read)
    return cram_path


def cram_to_bam(cram_path: str, bam_path: str, ref_fn: Optional[str]) -> str:
    """Decode a CRAM into an indexed BAM (the pipeline's CRAM entry point:
    the native extractors and .bai windowed loads then run unchanged).

    The native C++ converter (clair3t_cram.cc, ~2 orders of magnitude
    faster) handles CRAM 3.0 with raw/gzip/rANS4x8 blocks; anything it
    cannot serve (3.1 codecs, bzip2/lzma, exotic record codecs) falls back
    to this module's pure-Python reader, which supports everything."""
    try:
        from clair3_tpu_torch.native import cram_to_bam_native, native_available

        if native_available() and ref_fn:
            got = cram_to_bam_native(cram_path, ref_fn, bam_path)
            if got is not None:
                return got
    except Exception:
        pass  # any native hiccup -> Python path below
    from clair3_tpu_torch.io.bam import write_bam

    reader = CramReader(cram_path, ref_fn=ref_fn)
    reads = list(reader)
    reader.close()
    reads.sort(key=lambda r: (r.tid, r.pos))
    write_bam(bam_path, reader.references, reader.lengths, reads,
              header_text=reader.header_text)
    return bam_path
