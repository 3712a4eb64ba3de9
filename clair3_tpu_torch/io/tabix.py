"""Tabix (.tbi) indexing for BGZF-compressed VCFs, self-contained.

The reference shells out to ``tabix -p vcf`` after every bgzip (e.g.
SortVcf.py:15-19); neither tool exists in this image, so clair3_tpu_torch writes
(and reads) the index itself.  Format per the htslib tabix spec: BGZF
container, ``TBI\\1`` magic, R-tree style 5-level binning (like BAI) with
virtual-offset chunks plus a 16 kb linear index.

``TabixReader`` uses the index for random region access into .vcf.gz files
without decompressing the whole file — the same capability downstream tools
get from the index.

``write_tabix_index`` builds the index in the native library where it is
available (``native.tabix_payload_native``, one call under the span
``vcf.index_native`` of ``clair3_tpu_torch.spans``), else, or where the library
declines the file, in Python (``tabix_payload_python``): the same bytes either
way, and the Python indexer raises on what it cannot index.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

from clair3_tpu_torch.io.bgzf import BgzfWriter
from clair3_tpu_torch.native import native_available, tabix_payload_native
from clair3_tpu_torch.spans import span

_TBI_MAGIC = b"TBI\x01"
_LINEAR_SHIFT = 14  # 16 kb windows


def _reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _reg2bins(beg: int, end: int) -> List[int]:
    """All bins overlapping [beg, end)."""
    bins = [0]
    end -= 1
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


def _iter_bgzf_blocks(path: str):
    """Yield (file_offset, decompressed_bytes) per BGZF block."""
    with open(path, "rb") as fh:
        offset = 0
        while True:
            header = fh.read(12)
            if len(header) < 12:
                return
            (xlen,) = struct.unpack("<H", header[10:12])
            extra = fh.read(xlen)
            bsize = None
            off = 0
            while off + 4 <= len(extra):
                si1, si2 = extra[off], extra[off + 1]
                (slen,) = struct.unpack("<H", extra[off + 2:off + 4])
                if si1 == 0x42 and si2 == 0x43 and slen == 2:
                    bsize = struct.unpack("<H", extra[off + 4:off + 6])[0] + 1
                off += 4 + slen
            payload = fh.read(bsize - 12 - xlen - 8)
            fh.read(8)
            data = zlib.decompress(payload, -15) if payload else b""
            yield offset, data
            offset += bsize


def write_tabix_index(vcf_gz_path: str, tbi_path: Optional[str] = None) -> str:
    """Build a .tbi for a coordinate-sorted BGZF VCF."""
    tbi_path = tbi_path or vcf_gz_path + ".tbi"
    payload = None
    if native_available():
        with span("vcf.index_native"):
            payload = tabix_payload_native(vcf_gz_path)
    if payload is None:
        payload = tabix_payload_python(vcf_gz_path)
    with BgzfWriter(tbi_path) as out:
        out.write(bytes(payload))
    return tbi_path


def tabix_payload_python(vcf_gz_path: str) -> bytearray:
    """The uncompressed .tbi of a coordinate-sorted BGZF VCF, built in Python."""
    # walk rows with their virtual offsets
    names: List[str] = []
    name_id: Dict[str, int] = {}
    bins: List[Dict[int, List[List[int]]]] = []    # per ref: bin -> chunks
    linear: List[Dict[int, int]] = []              # per ref: window -> min voff

    def handle(line: bytes, voff: int, end_voff: int) -> None:
        if not line or line.startswith(b"#"):
            return
        cols = line.split(b"\t", 4)
        ctg = cols[0].decode()
        pos1 = int(cols[1])
        beg = pos1 - 1
        end = beg + max(1, len(cols[3]))
        if ctg not in name_id:
            name_id[ctg] = len(names)
            names.append(ctg)
            bins.append({})
            linear.append({})
        rid = name_id[ctg]
        b = _reg2bin(beg, end)
        chunk_list = bins[rid].setdefault(b, [])
        if chunk_list and chunk_list[-1][1] == voff:
            chunk_list[-1][1] = end_voff
        else:
            chunk_list.append([voff, end_voff])
        for w in range(beg >> _LINEAR_SHIFT, ((end - 1) >> _LINEAR_SHIFT) + 1):
            cur = linear[rid].get(w)
            if cur is None or voff < cur:
                linear[rid][w] = voff

    carry = b""
    carry_voff = 0
    for block_off, data in _iter_bgzf_blocks(vcf_gz_path):
        buf = carry + data
        pos = 0
        while True:
            nl = buf.find(b"\n", pos)
            if nl < 0:
                if pos < len(buf):
                    if pos >= len(carry):  # leftover starts inside this block
                        carry_voff = (block_off << 16) | (pos - len(carry))
                    carry = buf[pos:]
                else:
                    carry = b""
                break
            voff = carry_voff if pos < len(carry) else (
                (block_off << 16) | (pos - len(carry)))
            end_voff = (block_off << 16) | (nl + 1 - len(carry))
            handle(buf[pos:nl], voff, end_voff)
            pos = nl + 1

    # serialize
    payload = bytearray()
    payload += _TBI_MAGIC
    payload += struct.pack("<i", len(names))
    # format=2 (VCF), col_seq=1, col_beg=2, col_end=0, meta='#', skip=0
    payload += struct.pack("<6i", 2, 1, 2, 0, ord("#"), 0)
    concat_names = b"".join(n.encode() + b"\x00" for n in names)
    payload += struct.pack("<i", len(concat_names))
    payload += concat_names
    for rid in range(len(names)):
        payload += struct.pack("<i", len(bins[rid]))
        for b in sorted(bins[rid]):
            chunks = bins[rid][b]
            payload += struct.pack("<Ii", b, len(chunks))
            for beg_v, end_v in chunks:
                payload += struct.pack("<QQ", beg_v, end_v)
        if linear[rid]:
            n_intv = max(linear[rid]) + 1
            ioff = []
            prev = 0
            for w in range(n_intv):
                if w in linear[rid]:
                    prev = linear[rid][w]
                ioff.append(prev)
        else:
            n_intv = 0
            ioff = []
        payload += struct.pack("<i", n_intv)
        for v in ioff:
            payload += struct.pack("<Q", v)

    return payload


class TabixReader:
    """Region queries into an indexed BGZF VCF."""

    def __init__(self, vcf_gz_path: str, tbi_path: Optional[str] = None):
        self.path = vcf_gz_path
        tbi_path = tbi_path or vcf_gz_path + ".tbi"
        from clair3_tpu_torch.io.bgzf import decompress

        raw = decompress(tbi_path)
        if raw[:4] != _TBI_MAGIC:
            raise ValueError("not a TBI index")
        (n_ref,) = struct.unpack_from("<i", raw, 4)
        off = 8 + 24
        (l_nm,) = struct.unpack_from("<i", raw, off)
        off += 4
        names = raw[off:off + l_nm].split(b"\x00")[:-1]
        self.names = [n.decode() for n in names]
        off += l_nm
        self.bins: List[Dict[int, List[Tuple[int, int]]]] = []
        self.linear: List[List[int]] = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", raw, off)
            off += 4
            bmap: Dict[int, List[Tuple[int, int]]] = {}
            for _ in range(n_bin):
                b, n_chunk = struct.unpack_from("<Ii", raw, off)
                off += 8
                chunks = []
                for _ in range(n_chunk):
                    cb, ce = struct.unpack_from("<QQ", raw, off)
                    off += 16
                    chunks.append((cb, ce))
                bmap[b] = chunks
            (n_intv,) = struct.unpack_from("<i", raw, off)
            off += 4
            ioff = list(struct.unpack_from(f"<{n_intv}Q", raw, off)) if n_intv else []
            off += 8 * n_intv
            self.bins.append(bmap)
            self.linear.append(ioff)
        self._name_id = {n: i for i, n in enumerate(self.names)}

    def _read_from(self, voff: int, max_bytes: int = 1 << 26) -> bytes:
        """Decompress starting at virtual offset (block seek + skip)."""
        coffset = voff >> 16
        uoffset = voff & 0xFFFF
        out = bytearray()
        with open(self.path, "rb") as fh:
            fh.seek(coffset)
            while len(out) < max_bytes:
                header = fh.read(12)
                if len(header) < 12:
                    break
                (xlen,) = struct.unpack("<H", header[10:12])
                extra = fh.read(xlen)
                bsize = None
                o = 0
                while o + 4 <= len(extra):
                    if extra[o] == 0x42 and extra[o + 1] == 0x43:
                        bsize = struct.unpack("<H", extra[o + 4:o + 6])[0] + 1
                    o += 4 + struct.unpack("<H", extra[o + 2:o + 4])[0]
                payload = fh.read(bsize - 12 - xlen - 8)
                fh.read(8)
                if not payload:
                    break
                out += zlib.decompress(payload, -15)
        return bytes(out[uoffset:])

    def fetch(self, ctg: str, start0: int, end0: int) -> Iterator[str]:
        """VCF rows overlapping 0-based [start0, end0)."""
        rid = self._name_id.get(ctg)
        if rid is None:
            return
        chunks = []
        min_ioff = 0
        lin = self.linear[rid]
        w = start0 >> _LINEAR_SHIFT
        if lin:
            min_ioff = lin[min(w, len(lin) - 1)]
        for b in _reg2bins(start0, end0):
            for cb, ce in self.bins[rid].get(b, []):
                if ce > min_ioff:
                    chunks.append((max(cb, min_ioff), ce))
        if not chunks:
            return
        chunks.sort()
        voff = chunks[0][0]
        text = self._read_from(voff)
        for line in text.splitlines():
            if not line or line.startswith(b"#"):
                continue
            cols = line.split(b"\t", 4)
            if cols[0].decode() != ctg:
                continue
            pos1 = int(cols[1])
            beg = pos1 - 1
            end = beg + max(1, len(cols[3]))
            if beg >= end0:
                break
            if end > start0:
                yield line.decode()
