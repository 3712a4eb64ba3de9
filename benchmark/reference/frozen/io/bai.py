"""BAI (BAM index) writing and reading, self-contained.

Without an index every region fetch decompresses the whole BAM — fatal at
WGS scale.  ``write_bai`` builds the standard 5-level binned index (+16 kb
linear index) by streaming the BGZF blocks once; ``query_voff_range`` turns
a region into a (virtual-offset begin, end) window so readers decompress
only the needed blocks.  Layout per the SAM spec §5.2 (magic ``BAI\\1``).
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

_BAI_MAGIC = b"BAI\x01"
_LINEAR_SHIFT = 14


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
    bins = [0]
    end -= 1
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


def write_bai(bam_path: str, bai_path: Optional[str] = None) -> str:
    """Index a coordinate-sorted BAM."""
    from benchmark.reference.frozen.io.bgzf import iter_offset_blocks

    bai_path = bai_path or bam_path + ".bai"

    n_ref = 0
    bins: List[Dict[int, List[List[int]]]] = []
    linear: List[Dict[int, int]] = []

    # decompress once, tracking virtual offsets via the block table
    blocks = list(iter_offset_blocks(bam_path))
    # build an offset map: cumulative uncompressed offset -> (block_off, within)
    cum = []
    total = 0
    for boff, data in blocks:
        cum.append((total, boff, len(data)))
        total += len(data)
    payload = b"".join(data for _, data in blocks)

    def voff_at(upos: int) -> int:
        # binary search the block containing uncompressed position upos
        if upos >= total:
            return (cum[-1][1] << 16) | cum[-1][2]
        lo, hi = 0, len(cum) - 1
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if cum[mid][0] <= upos:
                lo = mid
            else:
                hi = mid - 1
        start, boff, blen = cum[lo]
        return (boff << 16) | (upos - start)

    if payload[:4] != b"BAM\x01":
        raise ValueError(f"{bam_path} is not BAM")
    (l_text,) = struct.unpack_from("<i", payload, 4)
    off = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", payload, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", payload, off)
        off += 4 + l_name + 4
        bins.append({})
        linear.append({})

    n = len(payload)
    while off + 4 <= n:
        (block_size,) = struct.unpack_from("<i", payload, off)
        voff = voff_at(off)
        end_voff = voff_at(off + 4 + block_size)
        tid, pos = struct.unpack_from("<ii", payload, off + 4)
        l_qname = payload[off + 12]
        (n_cigar,) = struct.unpack_from("<H", payload, off + 16)
        if tid >= 0:
            span = 0
            cig_off = off + 4 + 32 + l_qname
            for k in range(n_cigar):
                (c,) = struct.unpack_from("<I", payload, cig_off + 4 * k)
                op = c & 0xF
                if op in (0, 2, 3, 7, 8):
                    span += c >> 4
            end = pos + max(span, 1)
            b = _reg2bin(pos, end)
            chunk_list = bins[tid].setdefault(b, [])
            if chunk_list and chunk_list[-1][1] >= voff:
                chunk_list[-1][1] = max(chunk_list[-1][1], end_voff)
            else:
                chunk_list.append([voff, end_voff])
            for w in range(pos >> _LINEAR_SHIFT, ((end - 1) >> _LINEAR_SHIFT) + 1):
                cur = linear[tid].get(w)
                if cur is None or voff < cur:
                    linear[tid][w] = voff
        off += 4 + block_size

    out = bytearray()
    out += _BAI_MAGIC
    out += struct.pack("<i", n_ref)
    for rid in range(n_ref):
        out += struct.pack("<i", len(bins[rid]))
        for b in sorted(bins[rid]):
            chunks = bins[rid][b]
            out += struct.pack("<Ii", b, len(chunks))
            for cb, ce in chunks:
                out += struct.pack("<QQ", cb, ce)
        if linear[rid]:
            n_intv = max(linear[rid]) + 1
            prev = 0
            ioff = []
            for w in range(n_intv):
                if w in linear[rid]:
                    prev = linear[rid][w]
                ioff.append(prev)
        else:
            n_intv, ioff = 0, []
        out += struct.pack("<i", n_intv)
        for v in ioff:
            out += struct.pack("<Q", v)
    with open(bai_path, "wb") as fh:
        fh.write(bytes(out))
    return bai_path


class BaiIndex:
    def __init__(self, bai_path: str):
        with open(bai_path, "rb") as fh:
            raw = fh.read()
        if raw[:4] != _BAI_MAGIC:
            raise ValueError("not a BAI index")
        (n_ref,) = struct.unpack_from("<i", raw, 4)
        off = 8
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

    def query_chunks(self, tid: int, beg: int, end: int,
                     merge_gap: int = 1 << 16) -> Optional[list]:
        """Merged, sorted [(voff_begin, voff_end)] chunk list covering all
        reads overlapping [beg, end), or None when the region has no reads.

        Unlike a single min/max span, the chunk list stays tight when long
        reads crossing 1Mb/8Mb boundaries park chunks in coarse bins — a
        single-span reader would otherwise decompress to the end of the
        contig for every query.  Chunks whose compressed gap is below
        ``merge_gap`` bytes are coalesced to bound the range count."""
        if tid < 0 or tid >= len(self.bins):
            return None
        min_ioff = 0
        lin = self.linear[tid]
        if lin:
            w = min(beg >> _LINEAR_SHIFT, len(lin) - 1)
            min_ioff = lin[w]
        chunks = []
        for b in _reg2bins(beg, end):
            for cb, ce in self.bins[tid].get(b, []):
                if ce <= min_ioff:
                    continue
                chunks.append((max(cb, min_ioff), ce))
        if not chunks:
            return None
        chunks.sort()
        merged = [list(chunks[0])]
        for cb, ce in chunks[1:]:
            if (cb >> 16) - (merged[-1][1] >> 16) <= merge_gap:
                merged[-1][1] = max(merged[-1][1], ce)
            else:
                merged.append([cb, ce])
        return [(cb, ce) for cb, ce in merged]

    def query_voff_range(self, tid: int, beg: int, end: int) -> Optional[Tuple[int, int]]:
        """(voff_begin, voff_end) window covering all reads overlapping
        [beg, end), or None when the region has no reads."""
        if tid < 0 or tid >= len(self.bins):
            return None
        min_ioff = 0
        lin = self.linear[tid]
        if lin:
            w = min(beg >> _LINEAR_SHIFT, len(lin) - 1)
            min_ioff = lin[w]
        lo: Optional[int] = None
        hi = 0
        for b in _reg2bins(beg, end):
            for cb, ce in self.bins[tid].get(b, []):
                if ce <= min_ioff:
                    continue
                cb = max(cb, min_ioff)
                lo = cb if lo is None else min(lo, cb)
                hi = max(hi, ce)
        if lo is None:
            return None
        return lo, hi
