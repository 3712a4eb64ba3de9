"""Self-contained BAM reading and writing.

No htslib/pysam exists in this image, so clair3_tpu_torch carries its own BAM
codec: BGZF container (benchmark.reference.frozen.io.bgzf) + the BAM binary record layout
(SAM spec §4.2).  This module is the *reference* implementation used by
tests and the pure-Python feature extractors; the C++ fast path under
clair3_tpu_torch/native implements the same contract for production throughput.

CIGAR ops: MIDNSHP=X (0..8).  Sequence nibble code: '=ACMGRSVTWYHKDBN'.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from benchmark.reference.frozen.io.bgzf import decompress

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
_SEQ_CODE = {b: i for i, b in enumerate(SEQ_NT16)}
# ops that consume the reference / the query
CONSUMES_REF = (True, False, True, True, False, False, False, True, True)

FLAG_UNMAP = 0x4
FLAG_REVERSE = 0x10
# reference filter: samtools view -F 2316 == UNMAP|MUNMAP|SECONDARY|SUPPLEMENTARY
DEFAULT_FILTER_FLAG = 2316


@dataclass
class BamRead:
    qname: str
    flag: int
    tid: int
    pos: int  # 0-based leftmost mapping position
    mapq: int
    cigar: List[Tuple[int, int]]  # (op, length)
    seq: str
    qual: np.ndarray  # uint8 phred values
    tags: Dict[str, Any] = field(default_factory=dict)
    next_tid: int = -1
    next_pos: int = -1
    tlen: int = 0

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAP)

    @property
    def reference_length(self) -> int:
        return sum(n for op, n in self.cigar if CONSUMES_REF[op])

    @property
    def reference_end(self) -> int:
        return self.pos + self.reference_length

    @property
    def query_length(self) -> int:
        return len(self.seq)


def _parse_tags(buf: bytes) -> Dict[str, Any]:
    tags: Dict[str, Any] = {}
    off = 0
    n = len(buf)
    while off + 3 <= n:
        tag = buf[off:off + 2].decode()
        typ = chr(buf[off + 2])
        off += 3
        if typ == "A":
            tags[tag] = chr(buf[off]); off += 1  # noqa: E702
        elif typ == "c":
            tags[tag] = struct.unpack_from("<b", buf, off)[0]; off += 1  # noqa: E702
        elif typ == "C":
            tags[tag] = struct.unpack_from("<B", buf, off)[0]; off += 1  # noqa: E702
        elif typ == "s":
            tags[tag] = struct.unpack_from("<h", buf, off)[0]; off += 2  # noqa: E702
        elif typ == "S":
            tags[tag] = struct.unpack_from("<H", buf, off)[0]; off += 2  # noqa: E702
        elif typ == "i":
            tags[tag] = struct.unpack_from("<i", buf, off)[0]; off += 4  # noqa: E702
        elif typ == "I":
            tags[tag] = struct.unpack_from("<I", buf, off)[0]; off += 4  # noqa: E702
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", buf, off)[0]; off += 4  # noqa: E702
        elif typ in ("Z", "H"):
            end = buf.index(b"\x00", off)
            tags[tag] = buf[off:end].decode()
            off = end + 1
        elif typ == "B":
            sub = chr(buf[off])
            count = struct.unpack_from("<I", buf, off + 1)[0]
            off += 5
            dt = {"c": np.int8, "C": np.uint8, "s": np.int16, "S": np.uint16,
                  "i": np.int32, "I": np.uint32, "f": np.float32}[sub]
            arr = np.frombuffer(buf, dtype=dt, count=count, offset=off)
            tags[tag] = arr.copy()
            off += count * arr.dtype.itemsize
        else:
            raise ValueError(f"unsupported BAM tag type {typ!r}")
    return tags


def _encode_tags(tags: Dict[str, Any]) -> bytes:
    out = bytearray()
    for tag, val in tags.items():
        t = tag.encode()
        if isinstance(val, bool):
            raise ValueError("bool tags unsupported")
        if isinstance(val, (int, np.integer)):
            out += t + b"i" + struct.pack("<i", int(val))
        elif isinstance(val, float):
            out += t + b"f" + struct.pack("<f", val)
        elif isinstance(val, str):
            if len(val) == 1 and tag in ("XA",):
                out += t + b"A" + val.encode()
            else:
                out += t + b"Z" + val.encode() + b"\x00"
        elif isinstance(val, np.ndarray):
            sub = {np.dtype(np.int8): b"c", np.dtype(np.uint8): b"C",
                   np.dtype(np.int16): b"s", np.dtype(np.uint16): b"S",
                   np.dtype(np.int32): b"i", np.dtype(np.uint32): b"I",
                   np.dtype(np.float32): b"f"}[val.dtype]
            out += t + b"B" + sub + struct.pack("<I", len(val)) + val.tobytes()
        else:
            raise ValueError(f"unsupported tag value type {type(val)}")
    return bytes(out)


def parse_bam_header(data: bytes):
    """(header_text, references, lengths, records_off) from decompressed
    leading bytes; raises ValueError if incomplete."""
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream")
    (l_text,) = struct.unpack_from("<i", data, 4)
    off = 8
    header_text = data[off:off + l_text].decode(errors="replace")
    off += l_text
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    references: List[str] = []
    lengths: List[int] = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, off)
        off += 4
        references.append(data[off:off + l_name - 1].decode())
        off += l_name
        (l_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        lengths.append(l_ref)
    return header_text, references, lengths, off


def read_bam_header(path: str):
    """Parse only the BAM header, decompressing the minimum leading blocks.
    Returns (header_text, references, lengths)."""
    from benchmark.reference.frozen.io.bgzf import stream_decompress

    buf = b""
    for block in stream_decompress(path):
        buf += block
        try:
            header_text, refs, lens, _ = parse_bam_header(buf)
            return header_text, refs, lens
        except (ValueError, struct.error, IndexError):
            if buf[:4] != b"BAM\x01" and len(buf) >= 4:
                raise ValueError(f"{path} is not a BAM file")
            continue
    raise ValueError(f"{path}: truncated BAM header")


class BamReader:
    """BAM reader with region fetch.

    With a .bai index present, ``fetch`` decompresses only the BGZF blocks
    covering the region; otherwise the whole file is decompressed once
    (cached) and scanned with coordinate-sorted early exit."""

    def __init__(self, path: str):
        self.path = path
        self.header_text, self.references, self.lengths = read_bam_header(path)
        self._tid = {name: i for i, name in enumerate(self.references)}
        self._data: Optional[bytes] = None
        self._records_off: Optional[int] = None
        self._bai = None
        import os

        bai_path = path + ".bai"
        if os.path.exists(bai_path):
            from benchmark.reference.frozen.io.bai import BaiIndex

            try:
                self._bai = BaiIndex(bai_path)
            except ValueError:
                self._bai = None

    def _full(self):
        if self._data is None:
            data = decompress(self.path)
            _, _, _, off = parse_bam_header(data)
            self._data = data
            self._records_off = off
        return self._data, self._records_off

    def __iter__(self) -> Iterator[BamRead]:
        data, off = self._full()
        return self._iter_buffer(data, off)

    @staticmethod
    def _iter_buffer(data: bytes, off: int) -> Iterator[BamRead]:
        n = len(data)
        while off + 4 <= n:
            (block_size,) = struct.unpack_from("<i", data, off)
            rec_end = off + 4 + block_size
            if rec_end > n:
                break  # truncated tail (range reads may stop mid-record)
            yield BamReader._parse_record(data, off + 4, rec_end)
            off = rec_end

    @staticmethod
    def _parse_record(data: bytes, off: int, end: int) -> BamRead:
        (tid, pos, l_qname, mapq, _bin, n_cigar, flag, l_seq,
         next_tid, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", data, off)
        p = off + 32
        qname = data[p:p + l_qname - 1].decode()
        p += l_qname
        cigar = []
        for _ in range(n_cigar):
            (c,) = struct.unpack_from("<I", data, p)
            cigar.append((c & 0xF, c >> 4))
            p += 4
        nbytes = (l_seq + 1) // 2
        seq_chars = []
        for i in range(l_seq):
            b = data[p + (i >> 1)]
            nib = (b >> 4) if i % 2 == 0 else (b & 0xF)
            seq_chars.append(SEQ_NT16[nib])
        seq = "".join(seq_chars)
        p += nbytes
        qual = np.frombuffer(data, dtype=np.uint8, count=l_seq, offset=p).copy()
        p += l_seq
        tags = _parse_tags(data[p:end])
        return BamRead(qname, flag, tid, pos, mapq, cigar, seq, qual, tags,
                       next_tid, next_pos, tlen)

    def fetch(
        self,
        contig: str,
        start: int = 0,
        end: Optional[int] = None,
        filter_flag: int = DEFAULT_FILTER_FLAG,
        min_mq: int = 0,
    ) -> Iterator[BamRead]:
        """Reads overlapping [start, end), 0-based, flag/MQ filtered."""
        tid = self._tid[contig]
        end = end if end is not None else self.lengths[tid]
        if self._bai is not None and self._data is None:
            chunks = self._bai.query_chunks(tid, start, end)
            if chunks is None:
                return
            from benchmark.reference.frozen.io.bgzf import decompress_range

            def _chunked_records():
                # each chunk is record-aligned; iterate them in order (the
                # single-span alternative decompresses to the end of the
                # contig whenever long reads park chunks in coarse bins)
                for voff_begin, voff_end in chunks:
                    data = decompress_range(
                        self.path, voff_begin >> 16, voff_end >> 16)
                    off = voff_begin & 0xFFFF
                    for read in self._iter_buffer(data, off):
                        yield read

            records = _chunked_records()
        else:
            records = iter(self)
        for read in records:
            if read.tid != tid:
                if read.tid > tid:
                    break
                continue
            if read.pos >= end:
                break
            if read.flag & filter_flag or read.mapq < min_mq:
                continue
            if read.reference_end <= start:
                continue
            yield read


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


def _encode_record(read: BamRead) -> bytes:
    qname = read.qname.encode() + b"\x00"
    cigar = b"".join(struct.pack("<I", (n << 4) | op) for op, n in read.cigar)
    l_seq = len(read.seq)
    seq_bytes = bytearray((l_seq + 1) // 2)
    for i, base in enumerate(read.seq):
        code = _SEQ_CODE.get(base, 15)
        if i % 2 == 0:
            seq_bytes[i >> 1] = code << 4
        else:
            seq_bytes[i >> 1] |= code
    qual = bytes(read.qual.astype(np.uint8)) if l_seq else b""
    if len(qual) != l_seq:
        raise ValueError("qual length != seq length")
    tags = _encode_tags(read.tags)
    body = (
        struct.pack(
            "<iiBBHHHiiii",
            read.tid, read.pos, len(qname), read.mapq,
            _reg2bin(read.pos, max(read.pos + 1, read.reference_end)),
            len(read.cigar), read.flag, l_seq,
            read.next_tid, read.next_pos, read.tlen,
        )
        + qname + cigar + bytes(seq_bytes) + qual + tags
    )
    return struct.pack("<i", len(body)) + body
