"""BGZF (blocked gzip) reading and writing, dependency-free.

BGZF is the container format of BAM and bgzipped VCF: a series of gzip
members, each carrying a BC extra subfield recording the compressed block
size, terminated by a fixed 28-byte EOF block.  Python's zlib handles the
deflate payloads; we build the member framing ourselves so outputs are valid
for htslib-based tools (samtools/tabix) even though none are present in this
image.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Iterator, Union

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_MAX_BLOCK = 65280  # uncompressed bytes per block (same bound bgzip uses)


def compress_block(data: bytes, level: int = 6) -> bytes:
    """Compress up to 64 KiB of data into a single BGZF block."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = c.compress(data) + c.flush()
    bsize = len(payload) + 26  # 12B header + 6B BC subfield + payload + 8B footer
    header = (
        b"\x1f\x8b\x08\x04" + b"\x00" * 4 + b"\x00\xff"
        + struct.pack("<H", 6)            # XLEN
        + b"BC" + struct.pack("<H", 2)    # subfield id + length
        + struct.pack("<H", bsize - 1)    # BSIZE - 1
    )
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data) & 0xFFFFFFFF)
    return header + payload + footer


class BgzfWriter:
    """Streaming BGZF writer.

    With ``threads > 1``, blocks deflate on a thread pool (zlib releases
    the GIL, so this scales on multi-core hosts) and are written in order;
    output bytes are identical to the serial path."""

    def __init__(self, path_or_fh: Union[str, BinaryIO], level: int = 6,
                 threads: int = 1):
        self._own = isinstance(path_or_fh, str)
        self._fh: BinaryIO = open(path_or_fh, "wb") if self._own else path_or_fh
        self._buf = bytearray()
        self._level = level
        self._pool = None
        self._pending = None
        if threads > 1:
            from collections import deque
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=threads)
            self._pending = deque()
            self._max_pending = threads * 4  # bound memory

    def _emit(self, chunk: bytes) -> None:
        if self._pool is None:
            self._fh.write(compress_block(chunk, self._level))
            return
        self._pending.append(
            self._pool.submit(compress_block, chunk, self._level))
        while len(self._pending) > self._max_pending:
            self._fh.write(self._pending.popleft().result())

    def write(self, data: bytes) -> None:
        self._buf.extend(data)
        while len(self._buf) >= _MAX_BLOCK:
            chunk = bytes(self._buf[:_MAX_BLOCK])
            del self._buf[:_MAX_BLOCK]
            self._emit(chunk)

    def flush_block(self) -> None:
        if self._buf:
            self._emit(bytes(self._buf))
            self._buf.clear()
        if self._pending:
            while self._pending:
                self._fh.write(self._pending.popleft().result())

    def close(self) -> None:
        self.flush_block()
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        self._fh.write(BGZF_EOF)
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _iter_raw_blocks(fh: BinaryIO):
    """Walk BGZF member framing, yielding (deflate_payload, isize) pairs."""
    while True:
        header = fh.read(12)
        if len(header) < 12:
            return
        if header[:4] != b"\x1f\x8b\x08\x04":
            raise ValueError("not a BGZF stream (bad gzip/FEXTRA magic)")
        (xlen,) = struct.unpack("<H", header[10:12])
        extra = fh.read(xlen)
        bsize = None
        off = 0
        while off + 4 <= len(extra):
            si1, si2, slen = extra[off], extra[off + 1], struct.unpack("<H", extra[off + 2:off + 4])[0]
            if si1 == 0x42 and si2 == 0x43 and slen == 2:
                bsize = struct.unpack("<H", extra[off + 4:off + 6])[0] + 1
            off += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block missing BC subfield")
        payload_len = bsize - 12 - xlen - 8
        payload = fh.read(payload_len)
        footer = fh.read(8)
        if len(payload) < payload_len or len(footer) < 8:
            raise ValueError("truncated BGZF block")
        (_, isize) = struct.unpack("<II", footer)
        yield payload, isize


def iter_blocks(fh: BinaryIO) -> Iterator[bytes]:
    """Yield decompressed BGZF blocks from a file handle."""
    for payload, isize in _iter_raw_blocks(fh):
        try:
            data = zlib.decompress(payload, -15)
        except zlib.error as e:
            raise ValueError(f"corrupt BGZF block: {e}") from e
        if len(data) != isize:
            raise ValueError("BGZF block ISIZE mismatch")
        if data:
            yield data


def decompress(path: str) -> bytes:
    """Read a whole BGZF (or plain gzip-concatenated) file."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
        fh.seek(0)
        if magic[:2] != b"\x1f\x8b":
            return fh.read()
        if magic == b"\x1f\x8b\x08\x04":
            return b"".join(iter_blocks(fh))
        import gzip

        return gzip.decompress(fh.read())


def decompress_range(path: str, coffset_begin: int, coffset_end: int) -> bytes:
    """Decompress only the BGZF blocks whose file offsets lie in
    [coffset_begin, coffset_end] (inclusive of the block containing
    coffset_end)."""
    out = bytearray()
    with open(path, "rb") as fh:
        fh.seek(coffset_begin)
        offset = coffset_begin
        while offset <= coffset_end:
            header = fh.read(12)
            if len(header) < 12:
                break
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
            if bsize is None:
                raise ValueError("BGZF block missing BC subfield")
            payload_len = bsize - 12 - xlen - 8
            payload = fh.read(payload_len)
            footer = fh.read(8)
            if len(payload) < payload_len or len(footer) < 8:
                raise ValueError("truncated BGZF block")
            if payload:
                try:
                    out += zlib.decompress(payload, -15)
                except zlib.error as e:
                    raise ValueError(f"corrupt BGZF block: {e}") from e
            offset += bsize
    return bytes(out)


def stream_decompress(path: str):
    """Yield decompressed BGZF blocks lazily (for header-only parsing)."""
    with open(path, "rb") as fh:
        yield from iter_blocks(fh)


def iter_offset_blocks(path: str):
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
