"""FASTA access with .fai indexing (samtools faidx-compatible), self-contained."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass(frozen=True)
class FaiEntry:
    name: str
    length: int
    offset: int
    line_bases: int
    line_width: int


def read_fai(path: str) -> Dict[str, FaiEntry]:
    entries: Dict[str, FaiEntry] = {}
    with open(path) as fh:
        for row in fh:
            cols = row.rstrip("\n").split("\t")
            if len(cols) < 5:
                continue
            entries[cols[0]] = FaiEntry(
                cols[0], int(cols[1]), int(cols[2]), int(cols[3]), int(cols[4])
            )
    return entries


def build_fai(fasta_path: str, fai_path: Optional[str] = None) -> Dict[str, FaiEntry]:
    """Index a FASTA (uniform line widths per record, as faidx requires)."""
    entries: Dict[str, FaiEntry] = {}
    order: List[str] = []
    with open(fasta_path, "rb") as fh:
        name = None
        length = 0
        offset = 0
        line_bases = 0
        line_width = 0
        pos = 0
        for raw in fh:
            line_len = len(raw)
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if name is not None:
                    entries[name] = FaiEntry(name, length, offset, line_bases, line_width)
                    order.append(name)
                name = line[1:].split()[0].decode()
                length = 0
                offset = pos + line_len
                line_bases = 0
                line_width = 0
            elif line:
                if line_bases == 0:
                    line_bases = len(line)
                    line_width = line_len
                length += len(line)
            pos += line_len
        if name is not None:
            entries[name] = FaiEntry(name, length, offset, line_bases, line_width)
            order.append(name)
    if fai_path:
        with open(fai_path, "w") as out:
            for n in order:
                e = entries[n]
                out.write(f"{e.name}\t{e.length}\t{e.offset}\t{e.line_bases}\t{e.line_width}\n")
    return entries


_INDEX_CACHE: Dict[tuple, "OrderedDictType"] = {}


class FastaFile:
    """Random access to FASTA sequence via the .fai index.

    Parsed indexes are cached per (path, mtime) — the pipeline opens the
    FASTA once per chunk, and re-scanning a whole-genome file to rebuild a
    missing index each time dominated the pileup stage.  A freshly built
    index is persisted to ``path + ".fai"`` (best effort)."""

    def __init__(self, path: str):
        self.path = path
        key = (os.path.abspath(path), os.path.getmtime(path))
        cached = _INDEX_CACHE.get(key)
        if cached is not None:
            self.index = cached
        else:
            fai = path + ".fai"
            if os.path.exists(fai):
                self.index = read_fai(fai)
            else:
                alt = os.path.splitext(path)[0] + ".fai"
                if os.path.exists(alt):
                    self.index = read_fai(alt)
                else:
                    try:
                        self.index = build_fai(path, fai_path=fai)
                    except OSError:  # read-only directory
                        self.index = build_fai(path, fai_path=None)
            if len(_INDEX_CACHE) < 64:
                _INDEX_CACHE[key] = self.index
        self._fh = open(path, "rb")

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def references(self) -> List[str]:
        return list(self.index)

    def contig_length(self, name: str) -> int:
        return self.index[name].length

    def fetch(self, name: str, start: int = 0, end: Optional[int] = None) -> str:
        """0-based half-open fetch, clamped to contig bounds, uppercased."""
        e = self.index[name]
        start = max(0, start)
        end = e.length if end is None else min(end, e.length)
        if start >= end:
            return ""
        first_line = start // e.line_bases
        first_col = start % e.line_bases
        file_start = e.offset + first_line * e.line_width + first_col
        last_line = (end - 1) // e.line_bases
        last_col = (end - 1) % e.line_bases
        file_end = e.offset + last_line * e.line_width + last_col + 1
        self._fh.seek(file_start)
        raw = self._fh.read(file_end - file_start)
        return raw.replace(b"\n", b"").replace(b"\r", b"").decode().upper()


def write_fasta(path: str, contigs: Dict[str, str], line_width: int = 70) -> None:
    """Write a FASTA plus its .fai (test fixtures and synthetic references)."""
    with open(path, "w") as fh:
        for name, seq in contigs.items():
            fh.write(f">{name}\n")
            for i in range(0, len(seq), line_width):
                fh.write(seq[i:i + line_width] + "\n")
    build_fai(path, fai_path=path + ".fai")
