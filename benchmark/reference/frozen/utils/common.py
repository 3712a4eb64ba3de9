"""Shared base-encoding tables
(reference semantics: shared/utils.py:27-61)."""

from __future__ import annotations

# IUPAC ambiguity codes resolve to a deterministic ACGT base.
IUPAC_TO_ACGT = dict(zip(
    "ACGTURYSWKMBDHVN",
    ("A", "C", "G", "T", "T", "A", "C", "C", "A", "G", "A", "C", "A", "A", "A", "A"),
))


def convert_iupac_to_n(string: str) -> str:
    """Replace non-ACGTN characters with N (kept verbatim for '.')."""
    if string == ".":
        return string
    out = []
    changed = False
    for s in string:
        if s.upper() not in "ACGTN,.":
            changed = True
            out.append("N")
        else:
            out.append(s)
    return "".join(out) if changed else string
