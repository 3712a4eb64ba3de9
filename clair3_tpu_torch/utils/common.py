"""Shared base-encoding tables and logging helpers
(reference semantics: shared/utils.py:27-61)."""

from __future__ import annotations

# IUPAC ambiguity codes resolve to a deterministic ACGT base.
IUPAC_TO_ACGT = dict(zip(
    "ACGTURYSWKMBDHVN",
    ("A", "C", "G", "T", "T", "A", "C", "C", "A", "G", "A", "C", "A", "A", "A", "A"),
))

IUPAC_TO_NUM = dict(zip(
    "ACGTURYSWKMBDHVN",
    (0, 1, 2, 3, 3, 0, 1, 1, 0, 2, 0, 1, 0, 0, 0, 0),
))

BASIC_BASES = set("ACGTU")

_WARNING = "\033[93m"
_ERROR = "\033[91m"
_ENDC = "\033[0m"


def log_error(msg: str) -> str:
    return _ERROR + msg + _ENDC


def log_warning(msg: str) -> str:
    return _WARNING + msg + _ENDC


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
