"""Decode of both stages (the program's ``pileup.decode`` and ``fa.decode``
spans, whose seconds ``VariantCaller.run`` puts in ``stage_times`` under
those names), summed over the window's passes, per row: pileup candidates
plus full-alignment rows."""

NAMES = ("pileup.decode", "fa.decode")


def read(rec):
    rows = rec["candidates"] + rec["fa_rows"]
    if not any(n in p["stage_times"] for p in rec["passes"] for n in NAMES) or not rows:
        return None
    return sum(p["stage_times"].get(n, 0.0) for p in rec["passes"] for n in NAMES) / rows * 1e6
