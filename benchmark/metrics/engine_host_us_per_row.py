"""The engines' host work on their submitter threads (the program's
``<Net>.pack`` spans, wire form and pad, and ``<Net>.pin`` spans, the
pinned copies, of both nets; ``VariantCaller.run`` puts the seconds of
every span closed during the call in ``stage_times`` under its name),
summed over the window's passes, per row: pileup candidates plus
full-alignment rows.  The warm-up batches that every pass queues are packed
and pinned too, and are counted here."""

NAMES = tuple(f"{net}.{step}" for net in ("PileupNet", "FullAlignmentNet")
              for step in ("pack", "pin"))


def read(rec):
    rows = rec["candidates"] + rec["fa_rows"]
    if not any(n in p["stage_times"] for p in rec["passes"] for n in NAMES) or not rows:
        return None
    return sum(p["stage_times"].get(n, 0.0) for p in rec["passes"] for n in NAMES) / rows * 1e6
