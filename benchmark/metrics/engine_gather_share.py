"""Share of the window the calling thread spent inside the engines'
``predict_async`` and ``gather`` (the program's ``<Net>.submit`` and
``<Net>.gather`` spans of both nets, whose seconds ``VariantCaller.run``
puts in ``stage_times`` under those names, summed over the window's
passes): the program's own twin of ``engine_wait_share``, which times the
same calls from the harness."""

NAMES = tuple(f"{net}.{step}" for net in ("PileupNet", "FullAlignmentNet")
              for step in ("submit", "gather"))


def read(rec):
    if (not any(n in p["stage_times"] for p in rec["passes"] for n in NAMES)
            or rec["window_s"] <= 0):
        return None
    return (sum(p["stage_times"].get(n, 0.0) for p in rec["passes"] for n in NAMES)
            / rec["window_s"] * 100.0)
