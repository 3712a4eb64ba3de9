"""The calling thread's wait for native pileup extraction (the program's
``pileup.extract_wait`` spans, whose seconds ``VariantCaller.run`` puts in
``stage_times`` under that name), summed over the window's passes, per
pileup candidate."""

NAME = "pileup.extract_wait"


def read(rec):
    if not any(NAME in p["stage_times"] for p in rec["passes"]) or not rec["candidates"]:
        return None
    return sum(p["stage_times"].get(NAME, 0.0) for p in rec["passes"]) / rec["candidates"] * 1e6
