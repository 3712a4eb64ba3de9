"""The calling thread's wait for native full-alignment extraction (the
program's ``fa.extract_wait`` spans, whose seconds ``VariantCaller.run`` puts
in ``stage_times`` under that name), summed over the window's passes, per
full-alignment row."""

NAME = "fa.extract_wait"


def read(rec):
    if not any(NAME in p["stage_times"] for p in rec["passes"]) or not rec["fa_rows"]:
        return None
    return sum(p["stage_times"].get(NAME, 0.0) for p in rec["passes"]) / rec["fa_rows"] * 1e6
