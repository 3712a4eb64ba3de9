"""``VariantCaller.stage_times["full_alignment"]`` summed over the window's
passes, per full-alignment row: extraction with haplotagging, the engine,
decode."""


def read(rec):
    if not rec["fa_rows"]:
        return None
    return (sum(p["stage_times"].get("full_alignment", 0.0) for p in rec["passes"])
            / rec["fa_rows"] * 1e6)
