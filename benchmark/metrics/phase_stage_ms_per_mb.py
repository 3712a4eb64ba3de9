"""``VariantCaller.stage_times["phase"]`` summed over the window's passes,
per megabase called."""


def read(rec):
    passes = [p for p in rec["passes"] if "phase" in p["stage_times"]]
    if not passes:
        return None
    mb = rec["bp_per_pass"] * len(passes) / 1e6
    return sum(p["stage_times"]["phase"] for p in passes) / mb * 1e3
