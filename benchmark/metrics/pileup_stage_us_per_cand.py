"""``VariantCaller.stage_times["pileup"]`` summed over the window's passes,
per pileup candidate: native extraction, the engine, decode."""


def read(rec):
    if not rec["candidates"]:
        return None
    return sum(p["stage_times"].get("pileup", 0.0) for p in rec["passes"]) / rec["candidates"] * 1e6
