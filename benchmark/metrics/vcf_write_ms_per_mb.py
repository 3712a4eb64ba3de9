"""Writing the VCFs of a pass (the program's ``vcf.write`` spans, the BGZF
writer, and ``vcf.index`` spans, the tabix index, whose seconds
``VariantCaller.run`` puts in ``stage_times`` under those names), summed
over the window's passes, per megabase called."""

NAMES = ("vcf.write", "vcf.index")


def read(rec):
    if not any(n in p["stage_times"] for p in rec["passes"] for n in NAMES):
        return None
    mb = rec["bp_per_pass"] * len(rec["passes"]) / 1e6
    return sum(p["stage_times"].get(n, 0.0) for p in rec["passes"] for n in NAMES) / mb * 1e3
