"""The phaser's fetch, decode and allele scan of each contig's reads (the
program's ``phase.reads`` spans, whose seconds ``VariantCaller.run`` puts in
``stage_times`` under that name), summed over the window's passes, per
megabase called."""

NAME = "phase.reads"


def read(rec):
    if not any(NAME in p["stage_times"] for p in rec["passes"]):
        return None
    mb = rec["bp_per_pass"] * len(rec["passes"]) / 1e6
    return sum(p["stage_times"].get(NAME, 0.0) for p in rec["passes"]) / mb * 1e3
