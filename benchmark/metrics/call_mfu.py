"""Both nets' operations for the real rows of the traced window
(``benchmark/flops.py``) over the window's seconds at the card's published
dense bf16 peak."""

from benchmark.flops import PEAK_BF16_FLOPS


def read(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or not rec["candidates"]:
        return None
    flops = (rec["candidates"] * rec["flops"]["pileup"]["flops_per_row"]
             + rec["fa_rows"] * rec["flops"]["fa"]["flops_per_row"])
    return flops / (t["window_s"] * PEAK_BF16_FLOPS) * 100.0
