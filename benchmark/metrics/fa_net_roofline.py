"""The least time the card could take for the full-alignment net's real rows
of the window, at the full matrix depth the net computes on
(``benchmark/flops.py``), over the device time of every kernel under the
engine's ``FullAlignmentNet.forward`` label."""

from benchmark.flops import least_seconds

LABEL = "FullAlignmentNet.forward"


def read(rec):
    t = rec.get("trace")
    if not t or not t["label_device_s"].get(LABEL) or not rec["fa_rows"]:
        return None
    least = least_seconds(rec["fa_rows"], t["label_calls"][LABEL], rec["flops"]["fa"])
    return least / t["label_device_s"][LABEL] * 100.0
