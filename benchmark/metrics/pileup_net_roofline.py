"""The least time the card could take for the pileup net's real rows of the
window (``benchmark/flops.py``) over the device time of every kernel under
the engine's ``PileupNet.forward`` label."""

from benchmark.flops import least_seconds

LABEL = "PileupNet.forward"


def read(rec):
    t = rec.get("trace")
    if not t or not t["label_device_s"].get(LABEL) or not rec["candidates"]:
        return None
    least = least_seconds(rec["candidates"], t["label_calls"][LABEL], rec["flops"]["pileup"])
    return least / t["label_device_s"][LABEL] * 100.0
