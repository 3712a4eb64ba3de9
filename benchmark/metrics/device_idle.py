"""Share of the traced window in which no kernel, copy or set ran on the
card (``torch.profiler``)."""


def read(rec):
    t = rec.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return (1.0 - t["busy_s"] / t["window_s"]) * 100.0
