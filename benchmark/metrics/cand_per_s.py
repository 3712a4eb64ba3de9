"""Pileup candidates of every finished pass over the window's seconds."""


def read(rec):
    if not rec["passes"] or rec["window_s"] <= 0:
        return None
    return rec["candidates"] / rec["window_s"]
