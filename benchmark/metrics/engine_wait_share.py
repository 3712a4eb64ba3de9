"""Share of the window the calling thread spent inside the engines'
``predict_async`` and ``gather`` (the harness's engine proxy)."""


def read(rec):
    if rec["window_s"] <= 0 or not rec["passes"]:
        return None
    return rec["engine_wait_s"] / rec["window_s"] * 100.0
