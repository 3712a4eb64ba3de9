"""Process start to window start: imports, CUDA context, kernel and native
builds (first run of a checkout only), engines, input simulation and the
warm pass."""


def read(rec):
    return rec["setup_s"]
