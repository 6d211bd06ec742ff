"""Process start to the first timed frame: imports, the lap's render, the
kernels' build or load, the bootstrap and the graphs' capture."""


def read(rec):
    return rec["setup_s"]
