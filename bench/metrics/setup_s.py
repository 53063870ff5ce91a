"""From the start of the benchmark's process to the window's opening:
imports, the kernels' build or load, the weights, warm-up, and the
clients' first admissions."""


def read(r):
    return r.setup_s
