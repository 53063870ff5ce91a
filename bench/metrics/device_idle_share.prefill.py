"""Share of the traced slice in which no kernel, copy or set ran on the
device, in %."""
from harness import measure


def read(r):
    return measure.idle_pct(r)
