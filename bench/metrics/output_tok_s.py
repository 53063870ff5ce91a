"""Tokens delivered to clients per second, over every pass the window
touches: from the last scheduler boundary at or before its opening to the
first at or after its close, every token the passes after the first
delivered (requests still running count what they got).  See
``measure.whole_pass_rate``."""
from harness import measure


def read(r):
    return measure.whole_pass_rate(r)
