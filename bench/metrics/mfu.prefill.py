"""The slice's useful model FLOPs (decoded tokens at their own contexts,
admitted prompts' real tokens) over its seconds times the H100's dense
bf16 peak, in %."""
from harness import measure


def read(r):
    return measure.mfu_pct(r)
