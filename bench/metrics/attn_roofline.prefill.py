"""Least time of the slice's admission prefills' causal attention over
the real prompts, over the device time of the attention-family kernels
launched in admissions, in %."""
from harness import flops, measure
from harness.trace import PREFILL


def read(r):
    if not measure.slice_ok(r):
        return None
    t = r.trace.family_s(PREFILL, "attention")
    bound = sum(flops.prefill_attention_bound_s(r.cfg, lengths)
                for lengths in measure.slice_admissions(r))
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
