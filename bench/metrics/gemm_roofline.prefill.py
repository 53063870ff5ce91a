"""Least time of the slice's admission prefills' matrix products over the
real prompt tokens, over the device time of the gemm-family kernels
launched in admissions (``serve.prefill_admit``), in %."""
from harness import flops, measure
from harness.trace import PREFILL


def read(r):
    if not measure.slice_ok(r):
        return None
    t = r.trace.family_s(PREFILL, "gemm")
    bound = sum(flops.prefill_gemm_bound_s(r.cfg, lengths)
                for lengths in measure.slice_admissions(r))
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
