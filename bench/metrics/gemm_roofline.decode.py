"""Least time of the slice's decode matrix products (projections, router,
experts, unembed, attention's two products at each row's context) over
the device time of the gemm-family kernels launched in decode chunks, in
% (harness.flops for the counts)."""
from harness import measure
from harness.trace import DECODE


def read(r):
    if not measure.slice_ok(r):
        return None
    t = r.trace.family_s(DECODE, "gemm")
    bound = measure.decode_gemm_bound_s(r)
    if t <= 0 or bound <= 0:
        return None
    return 100.0 * bound / t
