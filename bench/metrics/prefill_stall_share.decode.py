"""Share of the slice in which the device runs admission prefills (from
the first to the last kernel each ``serve.prefill_admit`` launched),
during which no row decodes, in %."""
from harness import measure
from harness.trace import PREFILL


def read(r):
    if not measure.slice_ok(r):
        return None
    return 100.0 * r.trace.device_span_s(PREFILL) / r.trace.window_s
