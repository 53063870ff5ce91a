"""Device kernels launched inside the slice's decode chunks
(``serve.decode_chunk``), per decode step."""
from harness import measure
from harness.trace import DECODE


def read(r):
    if not measure.slice_ok(r):
        return None
    chunks = r.trace.kernels_in(DECODE)
    if not chunks:
        return None
    n = sum(len(ks) for ks in chunks.values())
    return n / (len(chunks) * r.decode_chunk)
