"""Fill of the MoE expert buffers in the slice's decode chunks: routed
(token, choice) pairs over the expert buffer rows computed, padding
included, from the program's ``serve.counts.chunk`` counts, in %."""
from harness import spans


def read(r):
    c = spans.count_sums(r, spans.CHUNK_COUNTS)
    if not c or not c.get("expert_rows"):
        return None
    return 100.0 * c["routed"] / c["expert_rows"]
