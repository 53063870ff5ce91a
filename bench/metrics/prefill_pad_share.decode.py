"""Share of the row-tokens the slice's admission prefills computed (every
slot at the bucket of the longest admitted prompt) that were padding: 1 -
real prompt tokens / computed row-tokens, from the program's
``serve.counts.admit`` counts, in %."""
from harness import spans


def read(r):
    c = spans.count_sums(r, spans.ADMIT_COUNTS)
    if not c or not c.get("computed"):
        return None
    return 100.0 * (1.0 - c["real"] / c["computed"])
