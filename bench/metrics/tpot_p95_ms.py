"""95th percentile over requests with two deliveries or more in the
window of (last delivery - first delivery) / tokens after the first, in
ms.  Tokens come a decode chunk at a time; a delivery is one chunk's."""
from harness import measure


def read(r):
    v = measure.p95(measure.tpots(r))
    return None if v is None else 1e3 * v
