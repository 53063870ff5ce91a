"""95th percentile of submit-to-first-token over the requests whose first
token came in the window, with each request sent before the window closed
and still waiting counted at its wait so far."""
from harness import measure


def read(r):
    return measure.p95(measure.ttfts(r))
