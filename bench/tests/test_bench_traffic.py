"""Seeded traffic: deterministic, the same sizes for every seed, the
stated medians and clips."""
from __future__ import annotations

import json
import statistics

import pytest

from conftest import BENCH, ROOT, TINY_TRAFFIC
from harness import traffic

#: every cell of BENCHMARK.json, and the CPU tests' tiny traffic
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]
         ] + ["tiny"]


def _t(cell):
    if cell == "tiny":
        return dict(TINY_TRAFFIC)
    return json.loads((BENCH / "traffic" / f"{cell}.json").read_text())


@pytest.mark.parametrize("cell", CELLS)
def test_lengths_keep_the_stated_median_and_clips(cell):
    t = _t(cell)
    tr = traffic.Traffic(t, 1000, 5)
    for lengths, dist in ((tr.prompts, t["prompt"]), (tr.outputs, t["output"])):
        assert min(lengths) >= dist["min"] and max(lengths) <= dist["max"]
        # an even deck has no middle entry: its two middle levels straddle
        # the median
        assert abs(statistics.median(lengths) - dist["median"]) <= \
            0.02 * dist["median"]
    # the longest request fits a slot
    assert max(tr.prompts) + max(tr.outputs) <= t["max_len"]


@pytest.mark.parametrize("cell", CELLS)
def test_same_seed_same_requests_other_seed_same_sizes(cell):
    t = _t(cell)
    big = 2 ** 31 + 12345

    def draw(seed, n=2 * t["deck"] + 5):
        tr = traffic.Traffic(t, 50304, seed)
        return [tr.request(i % t["clients"]) for i in range(n)]
    a, b, c = draw(big), draw(big), draw(big + 1)
    assert a == b
    assert [x.prompt for x in a] != [x.prompt for x in c]
    first = t["clients"]
    # each pass over the deck holds its sizes, whatever the seed
    d = t["deck"]
    deck = sorted(traffic.Traffic(t, 50304, 0).prompts)
    for run in (a, c):
        for lo in (0, d):
            assert sorted(len(x.prompt) for x in run[lo:lo + d]) == deck
    # the first requests' residual budgets too, in another order
    assert sorted(x.max_new for x in a[:first]) == \
        sorted(x.max_new for x in c[:first])


def test_residual_budgets_spread_below_the_outputs():
    outs = [100] * 10
    r = traffic.residual_quantiles(outs, 10)
    assert r == sorted(r) and r[0] >= 1 and r[-1] <= 100
    assert abs(statistics.median(r) - 50) <= 5


def test_a_deck_pass_holds_the_deck():
    t = _t("olmoe-widths-capdrop.reasoning")
    tr = traffic.Traffic(t, 100, 9)
    d = t["deck"]
    got = [tr._length("prompt", i) for i in range(d)]
    assert sorted(got) == sorted(tr.prompts)
    assert traffic.bucket(1) == 8 and traffic.bucket(129) == 256
    assert tr.buckets() == [128, 256, 512]


def test_prepared_requests_are_the_requests_drawn_as_sent():
    t = _t("tiny")
    drawn, prepared = traffic.Traffic(t, 256, 77), traffic.Traffic(t, 256, 77)
    prepared.prepare(10)
    a = [drawn.request(i % 6) for i in range(25)]
    b = [prepared.request(i % 6) for i in range(25)]
    assert a == b
    assert prepared.drawn_late == 15 and drawn.drawn_late == 25
