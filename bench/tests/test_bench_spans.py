"""The readers of the program's spans and counts on a synthetic Chrome
trace: which kernels a span's share counts, how the count ranges parse,
and None where the slice holds nothing to read."""
from __future__ import annotations

import types

import pytest

from harness import catalog, spans
from harness.trace import Trace

SPAN_METRICS = {
    "attn_share.decode": "model.attn",
    "kv_copy_share.decode": "serve.kv_gather",
    "moe_route_share.decode": "model.moe.route",
    "moe_dispatch_share.decode": "model.moe.dispatch",
    "moe_expert_share.decode": "model.moe.experts",
}


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "args": {"correlation": corr}}


def _kernel(corr, ts, dur, name="k"):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _events(inner="model.attn"):
    """An admission prefill and a decode chunk, each with one ``inner``
    span; kernels launched inside and outside them."""
    return [
        _span("serve.prefill_admit", 10, 40),
        _span(inner, 20, 10),
        _launch(1, 25), _kernel(1, 60, 100),       # inner, in the prefill
        _span("serve.decode_chunk", 100, 100),
        _launch(2, 105), _kernel(2, 170, 30),      # chunk, outside inner
        _span(inner, 110, 20),
        _launch(3, 115), _kernel(3, 200, 10),      # inner, in the chunk
        _launch(4, 250), _kernel(4, 260, 500),     # outside any span
        _span("serve.counts.admit real=29 computed=64 rows=4", 51, 0),
        _span("serve.counts.chunk rows=4 routed=64 expert_rows=2048", 201,
              0),
        _span("serve.counts.chunk rows=2 routed=64 expert_rows=2048", 202,
              0),
    ]


def _record(events):
    return types.SimpleNamespace(trace=Trace(events))


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_a_share_counts_the_decode_chunks_kernels_inside_its_span(metric):
    """Of the chunk's 40 us of kernels, the 10 launched inside the span;
    the prefill's kernel inside the same span is not the decode's."""
    read = catalog.metric_reader(metric)
    assert read(_record(_events(SPAN_METRICS[metric]))) == \
        pytest.approx(25.0)
    assert read(_record(_events("another.span"))) is None


def test_the_kv_copy_share_counts_gather_and_scatter_once_each():
    ev = _events("serve.kv_gather") + [
        _span("serve.kv_scatter", 140, 20), _span("serve.decode_chunk", 300,
                                                  10),
        _launch(5, 150), _kernel(5, 210, 30)]
    assert catalog.metric_reader("kv_copy_share.decode")(_record(ev)) == \
        pytest.approx(100.0 * 40 / 70)


def test_count_ranges_parse_and_sum():
    assert spans.parse_count("serve.counts.chunk rows=4 routed=-1") == (
        "serve.counts.chunk", {"rows": 4, "routed": -1})
    assert spans.parse_count("model.attn") == ("model.attn", {})
    r = _record(_events())
    assert spans.count_sums(r, spans.CHUNK_COUNTS) == {
        "rows": 6, "routed": 128, "expert_rows": 4096}
    assert catalog.metric_reader("expert_fill.decode")(r) == \
        pytest.approx(100.0 * 128 / 4096)
    assert catalog.metric_reader("prefill_pad_share.decode")(r) == \
        pytest.approx(100.0 * (1 - 29 / 64))


def test_count_readers_read_none_without_their_counts():
    plain = [e for e in _events() if " " not in e["name"]]
    for metric in ("expert_fill.decode", "prefill_pad_share.decode"):
        assert catalog.metric_reader(metric)(_record(plain)) is None
        assert catalog.metric_reader(metric)(
            types.SimpleNamespace(trace=None)) is None


def test_every_new_metric_is_in_the_benchmark_with_its_cell():
    spec = catalog.load_spec()
    listed = {m["name"]: m for m in spec["per_layer"]}
    for name in list(SPAN_METRICS) + ["expert_fill.decode",
                                      "prefill_pad_share.decode"]:
        assert listed[name]["workloads"] == ["olmoe-widths-capdrop.reasoning"]
        assert listed[name]["unit"] == "%"
