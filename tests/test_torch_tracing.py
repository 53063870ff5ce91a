"""The port's spans and counts (``profiling.annotate`` / ``count``) and the
engine's telemetry: the spans a traced continuous MoE drain records and
where they nest, the ``serve.counts.*`` counts against hand counts and
against ``Engine.stats()``, and the queue wait in the stats schema."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.catalog import get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.profiling import (annotate, count, parse_count,  # noqa: E402
                                   trace)
from repro_torch.profiling import tracer  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402
from repro_torch.serve import stats_schema  # noqa: E402

MODEL_SPANS = ("model.attn", "model.moe.route", "model.moe.dispatch",
               "model.moe.experts", "model.moe.combine")
SLOTS, CHUNK, MAX_NEW = 4, 4, 6
#: the first four fill the slots (bucket 16); the last two wait for them
#: to finish after two chunks and are admitted together (bucket 8)
PROMPT_LENS = (5, 9, 3, 12, 7, 6)


def _recording(monkeypatch):
    """Count the ``record_function`` ranges entered."""
    entered = []
    real = torch.profiler.record_function

    def recording(name, *a, **k):
        entered.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", recording)
    return entered


def test_annotate_and_count_enter_nothing_without_a_profiler(monkeypatch,
                                                            tmp_path):
    entered = _recording(monkeypatch)
    with annotate("model.attn"):
        count("serve.counts.chunk", rows=1)
    assert entered == []
    with trace(str(tmp_path)) as s:
        with annotate("model.attn"):
            count("serve.counts.chunk", rows=1)
    assert entered == ["model.attn", "serve.counts.chunk rows=1"]
    names = [e["name"] for e in s.events()
             if e.get("cat") == "user_annotation"]
    assert names.count("model.attn") == 1
    assert names.count("serve.counts.chunk rows=1") == 1


@pytest.mark.parametrize("values", [
    {}, {"rows": 4}, {"real": 29, "computed": 64, "routed": 0},
    {"n": -3, "big": 2 ** 40}])
def test_count_labels_parse_back(values):
    label = tracer.count_label("serve.counts.admit", values)
    assert label.split(" ")[0] == "serve.counts.admit"
    assert parse_count(label) == ("serve.counts.admit", values)


@pytest.fixture(scope="module")
def traced_drain(tmp_path_factory):
    """A traced continuous drain of six prompts on four slots of the
    reduced OLMoE, prefix cache off: ``(engine, stats before, stats
    after, events)``."""
    cfg = get_config("olmoe-1b-7b").reduced()
    model = build_model(cfg)
    eng = Engine(model, model.init(0, device="cpu"), ServeConfig(
        max_batch=SLOTS, max_len=64, decode_chunk=CHUNK, prefix_cache=False,
        device="cpu"))
    prompts = [[(7 * i + j) % cfg.vocab_size for j in range(n)]
               for i, n in enumerate(PROMPT_LENS)]
    before = eng.stats()
    with trace(str(tmp_path_factory.mktemp("cap"))) as s:
        eng.generate(prompts, MAX_NEW)
    return eng, before, eng.stats(), s.events()


def _spans(events, name):
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e["name"] == name]


def _within(span, outer):
    return any(a <= span[0] and span[1] <= b for a, b in outer)


def _counts(events, name):
    out = []
    for e in events:
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith(name + " "):
            out.append(parse_count(e["name"])[1])
    return out


def test_each_span_nests_where_it_belongs(traced_drain):
    _, _, _, events = traced_drain
    chunks = _spans(events, "serve.decode_chunk")
    admits = _spans(events, "serve.prefill_admit")
    assert len(chunks) == 4 and len(admits) == 2
    for name in MODEL_SPANS:
        spans = _spans(events, name)
        assert any(_within(s, chunks) for s in spans), name
        assert any(_within(s, admits) for s in spans), name
        assert all(_within(s, chunks + admits) for s in spans), name
    for name in ("serve.kv_gather", "serve.kv_scatter"):
        spans = _spans(events, name)
        assert len(spans) == len(chunks), name
        assert all(_within(s, chunks) for s in spans), name
    # the engine's host work: the chunks' index packing, each
    # admission's bookkeeping and packing, each boundary's page growth
    schedule = _spans(events, "serve.schedule")
    assert len(schedule) >= len(chunks) + 2 * len(admits)
    assert not any(_within(s, chunks + admits) for s in schedule)
    ops = [(e["ts"], e["ts"] + e["dur"]) for e in events
           if e.get("cat") == "cpu_op"]
    assert ops
    assert not any(_within(op, schedule) for op in ops)


def test_counts_equal_hand_counts_and_stats(traced_drain):
    eng, before, after, events = traced_drain
    cfg = eng.model.cfg
    e, k, layers = cfg.num_experts, cfg.experts_per_token, cfg.num_layers

    def routed(s):
        return SLOTS * s * k * layers

    def rows(s):
        return e * SLOTS * moe.capacity(s, e, k, cfg.moe_capacity_factor) \
            * layers

    first, second = PROMPT_LENS[:SLOTS], PROMPT_LENS[SLOTS:]
    assert _counts(events, "serve.counts.admit") == [
        dict(rows=4, real=sum(first), computed=SLOTS * 16,
             routed=routed(16), expert_rows=rows(16)),
        dict(rows=2, real=sum(second), computed=SLOTS * 8,
             routed=routed(8), expert_rows=rows(8))]
    step = dict(steps=CHUNK, slot_steps=SLOTS * CHUNK,
                routed=routed(1) * CHUNK, expert_rows=rows(1) * CHUNK)
    # a request's first chunk delivers its prefill's token and three
    # more, its second the last two of its six
    assert _counts(events, "serve.counts.chunk") == [
        dict(step, rows=4, tokens=16), dict(step, rows=4, tokens=8),
        dict(step, rows=2, tokens=8), dict(step, rows=2, tokens=4)]

    def delta(key):
        return after[key] - before[key]
    admit = _counts(events, "serve.counts.admit")
    chunk = _counts(events, "serve.counts.chunk")
    assert delta("prefill_rows") == sum(c["rows"] for c in admit) == 6
    assert delta("prefill_prompt_tokens") == sum(PROMPT_LENS)
    assert delta("prefill_row_tokens") == sum(c["computed"] for c in admit)
    assert delta("decode_live_row_steps") == sum(c["rows"] * c["steps"]
                                                 for c in chunk)
    assert delta("decode_slot_steps") == sum(c["slot_steps"] for c in chunk)
    assert delta("tokens_generated") == sum(c["tokens"] for c in chunk) \
        == MAX_NEW * len(PROMPT_LENS)
    for key, name in (("moe_routed", "routed"),
                      ("moe_expert_rows", "expert_rows")):
        assert delta(key) == sum(c[name] for c in admit + chunk)


def test_stats_validate_at_schema_3_with_the_queue_wait(traced_drain):
    eng, _, st, _ = traced_drain
    assert st["schema_version"] == stats_schema.SCHEMA_VERSION == 3
    assert stats_schema.validate_stats(st) == []
    wait = st["latency"]["queue_wait_s"]
    assert set(wait) == set(stats_schema.PCTL_KEYS)
    # the last two requests waited two chunks for a slot
    assert 0.0 <= wait["p50"] <= wait["p99"]
    assert wait["p99"] > 0.0
    # on the CPU each region's seconds come from the host clock
    assert st["prefill_seconds"] > 0.0 and st["decode_seconds"] > 0.0
    assert st["prefill_seconds"] + st["decode_seconds"] <= \
        st["total_seconds"]
