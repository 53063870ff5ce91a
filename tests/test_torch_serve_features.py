"""The port's serve features against the JAX package on the same bridged
weights: the wave scheduler, the int8 KV cache, sampling, streaming, the
threaded Server, the versioned stats schema and the launcher's flags.

Tokens are compared exactly (reduced llama3.2-1b in float32; the flash
path runs through the kernels' plain versions on the CPU and through the
JAX package's flash kernel in interpret mode).  int8 decode logits are
compared at atol=rtol=1e-4.  Sampled tokens cannot match ``jax.random``'s
bits, so sampling is held to structural properties only.
"""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.catalog import ARCHITECTURES  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import Request as JaxRequest  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import stats_schema as jax_schema  # noqa: E402
from repro_torch.configs.catalog import ARCHITECTURES as PORT_ARCHS  # noqa: E402
from repro_torch.models import build_model, layers, params_from_numpy  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Engine, Request, ServeConfig, Server, StreamEvent, api, stats_schema)

RAGGED = [[5, 9, 2, 7], [1, 3, 3], [2, 4, 6, 8, 1, 5, 3]]     # test_serve_engine.py:26
LONG_SHORT = [[(i * 7 + 3) % 256 for i in range(37)],
              [(i * 5 + 1) % 256 for i in range(11)]]       # test_serve_engine.py:78-86
TRAFFIC = {"ragged": (RAGGED, 64), "long_short": (LONG_SHORT, 128)}
MAX_NEW = 9


@pytest.fixture(scope="module")
def jax_params():
    return jax_build_model(ARCHITECTURES["llama3.2-1b"].reduced()).init(
        jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params),
                             device="cpu")


def _cfgs(impl="chunked", **kw):
    jcfg = dataclasses.replace(ARCHITECTURES["llama3.2-1b"].reduced(),
                               attention_impl=impl, **kw)
    pcfg = dataclasses.replace(PORT_ARCHS["llama3.2-1b"].reduced(),
                               attention_impl=impl, **kw)
    return jcfg, pcfg


def _engines(jax_params, port_params, impl="chunked", model_kw=None,
             **serve_kw):
    """(JAX engine, port engine) over the same weights and ServeConfig."""
    jcfg, pcfg = _cfgs(impl, **(model_kw or {}))
    kw = dict(max_batch=3, max_len=64)
    kw.update(serve_kw)
    jeng = JaxEngine(jax_build_model(jcfg), jax_params, JaxServeConfig(**kw))
    peng = Engine(build_model(pcfg), port_params,
                  ServeConfig(device="cpu", **kw))
    return jeng, peng


# ---------------------------------------------------------------------------
# wave scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("traffic", ["ragged", "long_short"])
@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_wave_engine_matches_jax_wave_engine(impl, traffic, jax_params,
                                             port_params):
    prompts, max_len = TRAFFIC[traffic]
    jeng, peng = _engines(jax_params, port_params, impl, max_len=max_len,
                          scheduler="wave")
    assert peng.generate(prompts, MAX_NEW) == jeng.generate(prompts, MAX_NEW)
    st = peng.stats()
    assert st["scheduler"] == "wave" and st["scheduler_forced"] is None
    assert st["waves"] == 1 and st["device_transfers"] == st["waves"]
    assert st["cache_allocs"] == 1 and st["chunks"] == 0
    assert st["prefill_plen_buckets"] == \
        jeng.stats()["prefill_plen_buckets"]


def test_wave_more_prompts_than_slots(jax_params, port_params):
    """Five requests over two slots run in three waves; the dense cache is
    reused across them (stale columns never read) and slots are reused."""
    prompts = RAGGED + LONG_SHORT
    jeng, peng = _engines(jax_params, port_params, "flash", max_batch=2,
                          max_len=128, scheduler="wave")
    assert peng.generate(prompts, MAX_NEW) == jeng.generate(prompts, MAX_NEW)
    st, jst = peng.stats(), jeng.stats()
    assert st["waves"] == jst["waves"] == 3
    assert st["device_transfers"] == 3 and st["cache_allocs"] == 1
    assert st["slot_reuses"] == jst["slot_reuses"] == 3


def test_wave_near_capacity_plen_clamp(jax_params, port_params):
    """At max_len 48, prompts of 38 and 40 tokens with 4 new ones share the
    bucket 64 clamped to the 40 columns the decode width (8) leaves; 42 + 5
    leaves too little for the width and falls back to the exact need (43).
    The tokens equal the JAX wave engine's."""
    jeng, peng = _engines(jax_params, port_params, max_len=48,
                          scheduler="wave")
    for plen, new in ((38, 4), (40, 4), (42, 5)):
        prompt = [(i * 7 + 3) % 256 for i in range(plen)]
        assert peng.generate([prompt], new) == jeng.generate([prompt], new)
    buckets = peng.stats()["prefill_plen_buckets"]
    assert buckets == jeng.stats()["prefill_plen_buckets"] == [40, 43]


def _drain_waves(eng, requests):
    for p, n in requests:
        eng.submit((JaxRequest if isinstance(eng, JaxEngine) else Request)(
            prompt=p, max_new_tokens=n))
    waves = []
    while eng._queue:
        waves.append([r.rid for r in eng._pack_wave()])
    return waves


def test_wave_packing_matches_jax(jax_params, port_params):
    """A mixed long-prompt / long-budget queue packs into the same waves as
    the JAX package's ``_pack_wave``, and serves the same tokens."""
    requests = [([1] * 12, 3), ([2, 3], 12), ([4] * 10, 2), ([5, 6], 10),
                ([7] * 3, 4), ([8] * 13, 3), ([9, 1], 9)]
    jeng, peng = _engines(jax_params, port_params, max_batch=3, max_len=16,
                          scheduler="wave")
    waves = _drain_waves(peng, requests)
    assert waves == _drain_waves(jeng, requests)
    assert len(waves) > 2
    for eng in (jeng, peng):
        for p, n in requests:
            eng.submit((JaxRequest if eng is jeng else Request)(
                prompt=p, max_new_tokens=n))
    assert [r.tokens for r in peng.run()] == [r.tokens for r in jeng.run()]
    assert peng.stats()["waves"] == jeng.stats()["waves"] == len(waves)


def test_wave_rejects_what_exceeds_max_len(jax_params, port_params):
    _, peng = _engines(jax_params, port_params, max_len=16, scheduler="wave")
    with pytest.raises(ValueError, match="max_len"):
        peng.submit(Request(prompt=[1] * 12, max_new_tokens=8))
    assert peng.stats()["requests"] == 0
    assert len(peng.generate([[1, 2]], 3)[0]) == 3


# ---------------------------------------------------------------------------
# int8 KV cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bits_equal_jax(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 33, 2, 16)) * 4).astype(np.float32)
    x[0, 0] = 0.0                          # all-zero rows: the 1e-6 floor
    x[1, 2, 1] = 0.0                       # scale 1: exact halves, which
    x[1, 2, 1, :5] = [127.0, 0.5, -0.5, 1.5, 2.5]   # round half to even
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    jq, js = jax_layers.kv_quantize(jx)
    tq, ts = layers.kv_quantize(tx)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        layers.kv_dequantize(tq, ts, torch.float32).numpy(),
        np.asarray(jax_layers.kv_dequantize(jq, js, jnp.float32)))


def test_int8_decode_logits_match_jax(jax_params, port_params):
    jcfg, pcfg = _cfgs("chunked", kv_quant=True)
    jm, pm = jax_build_model(jcfg), build_model(pcfg)
    toks = np.asarray([[0, 0, 5, 9, 2, 7], [2, 4, 6, 8, 1, 5]], np.int32)
    ks = np.asarray([2, 0], np.int32)
    jl, jc = jm.prefill(jax_params, {"tokens": jnp.asarray(toks),
                                     "kv_start": jnp.asarray(ks)},
                        jm.init_cache(2, 16))
    pcache = pm.init_cache(2, 16, device="cpu")
    assert pcache["self"][0]["q"].dtype == torch.int8
    pl, pcache = pm.prefill(port_params, {"tokens": torch.from_numpy(toks),
                                          "kv_start": torch.from_numpy(ks)},
                            pcache)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)
    cur = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
    for step in range(3):
        jl, jc = jm.decode_step(jax_params, jnp.asarray(cur), jc,
                                jnp.int32(6 + step), jnp.asarray(ks))
        pl, pcache = pm.decode_step(port_params, torch.from_numpy(cur),
                                    pcache, 6 + step, torch.from_numpy(ks))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=1e-4)
        cur = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_int8_engine_matches_jax_int8_engine(impl, jax_params, port_params):
    """Both engines force the wave scheduler for an int8 cache, with the
    same reason, and serve the same tokens."""
    prompts = RAGGED + LONG_SHORT[1:]
    jeng, peng = _engines(jax_params, port_params, impl,
                          model_kw=dict(kv_quant=True), max_batch=2,
                          max_len=64)
    assert peng.generate(prompts, MAX_NEW) == jeng.generate(prompts, MAX_NEW)
    st, jst = peng.stats(), jeng.stats()
    assert st["scheduler"] == jst["scheduler"] == "wave"
    assert st["scheduler_forced"] == jst["scheduler_forced"]
    assert st["waves"] == jst["waves"] == 2


# ---------------------------------------------------------------------------
# sampling (structural: torch cannot reproduce jax.random's bits)
# ---------------------------------------------------------------------------

def _sampler(port_params, **serve_kw):
    _, pcfg = _cfgs()
    kw = dict(max_batch=3, max_len=64, device="cpu", temperature=0.8)
    kw.update(serve_kw)
    return Engine(build_model(pcfg), port_params, ServeConfig(**kw))


@pytest.mark.parametrize("scheduler,cache", [("continuous", False),
                                             ("continuous", True),
                                             ("wave", False)])
def test_same_seed_same_samples(scheduler, cache, port_params):
    """The generator is re-seeded at every run(): repeated generate calls
    on one engine give the same samples (two fresh engines with the prefix
    cache on, whose second call would otherwise hit the cache)."""
    eng = _sampler(port_params, scheduler=scheduler, prefix_cache=cache)
    first = eng.generate(RAGGED, MAX_NEW)
    again = (_sampler(port_params, scheduler=scheduler, prefix_cache=cache)
             if cache else eng)
    assert again.generate(RAGGED, MAX_NEW) == first
    assert all(len(t) == MAX_NEW and all(0 <= x < 256 for x in t)
               for t in first)
    st = eng.stats()
    assert st["device_transfers"] == st["chunks"] + st["waves"]


def test_different_seeds_differ(port_params):
    outs = [_sampler(port_params, seed=s, temperature=1.5).generate(
        RAGGED, MAX_NEW) for s in (0, 1)]
    assert any(a != b for a, b in zip(*outs))


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
def test_tiny_temperature_equals_greedy(scheduler, port_params):
    greedy = _sampler(port_params, temperature=0.0, scheduler=scheduler)
    tiny = _sampler(port_params, temperature=1e-6, scheduler=scheduler)
    assert tiny.generate(RAGGED, MAX_NEW) == greedy.generate(RAGGED, MAX_NEW)


def test_gumbel_sampler_frequencies_follow_softmax(port_params):
    """20,000 seeded draws on fixed logits against softmax(logits / T):
    chi-square at p > 0.001."""
    from scipy.stats import chisquare
    eng = _sampler(port_params, temperature=0.8)
    eng._gen.manual_seed(0)
    logits = torch.tensor([1.0, 0.5, -0.5, 2.0, 0.0, -2.0, 1.5, 0.25])
    draws = eng._sample(logits.expand(20_000, -1))
    assert draws.dtype == torch.int32
    counts = np.bincount(draws.numpy(), minlength=8)
    expected = torch.softmax(logits / 0.8, -1).double().numpy() * 20_000
    assert chisquare(counts, expected).pvalue > 1e-3, counts


# ---------------------------------------------------------------------------
# streaming: the port's events equal the JAX engine's
# ---------------------------------------------------------------------------

def _events(eng, req_cls, prompts, budgets):
    log = []
    for p, n in zip(prompts, budgets):
        eng.submit(req_cls(prompt=p, max_new_tokens=n, stream=log.append))
    eng.run()
    return [(e.request_id, e.token, e.index, e.finished, e.finish_reason)
            for e in log]


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
def test_stream_events_match_jax(scheduler, jax_params, port_params):
    """Same traffic through both engines: the same event sequence, tokens
    then one terminal event per request.  The continuous case runs a pool
    small enough to preempt (tokens streamed before a preemption are
    streamed again from index 0 after the restart, in both packages)."""
    kw = dict(max_batch=3, scheduler=scheduler)
    if scheduler == "continuous":
        kw.update(page_size=2, capacity_tokens=24, decode_chunk=2)
    jeng, peng = _engines(jax_params, port_params, **kw)
    prompts = RAGGED + RAGGED[::-1]
    budgets = [MAX_NEW, 3, 6, 2, MAX_NEW, 5]
    got = _events(peng, Request, prompts, budgets)
    assert got == _events(jeng, JaxRequest, prompts, budgets)
    assert sum(e[3] for e in got) == len(prompts)
    if scheduler == "continuous":
        assert peng.stats()["preemptions"] > 0


# ---------------------------------------------------------------------------
# the threaded Server (tests/test_serve_api.py:191-231)
# ---------------------------------------------------------------------------

def _check_stream(events, result):
    *toks, terminal = events
    assert [e.index for e in toks] == list(range(len(toks)))
    assert all(isinstance(e, StreamEvent) and not e.finished
               and e.request_id == result.request_id for e in toks)
    assert terminal.finished and terminal.token is None
    assert terminal.index == len(toks)
    assert terminal.finish_reason == result.finish_reason
    assert [e.token for e in toks] == result.tokens


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
def test_server_streams_equal_batch_results(scheduler, jax_params,
                                            port_params):
    _, peng = _engines(jax_params, port_params, scheduler=scheduler)
    expected = peng.generate(RAGGED, 5)
    events = [[] for _ in RAGGED]
    threads = set()

    def collect(i):
        def cb(e):
            threads.add(threading.current_thread().name)
            events[i].append(e)
        return cb
    with Server(peng) as srv:
        handles = [srv.submit(Request(prompt=p, max_new_tokens=5,
                                      stream=collect(i)))
                   for i, p in enumerate(RAGGED)]
        results = [h.result(timeout=60) for h in handles]
    for ev, res, want in zip(events, results, expected):
        _check_stream(ev, res)
        assert res.tokens == want
    assert threads == {"serve-worker"}


def test_server_ingests_while_draining(jax_params, port_params):
    _, peng = _engines(jax_params, port_params)
    oracle = peng.generate([[1, 3, 3]], 3)[0]
    with Server(peng) as srv:
        first = srv.submit(Request(prompt=[5, 9, 2, 7], max_new_tokens=12))
        second = srv.submit(Request(prompt=[1, 3, 3], max_new_tokens=3))
        r1, r2 = first.result(timeout=60), second.result(timeout=60)
    assert len(r1.tokens) == 12 or r1.finish_reason == api.FINISH_STOP
    assert r2.tokens == oracle
    st = srv.stats()
    assert st["server"]["submitted"] == 2 and st["server"]["served"] == 2
    assert st["latency"]["count"] >= 2


def test_server_lifecycle_and_rejections(jax_params, port_params):
    _, peng = _engines(jax_params, port_params)
    srv = Server(peng).start()
    with pytest.raises(RuntimeError, match="already started"):
        srv.start()
    with pytest.raises(ValueError, match="row"):
        srv.submit(Request(prompt=[1, 2], max_new_tokens=2, row=0))
    srv.stop()
    with pytest.raises(RuntimeError, match="not running"):
        srv.submit(Request(prompt=[1, 2], max_new_tokens=2))
    assert peng._ingest_hook is None             # engine handed back clean
    assert len(peng.generate([[1, 2]], 2)[0]) == 2


def test_server_stop_drains_what_was_submitted(jax_params, port_params):
    _, peng = _engines(jax_params, port_params, scheduler="wave")
    expected = peng.generate(RAGGED, 4)
    srv = Server(peng).start()
    handles = [srv.submit(Request(prompt=p, max_new_tokens=4))
               for p in RAGGED]
    srv.stop(drain=True)
    assert [h.result(timeout=0).tokens for h in handles] == expected
    assert srv.stats()["server"]["running"] is False


def test_server_concurrent_submitters_stress(jax_params, port_params):
    """More submitting threads than cores, with a short switch interval:
    every request is served once, its stream equals its result, and the
    server's counters lose no update."""
    import os
    import sys
    _, peng = _engines(jax_params, port_params, max_batch=4, max_len=32)
    n_threads = min(len(os.sched_getaffinity(0)), 32) + 2
    per_thread = 3
    results, events = {}, {}
    lock = threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with Server(peng, poll_timeout_s=0.01) as srv:
            def client(t):
                for i in range(per_thread):
                    key = (t, i)
                    log = []
                    h = srv.submit(Request(prompt=[t + 1, i + 2, 3],
                                           max_new_tokens=2,
                                           stream=log.append))
                    res = h.result(timeout=60)
                    with lock:
                        results[key], events[key] = res, log
            workers = [threading.Thread(target=client, args=(t,))
                       for t in range(n_threads)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=120)
            assert not any(w.is_alive() for w in workers)
        st = srv.stats()["server"]      # after stop(): the drain counted
    finally:
        sys.setswitchinterval(old)
    assert len(results) == n_threads * per_thread
    assert st["submitted"] == n_threads * per_thread == st["served"]
    assert len({r.request_id for r in results.values()}) == len(results)
    for key, res in results.items():
        _check_stream(events[key], res)


# ---------------------------------------------------------------------------
# versioned stats schema
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cache", [True, False])
@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
def test_live_stats_validate_against_schema(scheduler, cache, jax_params,
                                            port_params):
    _, peng = _engines(jax_params, port_params, scheduler=scheduler,
                       prefix_cache=cache)
    assert stats_schema.validate_stats(peng.stats()) == []   # before a run
    peng.generate(RAGGED, 3)
    peng.generate(RAGGED, 3)
    st = peng.stats()
    assert st["schema_version"] == stats_schema.SCHEMA_VERSION
    assert stats_schema.validate_stats(st) == []
    assert set(st["prefix_cache"]) == set(stats_schema.PREFIX_CACHE_KEYS)
    assert st["prefix_cache"]["enabled"] is (cache
                                             and scheduler == "continuous")
    assert st["prefix_cache"]["hits_full"] == (
        3 if cache and scheduler == "continuous" else 0)


def test_schema_is_jax_schema_minus_not_ported_plus_port_keys():
    port = set(stats_schema.STATS_SCHEMA)
    jax_keys = set(jax_schema.STATS_SCHEMA)
    # the tuning provenance and the mesh are ported; the unroll is not
    assert set(stats_schema.NOT_PORTED_KEYS) == {
        "decode_unroll", "decode_unroll_source"}
    assert {"hardware_platform", "decode_tile_lookups",
            "prefill_flash_lookups", "registry_hit_stats",
            "page_size_source"} <= port
    assert set(stats_schema.NOT_PORTED_KEYS) <= jax_keys
    assert port == (jax_keys - set(stats_schema.NOT_PORTED_KEYS)) \
        | set(stats_schema.PORT_KEYS)
    for k in port & jax_keys:
        assert stats_schema.STATS_SCHEMA[k].when == \
            jax_schema.STATS_SCHEMA[k].when, k
    for name in ("PAGES_KEYS", "PREFIX_CACHE_KEYS", "PCTL_KEYS"):
        assert getattr(stats_schema, name) == getattr(jax_schema, name)
    # the port's latency adds the queue wait to the reference's entries
    assert stats_schema.LATENCY_KEYS == (jax_schema.LATENCY_KEYS
                                         + stats_schema.PORT_LATENCY_KEYS)
    groups = stats_schema.groups()
    assert sorted(k for ks in groups.values() for k in ks) == sorted(port)
    for sched in ("continuous", "wave"):
        assert set(stats_schema.keys_for(sched)) == \
            (set(jax_schema.keys_for(sched))
             - set(stats_schema.NOT_PORTED_KEYS)) | set(stats_schema.PORT_KEYS)


def test_validate_stats_flags_drift(jax_params, port_params):
    _, peng = _engines(jax_params, port_params)
    st = peng.stats()
    st["undocumented"] = 1
    del st["waves"]
    st["prefix_cache"] = dict(st["prefix_cache"], extra=0)
    problems = stats_schema.validate_stats(st)
    assert any("undocumented" in p for p in problems)
    assert any("waves" in p for p in problems)
    assert any("prefix_cache" in p for p in problems)
    assert stats_schema.validate_stats({"scheduler": "x"})


# ---------------------------------------------------------------------------
# launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags,expect", [
    (["--scheduler", "wave"], "scheduler=wave"),
    (["--temperature", "0.8"], "temperature=0.8"),
    (["--server"], "server: 2 served"),
    (["--no-prefix-cache"], "prefix cache: off"),
    (["--kv-int8"], "int8-quantized KV cache"),
    (["--page-size", "4", "--capacity-tokens", "64", "--decode-chunk", "2"],
     "page_size=4"),
])
def test_launcher_flags_run_on_cpu(flags, expect, capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
          "--prompts", "1,2,3;4,5", "--max-new", "3", "--stats"] + flags)
    out = capsys.readouterr().out
    assert out.count("prompt=") == 2 and expect in out, out
