"""The port's prefix cache against the JAX package's: the same decisions
(matches, refcounts, pinned pages, evictions) at every step of seeded random
interleavings, the copy-on-write page copy, and engine-level parity — a warm
cache changes no token, cold and warm serving equal the JAX oracle on the
same bridged weights, and clearing the cache returns every page.
(Ports ``tests/test_prefix_cache.py:41-206``.)"""
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.catalog import ARCHITECTURES  # noqa: E402
from repro.kernels import paged as jax_paged  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serve import generate_per_prompt as jax_generate  # noqa: E402
from repro.serve import kv_pages as jax_kv  # noqa: E402
from repro.serve import prefix_cache as jax_pc  # noqa: E402
from repro_torch.configs.catalog import ARCHITECTURES as PORT_ARCHS  # noqa: E402
from repro_torch.kernels import paged  # noqa: E402
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig, api  # noqa: E402
from repro_torch.serve import kv_pages, prefix_cache  # noqa: E402


# ---------------------------------------------------------------------------
# host-side decisions: the same as the JAX PrefixCache, step by step
# ---------------------------------------------------------------------------

def _sim_row_pages(kv_mod, alloc, prompt_len, page):
    return alloc.alloc(kv_mod.pages_for(prompt_len, page))


def _interleave(kv_mod, pc_mod, seed):
    """Drive one package's allocator + cache with a seeded random schedule
    of insert / match / row-free / evict / reclaim / clear; log every
    observable decision."""
    rng = random.Random(seed)
    page = rng.choice([2, 4])
    alloc = kv_mod.PageAllocator(capacity_tokens=page * 32, page_size=page)
    cache = pc_mod.PrefixCache(alloc)
    live_rows, log, seen = [], [], []
    vocab = rng.choice([3, 9])          # small vocab: many shared chunks
    for _ in range(rng.randint(10, 40)):
        op = rng.random()
        if op < 0.4 and alloc.free_pages > 8:
            if seen and rng.random() < 0.5:   # a repeat, maybe extended
                prompt = list(rng.choice(seen))[:3 * page]
                prompt += [rng.randint(1, vocab)
                           for _ in range(rng.randint(0, 2))]
            else:
                prompt = [rng.randint(1, vocab)
                          for _ in range(rng.randint(1, 3 * page))]
            seen.append(prompt)
            plen = len(prompt)
            m = cache.match(prompt)
            log.append(("match", None if m is None else
                        (m.pages, m.tokens, m.full)))
            cache.record_admit(m, plen)
            pages = _sim_row_pages(kv_mod, alloc, plen, page)
            log.append(("insert", cache.insert(prompt, pages, None, None)))
            live_rows.append(pages)
        elif op < 0.55:
            prompt = [rng.randint(1, vocab) for _ in range(rng.randint(
                1, 3 * page))]
            m = cache.match(prompt)
            log.append(("probe", None if m is None else
                        (m.pages, m.tokens, m.full)))
        elif op < 0.7 and live_rows:
            alloc.free(live_rows.pop(rng.randrange(len(live_rows))))
        elif op < 0.8:
            log.append(("evict", cache.evict_one()))
        elif op < 0.9:
            log.append(("reclaim", cache.reclaim(rng.randint(1, 6))))
        else:
            cache.clear()
        assert cache.pinned_pages <= alloc.used_pages
        log.append(("state", cache.pinned_pages, alloc.used_pages,
                    [alloc.refcount(p) for p in range(alloc.num_pages)],
                    cache.stats()))
    for pages in live_rows:
        alloc.free(pages)
    cache.clear()
    log.append(("drained", alloc.used_pages, alloc.alloc_count,
                alloc.free_count, cache.stats()["pinned_pages"]))
    return log


@pytest.mark.parametrize("seed", range(8))
def test_decisions_match_jax_prefix_cache(seed):
    port = _interleave(kv_pages, prefix_cache, seed)
    assert port == _interleave(jax_kv, jax_pc, seed)
    drained = port[-1]
    assert drained[1] == 0 and drained[2] == drained[3] and drained[4] == 0


def test_interleavings_cover_full_and_partial_hits():
    matches = [e[1] for seed in range(8)
               for e in _interleave(kv_pages, prefix_cache, seed)
               if e[0] == "match" and e[1] is not None]
    assert any(m[2] for m in matches)             # full hits
    assert any(not m[2] for m in matches)         # partial hits


def test_insert_dedup_and_shared_refcounts():
    page = 4
    alloc = kv_pages.PageAllocator(capacity_tokens=64, page_size=page)
    cache = prefix_cache.PrefixCache(alloc)
    shared = [1, 2, 3, 4]
    pages_a = _sim_row_pages(kv_pages, alloc, 6, page)
    cache.insert(shared + [5, 6], pages_a, None, None)
    assert cache.stats()["nodes"] == 1 and cache.stats()["entries"] == 1
    assert alloc.refcount(pages_a[0]) == 2
    pages_b = _sim_row_pages(kv_pages, alloc, 6, page)
    cache.insert(shared + [7, 8], pages_b, None, None)
    st = cache.stats()
    assert st["nodes"] == 1 and st["entries"] == 2
    assert alloc.refcount(pages_b[0]) == 1
    m = cache.match(shared + [9])
    assert m is not None and not m.full
    assert m.pages == [pages_a[0]] and m.tokens == page


def test_lru_eviction_prefers_oldest_and_frees_pages():
    page = 2
    alloc = kv_pages.PageAllocator(capacity_tokens=32, page_size=page)
    cache = prefix_cache.PrefixCache(alloc)
    rows = []
    for i in range(3):
        pages = _sim_row_pages(kv_pages, alloc, 3, page)
        rows.append(pages)
        cache.insert([10 + i, 20 + i, 30 + i], pages, None, None)
    cache.match([10, 20, 30])                      # touch entry 0: now MRU
    for pages in rows:
        alloc.free(pages)
    used_before = alloc.used_pages
    assert cache.evict_one()                       # evicts entry 1 (oldest)
    m = cache.match([11, 21, 31])
    assert m is None or not m.full
    assert cache.match([10, 20, 30]).full
    assert alloc.used_pages < used_before
    cache.clear()
    assert alloc.used_pages == 0


def test_reclaim_reports_progress_only_on_eviction():
    page = 2
    alloc = kv_pages.PageAllocator(capacity_tokens=8, page_size=page)
    cache = prefix_cache.PrefixCache(alloc)
    assert cache.reclaim(1) is False
    pages = _sim_row_pages(kv_pages, alloc, 4, page)
    cache.insert([1, 2, 3, 4], pages, None, None)
    alloc.free(pages)
    grab = alloc.alloc(2)
    assert not alloc.can_alloc(2)
    assert cache.reclaim(2) is True
    assert alloc.can_alloc(2)
    alloc.free(grab)


def test_disabled_stats_have_the_same_keys():
    on = prefix_cache.PrefixCache(kv_pages.PageAllocator(8, 2)).stats()
    off = prefix_cache.PrefixCache.disabled_stats()
    assert set(on) == set(off) == set(jax_pc.PrefixCache.disabled_stats())
    assert off["enabled"] is False and on["enabled"] is True


def test_paged_copy_matches_jax():
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((2, 6 * 4, 2, 3)).astype(np.float32)
    tpool = torch.from_numpy(pool.copy())
    for src, dst in ((3, 1), (0, 5), (5, 5), (9, 0)):   # 9: clamps
        want = jax_paged.paged_copy(jnp.asarray(pool), jnp.int32(src),
                                    jnp.int32(dst), 4)
        got = paged.paged_copy(tpool, src, dst, 4)
        assert got is tpool                      # in place
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        pool = np.asarray(want).copy()


# ---------------------------------------------------------------------------
# engine-level parity: a warm cache never changes a token
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg = ARCHITECTURES["llama3.2-1b"].reduced()
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(1))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    model = build_model(PORT_ARCHS["llama3.2-1b"].reduced())

    def oracle(prompts, n, impl="chunked"):
        jm = jax_build_model(dataclasses.replace(jcfg, attention_impl=impl))
        return jax_generate(jm, jparams, prompts, n, max_len=64)

    def engine(impl="chunked", **kw):
        m = build_model(dataclasses.replace(model.cfg, attention_impl=impl))
        cfg = dict(max_batch=3, max_len=64, page_size=4, device="cpu")
        cfg.update(kw)
        return Engine(m, params, ServeConfig(**cfg))
    return oracle, engine


def _gen(eng, prompts, n=5):
    handles = [eng.submit(Request(prompt=p, max_new_tokens=n))
               for p in prompts]
    eng.run()
    return [h.result(timeout=0) for h in handles]


def _toks(results):
    return [r.tokens for r in results]


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_warm_equals_cold_equals_jax_oracle(impl, setup):
    """Randomized page-spanning shared prefixes served twice on the warm
    engine (misses and partial hits, then full hits): every pass equals the
    cache-disabled engine and the JAX per-prompt oracle."""
    oracle, engine = setup
    warm = engine(impl)
    cold = engine(impl, prefix_cache=False)
    rng = random.Random(1234)
    for trial in range(3):
        plen = rng.randint(5, 11)
        prefix = [rng.randrange(1, 256) for _ in range(plen)]
        batch = [prefix + [rng.randrange(1, 256)
                           for _ in range(rng.randint(0, 3))]
                 for _ in range(3)]
        expected = oracle(batch, 5, impl)
        assert _toks(_gen(cold, batch)) == expected, trial
        first = _gen(warm, batch)
        assert _toks(first) == expected, trial
        again = _gen(warm, batch)
        assert _toks(again) == expected, trial
        assert all(r.prefix_hit == api.PREFIX_HIT_FULL
                   and r.cached_prefix_tokens == len(p)
                   for r, p in zip(again, batch))
        varied = [prefix + [rng.randrange(1, 256), 0]]
        part = _gen(warm, varied)
        assert _toks(part) == oracle(varied, 5, impl), trial
        assert part[0].prefix_hit == api.PREFIX_HIT_PARTIAL
    st = warm.stats()["prefix_cache"]
    assert st["hits_full"] >= 9 and st["hits_partial"] > 0
    assert st["prefill_tokens_saved"] > 0


def test_cow_divergence_after_full_hit_is_exact(setup):
    """A full hit copies the tail page; a later prompt diverging inside that
    page must not see the first request's decoded tokens."""
    oracle, engine = setup
    warm = engine()
    base = [3, 1, 4, 1, 5, 9]                      # page 4: tail = (5, 9)
    div = base[:5] + [7]                           # diverges inside page 2
    expected = oracle([base, div], 5)
    assert _toks(_gen(warm, [base])) == expected[:1]        # insert
    hit = _gen(warm, [base])
    assert _toks(hit) == expected[:1] and hit[0].prefix_hit == "full"
    part = _gen(warm, [div])
    assert _toks(part) == expected[1:] and part[0].prefix_hit == "partial"
    assert part[0].cached_prefix_tokens == 4
    assert _toks(_gen(warm, [base])) == expected[:1]


def test_partial_hit_prefill_writes_shared_columns_to_trash(setup):
    """A partial hit re-runs prefill but leaves the shared pages alone: the
    cached page's bits are unchanged and its refcount covers row + pin."""
    _, engine = setup
    eng = engine()
    base = [7, 7, 7, 7, 1, 2]
    _gen(eng, [base])
    page0 = eng._prefix.match(base).pages[0]
    before = [p[:, page0 * 4:(page0 + 1) * 4].clone() for p in eng._pools]
    res = _gen(eng, [[7, 7, 7, 7, 3]])
    assert res[0].prefix_hit == "partial"
    for pool, old in zip(eng._pools, before):
        assert torch.equal(pool[:, page0 * 4:(page0 + 1) * 4], old)
    assert eng.stats()["prefix_cache"]["pages_write_skipped"] == 1


def test_engine_refcounts_drain_clean(setup):
    """After hits and misses, and under pool pressure (LRU eviction before
    preemption), clearing the cache returns every page."""
    oracle, engine = setup
    eng = engine(max_batch=2, page_size=2, capacity_tokens=24,
                 decode_chunk=2)
    prompts = [[5, 9, 2, 7, 1], [5, 9, 2, 7, 3], [1, 3, 3], [5, 9, 2, 7, 1],
               [2, 4, 6, 8, 1, 5, 3], [1, 3, 3]]
    assert _toks(_gen(eng, prompts, 6)) == oracle(prompts, 6)
    st = eng.stats()
    assert st["prefix_cache"]["hits_full"] >= 1
    assert st["prefix_cache"]["evictions"] > 0
    eng.clear_prefix_cache()
    st = eng.stats()
    assert st["pages"]["used_pages"] == 0
    assert st["pages"]["alloc_count"] == st["pages"]["free_count"]
    assert st["prefix_cache"]["pinned_pages"] == 0


def test_logits_snapshot_is_a_copy(setup):
    """Each entry keeps its own (vocab,) logits row, not a view of the
    admission batch's (max_batch, vocab) logits."""
    _, engine = setup
    eng = engine()
    _gen(eng, [[1, 2, 3], [4, 5, 6, 7, 8]])
    for p in ([1, 2, 3], [4, 5, 6, 7, 8]):
        logits0 = eng._prefix.match(p).entry.logits0
        assert logits0.shape == (256,)
        assert logits0.untyped_storage().nbytes() == 256 * 4


def test_fixed_leaf_snapshot_round_trip(setup):
    """The snapshot a full hit restores covers every non-paged cache leaf
    at its batch dim (-4, or -3 for conv state); the dense family has none,
    so the engine is given a fixed tree here."""
    _, engine = setup
    eng = engine()
    assert eng._slice_fixed_row(0) == []
    eng._fixed = {"ssm": torch.randn(2, 3, 4, 5, 6),
                  "conv": (torch.randn(2, 3, 4, 5),)}
    before = {"ssm": eng._fixed["ssm"].clone(),
              "conv": eng._fixed["conv"][0].clone()}
    snap = eng._slice_fixed_row(1)
    eng._fixed["ssm"].zero_()
    eng._fixed["conv"][0].zero_()
    eng._restore_fixed_row(snap, 1)
    assert torch.equal(eng._fixed["ssm"][:, 1], before["ssm"][:, 1])
    assert torch.equal(eng._fixed["conv"][0][:, 1], before["conv"][:, 1])
    assert not eng._fixed["ssm"][:, 0].any()
    assert not eng._fixed["conv"][0][:, 2].any()
