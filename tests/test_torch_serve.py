"""The port's continuous-batching Engine against the JAX package's
per-prompt oracle, token for token, on the same bridged weights; the
one-transfer-per-chunk contract; the paged gather/scatter semantics; and the
host scheduler's decisions against the JAX scheduler's on seeded workloads."""
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
from repro_torch.configs.catalog import ARCHITECTURES as PORT_ARCHS  # noqa: E402
from repro_torch.kernels import paged  # noqa: E402
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    Engine, Request, ServeConfig, generate_per_prompt)
from repro_torch.serve import kv_pages  # noqa: E402

RAGGED = [[5, 9, 2, 7], [1, 3, 3], [2, 4, 6, 8, 1, 5, 3]]     # test_serve_engine.py:26
LONG_SHORT = [[(i * 7 + 3) % 256 for i in range(37)],
              [(i * 5 + 1) % 256 for i in range(11)]]       # test_serve_engine.py:78-86
MAX_NEW = 9


@pytest.fixture(scope="module")
def jax_params():
    return jax_build_model(ARCHITECTURES["llama3.2-1b"].reduced()).init(
        jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def oracle(jax_params):
    """JAX generate_per_prompt tokens, computed once per (impl, prompt set)."""
    memo = {}

    def get(impl, name):
        if (impl, name) not in memo:
            model = jax_build_model(dataclasses.replace(
                ARCHITECTURES["llama3.2-1b"].reduced(), attention_impl=impl))
            prompts, max_len = {"ragged": (RAGGED, 64),
                                "long_short": (LONG_SHORT, 128)}[name]
            memo[(impl, name)] = jax_generate(model, jax_params, prompts,
                                              MAX_NEW, max_len=max_len)
        return memo[(impl, name)]
    return get


def _port(impl, jax_params, **serve_kw):
    model = build_model(dataclasses.replace(
        PORT_ARCHS["llama3.2-1b"].reduced(), attention_impl=impl))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params),
                               device="cpu")
    kw = dict(max_batch=3, max_len=64, device="cpu")
    kw.update(serve_kw)
    return model, params, Engine(model, params, ServeConfig(**kw))


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_ragged_engine_matches_jax_oracle(impl, jax_params, oracle):
    _, _, eng = _port(impl, jax_params)
    assert eng.generate(RAGGED, MAX_NEW) == oracle(impl, "ragged")


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_non_divisible_prompts_match_jax_oracle(impl, jax_params, oracle):
    _, _, eng = _port(impl, jax_params, max_len=128)
    assert eng.generate(LONG_SHORT, MAX_NEW) == oracle(impl, "long_short")


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_more_requests_than_slots_admit_at_chunk_boundaries(
        impl, jax_params, oracle):
    """Two slots, six requests: later requests join mid-drain as rows
    finish, with different budgets so admissions interleave with decode."""
    _, _, eng = _port(impl, jax_params, max_batch=2, decode_chunk=4)
    want = oracle(impl, "ragged")
    prompts = RAGGED + RAGGED[::-1]
    budgets = [MAX_NEW, 3, 6, 2, MAX_NEW, 5]
    handles = [eng.submit(Request(prompt=p, max_new_tokens=n))
               for p, n in zip(prompts, budgets)]
    results = eng.run()
    by_prompt = {tuple(p): w for p, w in zip(RAGGED, want)}
    for h, p, n, res in zip(handles, prompts, budgets, results):
        assert h.result(timeout=0) is res
        assert res.tokens == by_prompt[tuple(p)][:n]
        assert res.finish_reason == "length" and res.prompt_len == len(p)
    st = eng.stats()
    assert st["admission_prefills"] > 1 and st["admissions"] == 6
    # the prefix cache (on by default) keeps the prompts' pages pinned
    assert st["evictions"] == 6
    assert st["pages"]["used_pages"] == st["prefix_cache"]["pinned_pages"]
    eng.clear_prefix_cache()
    assert eng.stats()["pages"]["used_pages"] == 0


def test_one_device_transfer_per_chunk(jax_params):
    _, _, eng = _port("flash", jax_params, decode_chunk=2)
    eng.generate(RAGGED, 7)
    st = eng.stats()
    assert st["chunks"] == 4            # ceil(7 / 2) chunks for the batch
    assert st["device_transfers"] == st["chunks"]
    assert st["tokens_generated"] == 21
    assert set(st["kernel_launches"]) == {"gemm", "flash_attention"}


def test_port_oracle_matches_jax_oracle(jax_params, oracle):
    model, params, _ = _port("flash", jax_params)
    assert generate_per_prompt(model, params, RAGGED, MAX_NEW,
                               max_len=64) == oracle("flash", "ragged")


def test_preemption_restarts_exactly(jax_params, oracle):
    """A pool too small for every admitted row forces preemption; restarted
    rows still produce the oracle's tokens."""
    _, _, eng = _port("chunked", jax_params, max_batch=3, page_size=2,
                      capacity_tokens=24, decode_chunk=2)
    out = eng.generate(RAGGED, MAX_NEW)
    assert out == oracle("chunked", "ragged")
    assert eng.stats()["preemptions"] > 0


def test_eos_stops_a_row(jax_params, oracle):
    want = oracle("chunked", "ragged")
    eos = want[1][2]                    # third token of the second prompt
    _, _, eng = _port("chunked", jax_params, eos_token=eos)
    handles = [eng.submit(Request(prompt=p, max_new_tokens=MAX_NEW))
               for p in RAGGED]
    eng.run()
    res = handles[1].result(timeout=0)
    assert res.finish_reason == "stop" and res.tokens == want[1][:3]


def test_engine_rejects_what_is_not_ported(jax_params):
    """Every family is ported: the Engine takes a reduced mamba2 and puts
    it on the wave scheduler (no self-attention KV to page), as the
    reference does.  It still refuses requests it could never serve."""
    model, params, _ = _port("chunked", jax_params)
    ssm = build_model(PORT_ARCHS["mamba2-130m"].reduced())
    eng = Engine(ssm, ssm.init(0, device="cpu"), ServeConfig(device="cpu"))
    st = eng.stats()
    assert st["scheduler"] == "wave"
    assert st["scheduler_forced"] == "no self-attention KV cache"
    eng = Engine(model, params, ServeConfig(max_len=16, device="cpu"))
    for bad in (Request(prompt=[], max_new_tokens=2),
                Request(prompt=[1], max_new_tokens=0),
                Request(prompt=[1] * 200, max_new_tokens=2)):
        with pytest.raises(ValueError):
            eng.submit(bad)


def test_launcher_runs_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
          "--attn-impl", "flash", "--prompts", "1,2,3;4,5", "--max-new", "3",
          "--stats"])
    out = capsys.readouterr().out
    assert out.count("prompt=") == 2 and "host transfer(s)" in out
    assert "kernel launches" in out


# ---------------------------------------------------------------------------
# paged gather / scatter against the JAX ops
# ---------------------------------------------------------------------------

def test_paged_gather_scatter_match_jax():
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((2, 6, 4, 2, 3)).astype(np.float32)  # L,P,S,kv,hd
    jflat = jax_paged.flatten_pool(jnp.asarray(pool))
    tflat = paged.flatten_pool(torch.from_numpy(pool.copy()))
    np.testing.assert_array_equal(tflat.numpy(), np.asarray(jflat))
    n = tflat.shape[1]
    gidx = rng.integers(0, n, (3, 5)).astype(np.int32)
    gidx[0, 0], gidx[1, 1], gidx[2, 2] = n + 3, -1, -n - 2   # wrap / NaN
    got = paged.paged_gather(tflat, torch.from_numpy(gidx))
    want = np.asarray(jax_paged.paged_gather(jflat, jnp.asarray(gidx)))
    assert np.isnan(want).any()
    np.testing.assert_array_equal(got.numpy(), want)
    sidx = rng.permutation(n)[:6].reshape(3, 2).astype(np.int32)
    sidx[2, 1] = n + 5                           # out of range: JAX drops
    sidx[0, 1] -= n                              # negative: wraps
    cols = rng.standard_normal((2, 3, 2, 2, 3)).astype(np.float32)
    want = jax_paged.paged_scatter(jflat, jnp.asarray(sidx), jnp.asarray(cols))
    got = paged.paged_scatter(tflat, torch.from_numpy(sidx),
                              torch.from_numpy(cols))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# host scheduler: same decisions as the JAX scheduler
# ---------------------------------------------------------------------------

def _trace(mod, n_slots, page_size, capacity, chunk, requests):
    """Drive one scheduler module with a simulated decode; record every
    admission, page table, preemption and index array."""
    alloc = mod.PageAllocator(capacity, page_size)
    sched = mod.ContinuousScheduler(n_slots, alloc)
    queue = [(rid, p, m) for rid, (p, m) in enumerate(requests)]
    log = []
    for _ in range(10_000):
        if not (queue or sched.rows):
            break
        while queue and sched.can_admit(queue[0][1]):
            rid, p, m = queue.pop(0)
            row = sched.admit(rid, p, m)
            log.append(("admit", rid, row.slot, tuple(row.pages)))
        preempted = sched.ensure_chunk_pages(chunk)
        log.append(("preempt", tuple(r.rid for r in preempted)))
        queue = [(r.rid,) + requests[r.rid]
                 for r in sorted(preempted, key=lambda r: r.rid)] + queue
        if not sched.rows:
            continue
        width = max(r.length for r in sched.rows.values()) + chunk
        log.append(("gather", mod.gather_indices(
            sched.rows, n_slots, width, chunk, page_size).tolist()))
        log.append(("scatter", mod.scatter_indices(
            sched.rows, n_slots, chunk, page_size).tolist()))
        log.append(("tables", sorted((s, tuple(r.pages))
                                     for s, r in sched.rows.items())))
        for row in list(sched.live):
            emitted = min(chunk, row.budget_left)
            row.length += emitted
            row.budget_left -= emitted
            if row.budget_left == 0:
                sched.evict(row)
                log.append(("evict", row.rid))
    log.append(("totals", sched.admissions, sched.evictions,
                sched.preemptions, alloc.alloc_count, alloc.free_count,
                alloc.high_water_pages))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scheduler_decisions_match_jax(seed):
    rng = random.Random(seed)
    capacity = rng.choice([16, 24, 48])
    page_size = rng.choice([1, 2, 4, 8])
    requests = []
    for _ in range(rng.randint(4, 12)):
        p = rng.randint(1, capacity // 2)
        requests.append((p, rng.randint(1, capacity - p)))
    args = (rng.randint(1, 4), page_size, capacity, rng.choice([1, 2, 4]),
            requests)
    port_log = _trace(kv_pages, *args)
    assert port_log == _trace(jax_kv, *args)
    assert any(e[0] == "evict" for e in port_log)
