"""Reduced zamba2-2.7b (2 units of 6 Mamba2 layers and the one shared
attention block): the port's hybrid model and serve engine (continuous
over the paged KV pool with the SSM and conv states as resident fixed
leaves, wave, the prefix cache) against the JAX package on the same
numpy-seeded inputs and bridged weights.

Tolerances: logits and caches at atol=rtol=1e-4 (as
tests/test_torch_model.py); engine tokens exactly.  The JAX side's flash
attention runs as the JAX package's own CPU tests run it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.catalog import ARCHITECTURES  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs.catalog import ARCHITECTURES as PORT_ARCHS  # noqa: E402
from repro_torch.models import build_model, hybrid, params_from_numpy  # noqa: E402
from repro_torch.models.params import map_tree  # noqa: E402
from repro_torch.serve import (Engine, Request, ServeConfig,  # noqa: E402
                               generate_per_prompt)

ARCH = "zamba2-2.7b"
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, MAX_LEN = 3, 11, 16
KV_START = np.array([0, 4, 9], np.int32)      # ragged left pad per row
RAGGED = [[5, 9, 2, 7], [1, 3, 3], [2, 4, 6, 8, 1, 5, 3]]     # test_serve_engine.py:26
PROMPTS = RAGGED + [[(i * 7 + 3) % 256 for i in range(37)]]
MAX_NEW = 6


def _cfgs(**kw):
    return (dataclasses.replace(ARCHITECTURES[ARCH].reduced(), **kw),
            dataclasses.replace(PORT_ARCHS[ARCH].reduced(), **kw))


def _bridge(jparams):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")


@pytest.fixture(scope="module")
def jax_params():
    return jax_build_model(ARCHITECTURES[ARCH].reduced()).init(
        jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return _bridge(jax_params)


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(torch_x, jax_x, tol=TOL):
    np.testing.assert_allclose(torch_x.float().numpy(),
                               np.asarray(jax_x, np.float32), **tol)


def test_template_and_cache_layout():
    """One shared block, ``units`` a stack of stacks (U, P, ...); the cache
    holds the shared block's K/V per unit (U, B, T, KV, hd) and the states
    (U, P, B, ...), at the reference's shapes."""
    jcfg, pcfg = _cfgs()
    t = build_model(pcfg).template
    assert set(t) == {"embedding", "shared_attn", "units", "ln_f", "lm_head"}
    assert t["shared_attn"]["attn"]["wq"].shape == (64, 64)
    assert t["units"]["ssm"]["in_proj"].shape == (2, 6, 64, 296)
    assert t["units"]["ln"]["scale"].shape == (2, 6, 64)
    full = build_model(PORT_ARCHS[ARCH])
    assert full.template["shared_attn"]["attn"]["wq"].shape == (2560, 2560)
    assert full.template["units"]["ssm"]["in_proj"].shape == (9, 6, 2560, 10448)
    assert not full.template["lm_head"].kmajor          # 32000 % 8 == 0
    jc = jax_build_model(jcfg).init_cache(B, MAX_LEN)
    pc = build_model(pcfg).init_cache(B, MAX_LEN, device="cpu")
    assert set(pc) == set(jc) == {"self", "ssm"}
    for t_leaf, j_leaf in zip(pc["self"], jc["self"]):
        assert tuple(t_leaf.shape) == j_leaf.shape == (2, B, MAX_LEN, 2, 16)
    for k in ("conv", "ssm"):
        assert tuple(pc["ssm"][k].shape) == jc["ssm"][k].shape
        assert str(pc["ssm"][k].dtype).split(".")[1] == jc["ssm"][k].dtype.name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_the_hybrid_tree(dtype):
    """Every leaf (the shared block, the nested ``units`` stack, the head)
    crosses bit for bit."""
    jcfg, _ = _cfgs(dtype=dtype)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(2))
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tflat = {}
    map_tree(lambda p, x: tflat.__setitem__(p, x), _bridge(jparams))
    assert set(jflat) == set(tflat)
    assert {"shared_attn/attn/wq", "shared_attn/mlp/w_gate",
            "units/ssm/conv_w", "units/ln/scale", "lm_head"} <= set(tflat)
    for path, ref in jflat.items():
        got = tflat[path]
        assert got.dtype == getattr(torch, dtype), path
        assert tuple(got.shape) == ref.shape, path
        back = got.view(torch.int16) if dtype == "bfloat16" else got
        np.testing.assert_array_equal(back.numpy(),
                                      ref.view(np.int16) if dtype == "bfloat16"
                                      else ref, err_msg=path)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_forward_logits_match(impl, jax_params, port_params):
    jcfg, pcfg = _cfgs(attention_impl=impl)
    toks = _tokens(0, (B, S))
    jl, _ = jax_build_model(jcfg).forward(jax_params,
                                          {"tokens": jnp.asarray(toks)})
    tl, aux = build_model(pcfg).forward(port_params,
                                        {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, S, 256)
    _close(tl, jl)
    assert aux == 0.0


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_prefill_and_decode_match_with_caches(impl, jax_params, port_params):
    """Ragged prefill then three decode steps (positions clamped at each
    row's first real token): logits, the shared block's K/V per unit and
    both state leaves."""
    jcfg, pcfg = _cfgs(attention_impl=impl)
    jm, tm = jax_build_model(jcfg), build_model(pcfg)
    toks = _tokens(1, (B, S))
    jl, jc = jm.prefill(jax_params, {"tokens": jnp.asarray(toks),
                                     "kv_start": jnp.asarray(KV_START)},
                        jm.init_cache(B, MAX_LEN))
    tl, tc = tm.prefill(port_params, {"tokens": torch.from_numpy(toks),
                                      "kv_start": torch.from_numpy(KV_START)},
                        tm.init_cache(B, MAX_LEN, device="cpu"))
    _close(tl, jl)
    for step, tok in enumerate(_tokens(2, (3, B, 1))):
        off = S + step
        jl, jc = jm.decode_step(jax_params, jnp.asarray(tok), jc,
                                jnp.int32(off), jnp.asarray(KV_START))
        tl, tc = tm.decode_step(port_params, torch.from_numpy(tok), tc, off,
                                torch.from_numpy(KV_START))
        _close(tl, jl)
    for t_leaf, j_leaf in zip(tc["self"], jc["self"]):
        _close(t_leaf, j_leaf)
    for k in ("conv", "ssm"):
        _close(tc["ssm"][k], jc["ssm"][k])


def test_decode_step_gemm_shapes(port_params):
    """Per unit the shared block's q / k / v / o and SwiGLU products, then
    its six Mamba2 layers' in_proj and out_proj; then the unembed."""
    from repro_torch.core import capture_gemm_shapes
    _, pcfg = _cfgs()
    tm = build_model(pcfg)
    with capture_gemm_shapes() as shapes:
        tm.decode_step(port_params, torch.zeros(B, 1, dtype=torch.int32),
                       tm.init_cache(B, MAX_LEN, device="cpu"), 0)
    attn = [(B, 64, 64), (B, 64, 32), (B, 64, 32), (B, 64, 64),
            (B, 64, 128), (B, 64, 128), (B, 128, 64)]
    ssm = [(B, 64, 296), (B, 128, 64)] * 6
    assert shapes == (attn + ssm) * 2 + [(B, 64, 256)]


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_engine_matches_jax_engine(impl, scheduler, jax_params, port_params):
    """Four requests over three slots (a later admission, or a second
    wave): tokens equal the JAX engine's, one host transfer per chunk or
    wave; on the continuous scheduler the states are resident fixed leaves
    (U, P, max_batch, ...)."""
    jcfg, pcfg = _cfgs(attention_impl=impl)
    kw = dict(max_batch=3, max_len=64, scheduler=scheduler)
    jeng = JaxEngine(jax_build_model(jcfg), jax_params, JaxServeConfig(**kw))
    peng = Engine(build_model(pcfg), port_params,
                  ServeConfig(device="cpu", **kw))
    assert peng.generate(PROMPTS, MAX_NEW) == jeng.generate(PROMPTS, MAX_NEW)
    st = peng.stats()
    assert st["scheduler"] == scheduler and st["scheduler_forced"] is None
    assert st["device_transfers"] == st["chunks"] + st["waves"]
    if scheduler == "continuous":
        assert tuple(peng._fixed["ssm"]["ssm"].shape) == (2, 6, 3, 8, 16, 16)
        assert tuple(peng._fixed["ssm"]["conv"].shape) == (2, 6, 3, 3, 160)


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
def test_ragged_batch_matches_each_prompt_alone(scheduler, port_params):
    """As tests/test_serve_engine.py:47-54."""
    _, pcfg = _cfgs()
    eng = Engine(build_model(pcfg), port_params,
                 ServeConfig(max_batch=3, max_len=64, scheduler=scheduler,
                             device="cpu"))
    batched = eng.generate(RAGGED, 4)
    assert batched == [eng.generate([p], 4)[0] for p in RAGGED]


def test_port_oracle_matches_jax_oracle(jax_params, port_params):
    from repro.serve import generate_per_prompt as jax_generate
    jcfg, pcfg = _cfgs(attention_impl="flash")
    want = jax_generate(jax_build_model(jcfg), jax_params, PROMPTS, MAX_NEW,
                        max_len=64)
    got = generate_per_prompt(build_model(pcfg), port_params, PROMPTS,
                              MAX_NEW, max_len=64)
    assert got == want


def _functional_decode(monkeypatch):
    """Make the hybrid's decode step return new state tensors, as the
    reference's does, instead of updating them in place."""
    step = hybrid.decode_step

    def functional(cfg, params, tokens, cache, offset, kv_start=None):
        cache = dict(cache, ssm={k: v.clone() for k, v in cache["ssm"].items()})
        return step(cfg, params, tokens, cache, offset, kv_start)
    monkeypatch.setattr(hybrid, "decode_step", functional)


@pytest.mark.parametrize("in_place", [True, False])
def test_states_carry_across_decode_chunks(in_place, monkeypatch,
                                           port_params):
    """Prompts decoded over several chunks of 2 equal the oracle: each
    chunk starts from the states the last one left.  With a decode step
    that returns new state tensors (``in_place=False``) this needs the
    chunk to keep the fixed tree its last step returned; before it did, a
    chunk restarted from the post-prefill states."""
    _, pcfg = _cfgs()
    model = build_model(pcfg)
    want = generate_per_prompt(model, port_params, PROMPTS, 9, max_len=64)
    if not in_place:
        _functional_decode(monkeypatch)
    eng = Engine(model, port_params, ServeConfig(
        max_batch=3, max_len=64, decode_chunk=2, device="cpu"))
    assert eng.generate(PROMPTS, 9) == want
    assert eng.stats()["chunks"] >= 5


def test_prefix_cache_full_hit_restores_the_states(port_params):
    """Cold prompts then exact repeats and a shared prefix: the repeats are
    full hits that skip prefill and restore each row's SSM and conv state
    from the snapshot, and every token equals the cold run's and the
    oracle's; the shared-prefix prompt is a partial hit, which re-runs the
    whole prefill."""
    _, pcfg = _cfgs()
    model = build_model(pcfg)
    base = [(i * 11 + 5) % 256 for i in range(35)]
    cold = [base, PROMPTS[3], RAGGED[2]]
    warm = [list(base), PROMPTS[3], base[:32] + [1, 2, 3, 4]]
    eng = Engine(model, port_params, ServeConfig(
        max_batch=3, max_len=64, page_size=8, device="cpu"))
    handles = [eng.submit(Request(prompt=p, max_new_tokens=MAX_NEW))
               for p in cold]
    eng.run()
    cold_out = [h.result(timeout=0) for h in handles]
    # other rows (shorter than a page: nothing to hit or cache) decode over
    # the slots in between, moving their states
    eng.generate(RAGGED[:2], MAX_NEW)
    handles = [eng.submit(Request(prompt=p, max_new_tokens=MAX_NEW))
               for p in warm]
    eng.run()
    warm_out = [h.result(timeout=0) for h in handles]
    assert [r.prefix_hit for r in warm_out] == ["full", "full", "partial"]
    assert [r.tokens for r in warm_out[:2]] == [r.tokens for r in cold_out[:2]]
    want = generate_per_prompt(model, port_params, warm, MAX_NEW, max_len=64)
    assert [r.tokens for r in warm_out] == want
    pc = eng.stats()["prefix_cache"]
    assert pc["hits_full"] == 2 and pc["hits_partial"] == 1


def test_launcher_serves_hybrid_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--reduced", "--device", "cpu", "--attn-impl",
          "flash", "--prompts", "1,2,3;4,5", "--max-new", "3", "--stats"])
    out = capsys.readouterr().out
    assert out.count("prompt=") == 2 and "scheduler=continuous" in out
    assert "host transfer(s)" in out and "prefix cache: hits" in out
