"""Reduced llama3.2-1b: the port's forward, prefill and decode_step against
the JAX package on the same bridged weights, under both attention paths.

Tolerance: float32 atol=rtol=1e-4 (XLA and torch differ in the last ulp of
cos, sin and rsqrt, which two layers carry into the logits).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.catalog import ARCHITECTURES  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs.catalog import ARCHITECTURES as PORT_ARCHS  # noqa: E402
from repro_torch.models import build_model, params_from_numpy  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-4)
IMPLS = ["chunked", "flash"]
B, S, MAX_LEN = 3, 11, 16
KV_START = np.array([0, 4, 9], np.int32)      # ragged left pad per row


@pytest.fixture(scope="module")
def jax_params():
    return jax_build_model(ARCHITECTURES["llama3.2-1b"].reduced()).init(
        jax.random.PRNGKey(1))


def _pair(impl, jax_params):
    jm = jax_build_model(dataclasses.replace(
        ARCHITECTURES["llama3.2-1b"].reduced(), attention_impl=impl))
    tm = build_model(dataclasses.replace(
        PORT_ARCHS["llama3.2-1b"].reduced(), attention_impl=impl))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params),
                           device="cpu")
    return jm, tm, tp


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _close(torch_x, jax_x):
    np.testing.assert_allclose(torch_x.float().numpy(), np.asarray(jax_x),
                               **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_logits_match(impl, jax_params):
    jm, tm, tp = _pair(impl, jax_params)
    toks = _tokens(0, (B, S))
    jl, _ = jm.forward(jax_params, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, S, 256)
    _close(tl, jl)


def _prefill_both(impl, jax_params):
    jm, tm, tp = _pair(impl, jax_params)
    toks = _tokens(1, (B, S))
    jc = jm.init_cache(B, MAX_LEN)
    tc = tm.init_cache(B, MAX_LEN, device="cpu")
    jl, jc = jm.prefill(jax_params, {"tokens": jnp.asarray(toks),
                                     "kv_start": jnp.asarray(KV_START)}, jc)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "kv_start": torch.from_numpy(KV_START)}, tc)
    return jm, tm, tp, jl, jc, tl, tc


@pytest.mark.parametrize("impl", IMPLS)
def test_ragged_prefill_logits_and_cache_match(impl, jax_params):
    _, _, _, jl, jc, tl, tc = _prefill_both(impl, jax_params)
    _close(tl, jl)
    for t_leaf, j_leaf in zip(tc["self"], jc["self"]):
        assert tuple(t_leaf.shape) == j_leaf.shape
        _close(t_leaf, j_leaf)


@pytest.mark.parametrize("impl", IMPLS)
def test_decode_step_logits_and_cache_match(impl, jax_params):
    jm, tm, tp, _, jc, _, tc = _prefill_both(impl, jax_params)
    for step, tok in enumerate(_tokens(2, (3, B, 1))):
        off = S + step
        jl, jc = jm.decode_step(jax_params, jnp.asarray(tok), jc,
                                jnp.int32(off), jnp.asarray(KV_START))
        tl, tc = tm.decode_step(tp, torch.from_numpy(tok), tc, off,
                                torch.from_numpy(KV_START))
        _close(tl, jl)
    for t_leaf, j_leaf in zip(tc["self"], jc["self"]):
        _close(t_leaf, j_leaf)


def test_prefill_without_kv_start_matches_forward_last_position(jax_params):
    """Unpadded prefill is the forward's last position (port-internal)."""
    _, tm, tp = _pair("flash", jax_params)
    toks = torch.from_numpy(_tokens(3, (2, 9)))
    logits, _ = tm.prefill(tp, {"tokens": toks},
                           tm.init_cache(2, 12, device="cpu"))
    full, _ = tm.forward(tp, {"tokens": toks})
    torch.testing.assert_close(logits, full[:, -1], atol=1e-5, rtol=1e-5)


def test_bf16_forward_tracks_jax(jax_params):
    """bf16 weights bridged bit for bit; activations round in both
    frameworks at the same places, within bf16 tolerance."""
    cfg = dataclasses.replace(ARCHITECTURES["llama3.2-1b"].reduced(),
                              dtype="bfloat16")
    jp = jax_build_model(cfg).init(jax.random.PRNGKey(1))
    tm = build_model(dataclasses.replace(PORT_ARCHS["llama3.2-1b"].reduced(),
                                         dtype="bfloat16"))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    toks = _tokens(4, (2, 7))
    jl, _ = jax_build_model(cfg).forward(jp, {"tokens": jnp.asarray(toks)})
    tl, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=5e-2, rtol=5e-2)


def test_decode_step_gemm_shapes(jax_params):
    """Every projection goes through ``matmul``: 7 GEMMs per layer plus the
    unembed, at M = batch (the shapes K1 sees on the decode path)."""
    from repro_torch.core import capture_gemm_shapes
    _, tm, tp = _pair("chunked", jax_params)
    cache = tm.init_cache(B, MAX_LEN, device="cpu")
    with capture_gemm_shapes() as shapes:
        tm.decode_step(tp, torch.zeros(B, 1, dtype=torch.int32), cache, 0)
    d, hd, h, kv, ff = 64, 16, 4, 2, 128
    layer = [(B, d, h * hd), (B, d, kv * hd), (B, d, kv * hd), (B, h * hd, d),
             (B, d, ff), (B, d, ff), (B, ff, d)]
    assert shapes == layer * 2 + [(B, d, 256)]
