"""Reduced whisper-large-v3: the port's audio path (a non-causal encoder over
the frontend stub's frame embeddings, a decoder with learned positions,
self-attention over the cache, cross-attention over each layer's encoder
K/V, the GELU MLP) and its serve engine against the JAX package, on the
same numpy-seeded inputs and bridged weights.

Tolerances: logits and caches at atol=rtol=1e-4 (as tests/test_torch_vlm.py);
a layer fed the same input (the GELU MLP, the cross K/V) at 1e-5, the
summation order of one f32 GEMM; engine tokens exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.catalog import ARCHITECTURES  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import transformer as jax_transformer  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs.catalog import ARCHITECTURES as PORT_ARCHS  # noqa: E402
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import map_tree  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

ARCH = "whisper-large-v3"
TOL = dict(atol=1e-4, rtol=1e-4)
LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
B, S, MAX_LEN, ENC, D = 3, 11, 16, 16, 64
KV_START = np.array([0, 4, 9], np.int32)      # ragged left pad per row
RAGGED = [[5, 9, 2, 7], [1, 3, 3], [2, 4, 6, 8, 1, 5, 3]]     # test_serve_engine.py:26
PROMPTS = RAGGED + [[(i * 7 + 3) % 256 for i in range(37)]]
MAX_NEW = 6


def _cfgs(**kw):
    return (dataclasses.replace(ARCHITECTURES[ARCH].reduced(), **kw),
            dataclasses.replace(PORT_ARCHS[ARCH].reduced(), **kw))


def _bridge(jparams, cfg):
    """The JAX params in the port's layout for ``cfg`` (its template's
    K-major leaves laid out so)."""
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu", template=build_model(cfg).template)


@pytest.fixture(scope="module")
def jax_params():
    return jax_build_model(ARCHITECTURES[ARCH].reduced()).init(
        jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return _bridge(jax_params, _cfgs()[1])


def _frames(seed, b, n=ENC):
    return np.random.default_rng(seed).standard_normal(
        (b, n, D)).astype(np.float32)


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(torch_x, jax_x, tol=TOL):
    np.testing.assert_allclose(torch_x.float().numpy(),
                               np.asarray(jax_x, np.float32), **tol)


def test_template_and_extra_inputs():
    _, pcfg = _cfgs()
    model = build_model(pcfg)
    t = model.template
    assert "blocks" not in t and "units" not in t
    assert t["enc_blocks"]["attn"]["bq"].shape == (2, 64)
    assert t["enc_blocks"]["mlp"]["b_up"].shape == (2, 128)
    assert t["dec_blocks"]["cross"]["wk"].shape == (2, D, 32)    # 2 KV heads
    assert set(t["dec_blocks"]) == {"ln1", "attn", "ln_x", "cross", "ln2", "mlp"}
    assert t["pos_emb"].shape == (128, D)
    assert not t["lm_head"].kmajor                 # vocab 256: row-major
    spec = model.extra_inputs(5)["encoder_embeds"]
    assert spec.shape == (5, ENC, D) and spec.dtype == torch.float32
    full = build_model(PORT_ARCHS[ARCH]).template
    assert full["lm_head"].shape == (1280, 51866) and full["lm_head"].kmajor


def test_mlp_gelu_matches(port_params, jax_params):
    """K1 with a bias and the tanh-GELU epilogue, then K1 with a bias."""
    bp = T._layer(port_params["dec_blocks"], 1)["mlp"]
    jbp = jax.tree_util.tree_map(lambda x: x[1], jax_params["dec_blocks"])["mlp"]
    x = np.random.default_rng(0).standard_normal((B, S, D)).astype(np.float32)
    got = L.mlp_gelu(bp, torch.from_numpy(x))
    want = jax_layers.mlp_gelu(jbp, jnp.asarray(x))
    assert tuple(got.shape) == (B, S, D)
    _close(got, want, LAYER_TOL)


@pytest.mark.parametrize("enc_len", [ENC, 1500])
def test_run_encoder_matches(enc_len, jax_params, port_params):
    """Non-causal self-attention on the chunked path (flash requested; the
    reason is "non-causal").  At 1500 frames, whisper's own length, the
    query chunk is the reference's largest divisor of 1500 under 1024."""
    jcfg, pcfg = _cfgs(attention_impl="flash", encoder_len=enc_len)
    x = _frames(2, 2, enc_len)
    got = T._run_encoder(pcfg, port_params, torch.from_numpy(x))
    want = jax_transformer._run_encoder(jcfg, jax_params, jnp.asarray(x))
    assert tuple(got.shape) == (2, enc_len, D)
    _close(got, want)


def test_sdpa_chunk_search_matches_reference():
    """Queries longer than the chunk split at the largest divisor <= chunk
    (17 -> 1: chunks of one query; 15 -> 5)."""
    rng = np.random.default_rng(3)
    for sq, chunk in ((17, 4), (15, 6)):
        q = rng.standard_normal((2, sq, 2, 2, 16)).astype(np.float32)
        k = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
        v = rng.standard_normal((2, 9, 2, 16)).astype(np.float32)
        got = L._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), causal=False,
                              q_offset=0, kv_len=None, chunk=chunk)
        want = jax_layers._sdpa_chunked(*map(jnp.asarray, (q, k, v)),
                                        causal=False, q_offset=0, kv_len=None,
                                        chunk=chunk)
        _close(got, want, LAYER_TOL)


def test_whisper_cross_cache_matches(jax_params, port_params):
    """Every decoder layer's cross K, V: (L, B, enc_len, KV, hd); from the
    same encoder output, within one GEMM's summation order."""
    jcfg, pcfg = _cfgs()
    enc = _frames(4, B)
    got = T._whisper_cross_cache(pcfg, port_params, torch.from_numpy(enc))
    want = jax_transformer._whisper_cross_cache(jcfg, jax_params,
                                                jnp.asarray(enc))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (2, B, ENC, 2, 16)
        _close(g, w, LAYER_TOL)


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_forward_logits_match(impl, jax_params, port_params):
    jcfg, pcfg = _cfgs(attention_impl=impl)
    toks, frames = _tokens(0, (B, S)), _frames(0, B)
    jl, jaux = jax_build_model(jcfg).forward(
        jax_params, {"tokens": jnp.asarray(toks),
                     "encoder_embeds": jnp.asarray(frames)})
    tl, taux = build_model(pcfg).forward(
        port_params, {"tokens": torch.from_numpy(toks),
                      "encoder_embeds": torch.from_numpy(frames)})
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, S, 256)
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_prefill_and_decode_match_with_caches(impl, jax_params, port_params):
    """Ragged prefill then three decode steps: logits, the (L, B, S, KV,
    hd) self cache and the (L, B, enc_len, KV, hd) cross cache; each row's
    learned positions restart at its first real token."""
    jcfg, pcfg = _cfgs(attention_impl=impl)
    jm, tm = jax_build_model(jcfg), build_model(pcfg)
    toks, frames = _tokens(1, (B, S)), _frames(1, B)
    jl, jc = jm.prefill(jax_params, {
        "tokens": jnp.asarray(toks), "kv_start": jnp.asarray(KV_START),
        "encoder_embeds": jnp.asarray(frames)}, jm.init_cache(B, MAX_LEN))
    tl, tc = tm.prefill(port_params, {
        "tokens": torch.from_numpy(toks),
        "kv_start": torch.from_numpy(KV_START),
        "encoder_embeds": torch.from_numpy(frames)},
        tm.init_cache(B, MAX_LEN, device="cpu"))
    _close(tl, jl)
    assert set(tc) == set(jc) == {"self", "cross"}
    for t_leaf, j_leaf in zip(tc["self"], jc["self"]):
        assert tuple(t_leaf.shape) == j_leaf.shape == (2, B, MAX_LEN, 2, 16)
        _close(t_leaf, j_leaf)
    for t_leaf, j_leaf in zip(tc["cross"], jc["cross"]):
        assert tuple(t_leaf.shape) == j_leaf.shape == (2, B, ENC, 2, 16)
        _close(t_leaf, j_leaf)
    for step, tok in enumerate(_tokens(2, (3, B, 1))):
        off = S + step
        jl, jc = jm.decode_step(jax_params, jnp.asarray(tok), jc,
                                jnp.int32(off), jnp.asarray(KV_START))
        tl, tc = tm.decode_step(port_params, torch.from_numpy(tok), tc, off,
                                torch.from_numpy(KV_START))
        _close(tl, jl)
    for t_leaf, j_leaf in zip(tc["self"], jc["self"]):
        _close(t_leaf, j_leaf)


def test_decode_positions_clamp_at_the_table_end(jax_params, port_params):
    """Without kv_start the reference's ``dynamic_slice_in_dim`` clamps the
    offset into the 128-row position table; the port clamps the same way
    at offsets past it (prefill and decode, no ragged rows)."""
    jcfg, pcfg = _cfgs()
    jm, tm = jax_build_model(jcfg), build_model(pcfg)
    max_len, frames = 160, _frames(5, B)
    toks = _tokens(6, (B, 4))
    jl, jc = jm.prefill(jax_params, {"tokens": jnp.asarray(toks),
                                     "encoder_embeds": jnp.asarray(frames)},
                        jm.init_cache(B, max_len))
    tl, tc = tm.prefill(port_params, {"tokens": torch.from_numpy(toks),
                                      "encoder_embeds": torch.from_numpy(frames)},
                        tm.init_cache(B, max_len, device="cpu"))
    _close(tl, jl)
    for off in (126, 127, 128, 150):
        tok = _tokens(off, (B, 1))
        jl, jc = jm.decode_step(jax_params, jnp.asarray(tok), jc,
                                jnp.int32(off))
        tl, tc = tm.decode_step(port_params, torch.from_numpy(tok), tc, off)
        _close(tl, jl)


def test_decode_step_gemm_shapes(port_params):
    """Per decoder layer: self q / k / v / o, cross q / o (its K / V come
    from the cache), the two GELU MLP products; then the unembed."""
    from repro_torch.core import capture_gemm_shapes
    _, pcfg = _cfgs()
    tm = build_model(pcfg)
    cache = tm.init_cache(B, MAX_LEN, device="cpu")
    with capture_gemm_shapes() as shapes:
        tm.decode_step(port_params, torch.zeros(B, 1, dtype=torch.int32),
                       cache, 0)
    d, hd, h, kv, ff = 64, 16, 4, 2, 128
    layer = [(B, d, h * hd), (B, d, kv * hd), (B, d, kv * hd), (B, h * hd, d),
             (B, d, h * hd), (B, h * hd, d), (B, d, ff), (B, ff, d)]
    assert shapes == layer * 2 + [(B, d, 256)]


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_engine_matches_jax_engine(impl, scheduler, jax_params, port_params):
    """Four requests over three slots (a later admission, or a second wave)
    with per-request frame embeddings: tokens equal the JAX engine's, one
    host transfer per chunk or wave, the prefix cache skipped, and the
    resident cross K/V (L, max_batch, enc_len, KV, hd)."""
    jcfg, pcfg = _cfgs(attention_impl=impl)
    kw = dict(max_batch=3, max_len=64, scheduler=scheduler)
    frames = _frames(3, len(PROMPTS))
    jeng = JaxEngine(jax_build_model(jcfg), jax_params, JaxServeConfig(**kw))
    peng = Engine(build_model(pcfg), port_params,
                  ServeConfig(device="cpu", **kw))
    want = jeng.generate(PROMPTS, MAX_NEW,
                         extra_inputs={"encoder_embeds": jnp.asarray(frames)})
    got = peng.generate(PROMPTS, MAX_NEW,
                        extra_inputs={"encoder_embeds": torch.from_numpy(frames)})
    assert got == want
    st = peng.stats()
    assert st["device_transfers"] == st["chunks"] + st["waves"]
    assert st["prefix_cache"]["hits_full"] + st["prefix_cache"]["misses"] == 0
    if scheduler == "continuous":
        assert [tuple(x.shape) for x in peng._fixed["cross"]] == [
            (2, 3, ENC, 2, 16)] * 2


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
def test_flash_families_ragged_prompts_match_jax_engine(scheduler, jax_params,
                                                        port_params):
    """The ragged prompts and zero frame embeddings of the JAX package's
    FLASH_FAMILIES parity test (tests/test_serve_engine.py), flash prefill:
    the port's engine gives the JAX engine's tokens and the port's oracle's."""
    from repro_torch.serve import generate_per_prompt
    jcfg, pcfg = _cfgs(attention_impl="flash")
    kw = dict(max_batch=3, max_len=64, scheduler=scheduler)
    zeros = np.zeros((len(RAGGED), ENC, D), np.float32)
    jeng = JaxEngine(jax_build_model(jcfg), jax_params, JaxServeConfig(**kw))
    want = jeng.generate(RAGGED, 5,
                         extra_inputs={"encoder_embeds": jnp.asarray(zeros)})
    model = build_model(pcfg)
    extra = {"encoder_embeds": torch.from_numpy(zeros)}
    got = Engine(model, port_params, ServeConfig(device="cpu", **kw)).generate(
        RAGGED, 5, extra_inputs=extra)
    assert got == want
    assert got == generate_per_prompt(model, port_params, RAGGED, 5,
                                      max_len=64, extra_inputs=extra)


def test_port_oracle_matches_jax_oracle(jax_params, port_params):
    from repro.serve import generate_per_prompt as jax_generate
    from repro_torch.serve import generate_per_prompt
    jcfg, pcfg = _cfgs(attention_impl="flash")
    frames = _frames(6, len(PROMPTS))
    want = jax_generate(jax_build_model(jcfg), jax_params, PROMPTS, MAX_NEW,
                        max_len=64,
                        extra_inputs={"encoder_embeds": jnp.asarray(frames)})
    got = generate_per_prompt(build_model(pcfg), port_params, PROMPTS,
                              MAX_NEW, max_len=64,
                              extra_inputs={"encoder_embeds":
                                            torch.from_numpy(frames)})
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_the_audio_tree(dtype):
    """Every leaf of the audio tree (enc_blocks, enc_ln_f, dec_blocks,
    pos_emb, lm_head, ...) crosses bit for bit and back."""
    jcfg, pcfg = _cfgs(dtype=dtype)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(2))
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tflat = {}
    map_tree(lambda p, x: tflat.__setitem__(p, x), _bridge(jparams, pcfg))
    assert set(jflat) == set(tflat)
    assert {"enc_blocks/attn/bq", "enc_ln_f/bias", "dec_blocks/ln_x/scale",
            "dec_blocks/cross/bv", "pos_emb", "lm_head"} <= set(tflat)
    for path, ref in jflat.items():
        got = tflat[path]
        assert got.dtype == getattr(torch, dtype), path
        assert tuple(got.shape) == ref.shape, path
        back = got.view(torch.int16) if dtype == "bfloat16" else got
        np.testing.assert_array_equal(back.numpy(),
                                      ref.view(np.int16) if dtype == "bfloat16"
                                      else ref, err_msg=path)


def test_unaligned_vocab_head_is_kmajor_and_matches():
    """A vocab that is not a multiple of 8 (whisper's 51866 % 8 = 2; here
    250) keeps the untied head K-major, in the seeded init and through the
    bridge: a (vocab, d) buffer read as its transpose, with the reference's
    values and logits."""
    jcfg, pcfg = _cfgs(vocab_size=250)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    tp = _bridge(jparams, pcfg)
    for head in (tp["lm_head"], build_model(pcfg).init(0, device="cpu")["lm_head"]):
        assert tuple(head.shape) == (D, 250) and head.stride() == (1, D)
    np.testing.assert_array_equal(tp["lm_head"].numpy(),
                                  np.asarray(jparams["lm_head"]))
    toks, frames = _tokens(7, (B, S), 250), _frames(7, B)
    jl, _ = jax_build_model(jcfg).forward(
        jparams, {"tokens": jnp.asarray(toks),
                  "encoder_embeds": jnp.asarray(frames)})
    tl, _ = build_model(pcfg).forward(
        tp, {"tokens": torch.from_numpy(toks),
             "encoder_embeds": torch.from_numpy(frames)})
    _close(tl, jl)


def test_launcher_serves_audio_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--reduced", "--device", "cpu", "--attn-impl",
          "flash", "--prompts", "1,2,3;4,5", "--max-new", "3", "--stats",
          "--scheduler", "wave"])
    out = capsys.readouterr().out
    assert out.count("prompt=") == 2 and "host transfer(s)" in out
    with pytest.raises(SystemExit):
        main(["--arch", ARCH, "--reduced", "--device", "cpu", "--server"])
