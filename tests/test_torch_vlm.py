"""Reduced llama-3.2-vision-11b: the port's VLM model path (units of self
layers and a cross-attention layer over image embeddings) and its serve
engine with ``extra_inputs`` against the JAX package, on the same
numpy-seeded inputs and bridged weights.

Tolerances: logits and caches at atol=rtol=1e-4 (as
tests/test_torch_model.py); the cross K/V bit for bit (one GEMM each);
engine tokens exactly.
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
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402

ARCH = "llama-3.2-vision-11b"
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, MAX_LEN, N_IMG, D = 3, 11, 16, 8, 64
KV_START = np.array([0, 4, 9], np.int32)      # ragged left pad per row
PROMPTS = [[5, 9, 2, 7], [1, 3, 3], [2, 4, 6, 8, 1, 5, 3],
           [(i * 7 + 3) % 256 for i in range(37)]]
MAX_NEW = 6


def _cfgs(**kw):
    return (dataclasses.replace(ARCHITECTURES[ARCH].reduced(), **kw),
            dataclasses.replace(PORT_ARCHS[ARCH].reduced(), **kw))


@pytest.fixture(scope="module")
def jax_params():
    return jax_build_model(ARCHITECTURES[ARCH].reduced()).init(
        jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jax_params),
                             device="cpu")


def _images(seed, b):
    return np.random.default_rng(seed).standard_normal(
        (b, N_IMG, D)).astype(np.float32)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _close(torch_x, jax_x):
    np.testing.assert_allclose(torch_x.float().numpy(),
                               np.asarray(jax_x, np.float32), **TOL)


def test_template_and_extra_inputs():
    _, pcfg = _cfgs()
    model = build_model(pcfg)
    units = model.template["units"]
    assert "blocks" not in model.template
    assert units["selfs"]["attn"]["wq"].shape == (2, 4, D, 64)
    assert units["cross"]["cross"]["wk"].shape == (2, D, 32)
    spec = model.extra_inputs(5)["image_embeds"]
    assert spec.shape == (5, N_IMG, D) and spec.dtype == torch.float32
    assert build_model(PORT_ARCHS["llama3.2-1b"].reduced()).extra_inputs(2) == {}


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_forward_logits_match(impl, jax_params, port_params):
    jcfg, pcfg = _cfgs(attention_impl=impl)
    toks, img = _tokens(0, (B, S)), _images(0, B)
    jl, jaux = jax_build_model(jcfg).forward(
        jax_params, {"tokens": jnp.asarray(toks),
                     "image_embeds": jnp.asarray(img)})
    tl, taux = build_model(pcfg).forward(
        port_params, {"tokens": torch.from_numpy(toks),
                      "image_embeds": torch.from_numpy(img)})
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, S, 256)
    _close(tl, jl)
    assert float(taux) == float(jaux) == 0.0


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_prefill_and_decode_match_with_caches(impl, jax_params, port_params):
    """Ragged prefill then three decode steps: logits, the (U, P-1, B, S,
    KV, hd) self cache and the (U, B, N_img, KV, hd) cross cache."""
    jcfg, pcfg = _cfgs(attention_impl=impl)
    jm, tm = jax_build_model(jcfg), build_model(pcfg)
    toks, img = _tokens(1, (B, S)), _images(1, B)
    jl, jc = jm.prefill(jax_params, {
        "tokens": jnp.asarray(toks), "kv_start": jnp.asarray(KV_START),
        "image_embeds": jnp.asarray(img)}, jm.init_cache(B, MAX_LEN))
    tl, tc = tm.prefill(port_params, {
        "tokens": torch.from_numpy(toks),
        "kv_start": torch.from_numpy(KV_START),
        "image_embeds": torch.from_numpy(img)},
        tm.init_cache(B, MAX_LEN, device="cpu"))
    _close(tl, jl)
    assert set(tc) == set(jc) == {"self", "cross"}
    for t_leaf, j_leaf in zip(tc["self"], jc["self"]):
        assert tuple(t_leaf.shape) == j_leaf.shape == (2, 4, B, MAX_LEN, 2, 16)
        _close(t_leaf, j_leaf)
    for t_leaf, j_leaf in zip(tc["cross"], jc["cross"]):
        assert tuple(t_leaf.shape) == j_leaf.shape == (2, B, N_IMG, 2, 16)
        np.testing.assert_array_equal(t_leaf.numpy(), np.asarray(j_leaf))
    for step, tok in enumerate(_tokens(2, (3, B, 1))):
        off = S + step
        jl, jc = jm.decode_step(jax_params, jnp.asarray(tok), jc,
                                jnp.int32(off), jnp.asarray(KV_START))
        tl, tc = tm.decode_step(port_params, torch.from_numpy(tok), tc, off,
                                torch.from_numpy(KV_START))
        _close(tl, jl)
    for t_leaf, j_leaf in zip(tc["self"], jc["self"]):
        _close(t_leaf, j_leaf)


def test_decode_step_gemm_shapes(port_params):
    """Per unit: 4 self layers of 7 GEMMs, then the cross layer's q / o and
    its MLP (its K / V come from the cache); then the unembed."""
    from repro_torch.core import capture_gemm_shapes
    _, pcfg = _cfgs()
    tm = build_model(pcfg)
    cache = tm.init_cache(B, MAX_LEN, device="cpu")
    with capture_gemm_shapes() as shapes:
        tm.decode_step(port_params, torch.zeros(B, 1, dtype=torch.int32),
                       cache, 0)
    d, hd, h, kv, ff = 64, 16, 4, 2, 128
    self_layer = [(B, d, h * hd), (B, d, kv * hd), (B, d, kv * hd),
                  (B, h * hd, d), (B, d, ff), (B, d, ff), (B, ff, d)]
    cross = [(B, d, h * hd), (B, h * hd, d), (B, d, ff), (B, d, ff),
             (B, ff, d)]
    assert shapes == (self_layer * 4 + cross) * 2 + [(B, d, 256)]


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_engine_matches_jax_engine_with_extra_inputs(impl, scheduler,
                                                     jax_params, port_params):
    """Four requests over three slots (a later admission, or a second wave)
    with per-request image embeddings: tokens equal the JAX engine's, one
    host transfer per chunk or wave, and the prefix cache skipped."""
    jcfg, pcfg = _cfgs(attention_impl=impl)
    kw = dict(max_batch=3, max_len=64, scheduler=scheduler)
    img = _images(3, len(PROMPTS))
    jeng = JaxEngine(jax_build_model(jcfg), jax_params, JaxServeConfig(**kw))
    peng = Engine(build_model(pcfg), port_params,
                  ServeConfig(device="cpu", **kw))
    want = jeng.generate(PROMPTS, MAX_NEW,
                         extra_inputs={"image_embeds": jnp.asarray(img)})
    got = peng.generate(PROMPTS, MAX_NEW,
                        extra_inputs={"image_embeds": torch.from_numpy(img)})
    assert got == want
    st = peng.stats()
    assert st["device_transfers"] == st["chunks"] + st["waves"]
    assert st["prefix_cache"]["hits_full"] + st["prefix_cache"]["misses"] == 0


def test_engine_rows_index_the_extra_inputs(port_params):
    """``Request.row`` picks each request's image: two requests with the
    same prompt and swapped rows swap their tokens; a request without a
    row is refused when extras are given."""
    _, pcfg = _cfgs(attention_impl="flash")
    eng = Engine(build_model(pcfg), port_params,
                 ServeConfig(max_batch=2, max_len=64, device="cpu"))
    img = torch.from_numpy(_images(4, 2) * 4)
    prompt = PROMPTS[2]
    outs = []
    for rows in ((0, 1), (1, 0)):
        hs = [eng.submit(Request(prompt=prompt, max_new_tokens=MAX_NEW,
                                 row=r)) for r in rows]
        eng.run({"image_embeds": img})
        outs.append([h.result(timeout=0).tokens for h in hs])
    assert outs[0] == outs[1][::-1] and outs[0][0] != outs[0][1]
    eng.submit(Request(prompt=prompt, max_new_tokens=2))
    with pytest.raises(ValueError, match="row="):
        eng.run({"image_embeds": img})


def test_resident_cross_rows_follow_their_slots(port_params):
    """Admission copies the admitted rows of the prefill's cross K/V into
    the resident (U, max_batch, N_img, KV, hd) tree at their slots."""
    _, pcfg = _cfgs(attention_impl="flash")
    model = build_model(pcfg)
    eng = Engine(model, port_params,
                 ServeConfig(max_batch=3, max_len=64, device="cpu"))
    img = torch.from_numpy(_images(5, 3))
    eng.generate(PROMPTS[:3], 2, extra_inputs={"image_embeds": img})
    from repro_torch.models import transformer as T
    want = T._vlm_cross_cache(pcfg, port_params, img)
    for resident, ref in zip(eng._fixed["cross"], want):
        torch.testing.assert_close(resident, ref, atol=0, rtol=0)


def test_launcher_serves_vlm_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--reduced", "--device", "cpu", "--attn-impl",
          "flash", "--prompts", "1,2,3;4,5", "--max-new", "3", "--stats"])
    out = capsys.readouterr().out
    assert out.count("prompt=") == 2 and "host transfer(s)" in out
    with pytest.raises(SystemExit):
        main(["--arch", ARCH, "--reduced", "--device", "cpu", "--server"])


def test_port_oracle_matches_jax_oracle_with_extra_inputs(jax_params,
                                                         port_params):
    from repro.serve import generate_per_prompt as jax_generate
    from repro_torch.serve import generate_per_prompt
    jcfg, pcfg = _cfgs(attention_impl="flash")
    img = _images(6, len(PROMPTS))
    want = jax_generate(jax_build_model(jcfg), jax_params, PROMPTS, MAX_NEW,
                        max_len=64,
                        extra_inputs={"image_embeds": jnp.asarray(img)})
    got = generate_per_prompt(build_model(pcfg), port_params, PROMPTS,
                              MAX_NEW, max_len=64,
                              extra_inputs={"image_embeds":
                                            torch.from_numpy(img)})
    assert got == want
