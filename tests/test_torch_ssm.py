"""Reduced mamba2-130m: the port's SSD block (``models/ssm.py``), the
``mamba_lm`` model (``models/hybrid.py``) and the serve engine on the
forced wave scheduler, against the JAX package on the same numpy-seeded
inputs and bridged weights.

Tolerances: one SSD block in float32 at atol=rtol=2e-5 (the chunk loop
sums the inter-chunk recurrence in another order than the reference's
associative scan; the rest is the summation order of f32 products), and at
1e-4 with full-width chunks of 128 (sums of 128 products a term); the
conv state bit for bit (it is the pre-conv input); the causal conv in
float32 at 1e-6 and in bfloat16 at one bf16 ulp (atol=rtol=2**-7: both sum
four bf16 products in the same order, but XLA and torch round the bf16
intermediates of SiLU differently on the CPU); logits and caches at
atol=rtol=1e-4 (as tests/test_torch_model.py); prefill + decode against
one forward over the whole sequence at 2e-4 (the reference's own hand-off
test, tests/test_ssm_moe.py); engine tokens exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.catalog import ARCHITECTURES  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models.params import init_params as jax_init_params  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs.catalog import ARCHITECTURES as PORT_ARCHS  # noqa: E402
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.models.params import map_tree  # noqa: E402
from repro_torch.serve import Engine, ServeConfig, generate_per_prompt  # noqa: E402

ARCH = "mamba2-130m"
BLOCK_TOL = dict(atol=2e-5, rtol=2e-5)
TOL = dict(atol=1e-4, rtol=1e-4)
B, D = 3, 64
RAGGED = [[5, 9, 2, 7], [1, 3, 3], [2, 4, 6, 8, 1, 5, 3]]     # test_serve_engine.py:26
PROMPTS = RAGGED + [[(i * 7 + 3) % 256 for i in range(37)]]
MAX_NEW = 6


def _cfgs(**kw):
    return (dataclasses.replace(ARCHITECTURES[ARCH].reduced(), **kw),
            dataclasses.replace(PORT_ARCHS[ARCH].reduced(), **kw))


def _bridge(tree, template=None):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu", template=template)


@pytest.fixture(scope="module")
def jax_params():
    return jax_build_model(ARCHITECTURES[ARCH].reduced()).init(
        jax.random.PRNGKey(1))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return _bridge(jax_params)


def _block_params(jcfg, seed=0, a_log_scale=0.0):
    """One SSD block's params, JAX and bridged; ``A_log`` (zeros by the
    template) drawn from U[0, a_log_scale) when a scale is given."""
    jp = jax_init_params(jax_ssm.ssm_template(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    h = jp["A_log"].shape[0]
    if a_log_scale:
        jp["A_log"] = jnp.asarray(rng.uniform(0, a_log_scale, h), jnp.float32)
    jp["dt_bias"] = jnp.asarray(rng.standard_normal(h), jnp.float32)
    jp["D"] = jnp.asarray(rng.standard_normal(h), jnp.float32)
    return jp, _bridge(jp)


def _x(seed, b, s, d=D):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


def _valid(b, s):
    starts = np.array([0, s // 3, s - 1][:b])
    return np.arange(s)[None, :] >= starts[:, None]


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _close(torch_x, jax_x, tol=TOL):
    np.testing.assert_allclose(torch_x.float().numpy(),
                               np.asarray(jax_x, np.float32), **tol)


def test_chunk_len_is_the_reference_divisor():
    """The largest divisor of S not above the chunk (ssm.py:93-96)."""
    cases = {(8, 8): 8, (16, 8): 8, (12, 8): 6, (13, 8): 1, (300, 128): 100,
             (131, 128): 1, (37, 128): 37, (992, 128): 124, (256, 128): 128}
    for (s, chunk), want in cases.items():
        assert S._chunk_len(s, chunk) == want, (s, chunk)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("s", [8, 16, 12, 13])
def test_ssm_block_matches(s, masked):
    """A full chunk, two chunks, a chunk that degrades to 6 and a prime S
    that degrades to 1; with and without a ragged ``valid_mask``: the
    output and both state leaves."""
    jcfg, pcfg = _cfgs()
    jp, tp = _block_params(jcfg, seed=s)
    x = _x(s, B, s)
    valid = _valid(B, s) if masked else None
    want, wstate = jax_ssm.ssm_block(
        jp, jnp.asarray(x), jcfg, return_state=True,
        valid_mask=None if valid is None else jnp.asarray(valid))
    got, gstate = S.ssm_block(
        tp, torch.from_numpy(x), pcfg, return_state=True,
        valid_mask=None if valid is None else torch.from_numpy(valid))
    assert tuple(got.shape) == (B, s, D)
    _close(got, want, BLOCK_TOL)
    assert tuple(gstate["conv"].shape) == wstate["conv"].shape == (B, 3, 160)
    np.testing.assert_array_equal(gstate["conv"].numpy(),
                                  np.asarray(wstate["conv"]))
    assert gstate["ssm"].dtype == torch.float32
    assert tuple(gstate["ssm"].shape) == wstate["ssm"].shape == (B, 8, 16, 16)
    _close(gstate["ssm"], wstate["ssm"], BLOCK_TOL)
    # without return_state: the output alone, the same values
    alone = S.ssm_block(tp, torch.from_numpy(x), pcfg,
                        valid_mask=None if valid is None
                        else torch.from_numpy(valid))
    assert torch.equal(alone, got)


def test_ssm_block_full_width_chunk_stays_finite():
    """S = 256 at chunk 128 (two full-width chunks, small heads) with
    A_log from U[0, 3): cum falls by hundreds inside a chunk, so exp(seg)
    overflows to inf above the diagonal; the where keeps it out, and the
    output and state are finite and equal the reference's."""
    jcfg, pcfg = _cfgs(ssm_chunk=128)
    jp, tp = _block_params(jcfg, seed=7, a_log_scale=3.0)
    x = _x(7, 2, 256)
    valid = _valid(2, 256)
    want, wstate = jax_ssm.ssm_block(jp, jnp.asarray(x), jcfg,
                                     return_state=True,
                                     valid_mask=jnp.asarray(valid))
    got, gstate = S.ssm_block(tp, torch.from_numpy(x), pcfg,
                              return_state=True,
                              valid_mask=torch.from_numpy(valid))
    # the largest seg above the diagonal: exp of it overflows float32
    _, _, dt = S._split_zxbcdt(pcfg, torch.from_numpy(x) @ tp["in_proj"])
    da = S._softplus(dt + tp["dt_bias"]) * -torch.exp(tp["A_log"])
    cum = da.reshape(2, 2, 128, -1).cumsum(2)
    assert float((cum[:, :, 0] - cum[:, :, -1]).max()) > 89.0
    assert bool(torch.isfinite(got).all())
    assert bool(torch.isfinite(gstate["ssm"]).all())
    _close(got, want)
    _close(gstate["ssm"], wstate["ssm"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches(dtype):
    jcfg, pcfg = _cfgs(dtype=dtype)
    jp, tp = _block_params(jcfg, seed=3)
    dt = getattr(torch, dtype)
    x = _x(3, B, 12, 160)
    jx = jnp.asarray(x).astype(dtype)
    got = S._causal_conv({k: v.to(dt) for k, v in tp.items()},
                         torch.from_numpy(x).to(dt), pcfg)
    want = jax_ssm._causal_conv(
        jax.tree_util.tree_map(lambda v: v.astype(dtype), jp), jx, jcfg)
    assert got.dtype == dt
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    _close(got, want, dict(atol=tol, rtol=tol))


def test_ssm_decode_step_matches():
    """Three steps from a random state: the output and the state, updated
    in place in the port (the tensors passed in are the ones returned)."""
    jcfg, pcfg = _cfgs()
    jp, tp = _block_params(jcfg, seed=4)
    rng = np.random.default_rng(4)
    conv = rng.standard_normal((B, 3, 160)).astype(np.float32)
    ssm = rng.standard_normal((B, 8, 16, 16)).astype(np.float32)
    jstate = {"conv": jnp.asarray(conv), "ssm": jnp.asarray(ssm)}
    tstate = {"conv": torch.from_numpy(conv.copy()),
              "ssm": torch.from_numpy(ssm.copy())}
    leaves = dict(tstate)
    for step in range(3):
        x = _x(10 + step, B, 1)
        want, jstate = jax_ssm.ssm_decode_step(jp, jnp.asarray(x), jstate, jcfg)
        got, tstate = S.ssm_decode_step(tp, torch.from_numpy(x), tstate, pcfg)
        assert tuple(got.shape) == (B, 1, D)
        _close(got, want, BLOCK_TOL)
        for k in ("conv", "ssm"):
            assert tstate[k] is leaves[k]
            _close(tstate[k], jstate[k], BLOCK_TOL)


def test_state_init_matches():
    jcfg, pcfg = _cfgs()
    want = jax_ssm.ssm_state_init(jcfg, 2, jnp.bfloat16)
    got = S.ssm_state_init(pcfg, 2, torch.bfloat16, device="cpu")
    for k in ("conv", "ssm"):
        assert tuple(got[k].shape) == want[k].shape
        assert not got[k].any()
    assert got["conv"].dtype == torch.bfloat16 and got["ssm"].dtype == torch.float32


def test_prefill_then_decode_equals_one_forward(port_params):
    """The reference's hand-off contract: a prefill of the first 9 tokens
    then 7 decode steps gives the logits one forward over all 16 gives."""
    _, pcfg = _cfgs()
    model = build_model(pcfg)
    toks = torch.from_numpy(_tokens(5, (2, 16)))
    full, _ = model.forward(port_params, {"tokens": toks})
    logits, cache = model.prefill(port_params, {"tokens": toks[:, :9]},
                                  model.init_cache(2, 16, device="cpu"))
    steps = [logits]
    for t in range(9, 16):
        logits, cache = model.decode_step(port_params, toks[:, t:t + 1], cache, t)
        steps.append(logits)
    np.testing.assert_allclose(torch.stack(steps[:-1], 1).numpy(),
                               full[:, 8:15].numpy(), atol=2e-4, rtol=2e-4)


def test_templates_match_the_reference():
    """Param counts and leaf shapes of both SSM-family templates equal the
    JAX package's, at full width and reduced."""
    for arch, full in (("mamba2-130m", 128_983_488), ("zamba2-2.7b", None)):
        for reduce in (False, True):
            jcfg, pcfg = ARCHITECTURES[arch], PORT_ARCHS[arch]
            if reduce:
                jcfg, pcfg = jcfg.reduced(), pcfg.reduced()
            jm, pm = jax_build_model(jcfg), build_model(pcfg)
            assert pm.param_count() == jm.param_count(), (arch, reduce)
            shapes = {}
            map_tree(lambda p, spec: shapes.__setitem__(p, spec.shape),
                     pm.template)
            jshapes = {"/".join(str(getattr(k, "key", k)) for k in path):
                       tuple(spec.shape) for path, spec in
                       jax.tree_util.tree_flatten_with_path(
                           jm.template,
                           is_leaf=lambda x: hasattr(x, "axes"))[0]}
            assert shapes == jshapes, (arch, reduce)
            if full and not reduce:
                assert pm.param_count() == full
    assert "lm_head" not in build_model(PORT_ARCHS[ARCH]).template   # tied


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trips_the_ssm_tree(dtype):
    jcfg, pcfg = _cfgs(dtype=dtype)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(2))
    jflat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    tflat = {}
    map_tree(lambda p, x: tflat.__setitem__(p, x), _bridge(jparams))
    assert set(jflat) == set(tflat)
    assert {"blocks/ssm/in_proj", "blocks/ssm/conv_w", "blocks/ssm/A_log",
            "blocks/ln/scale", "embedding"} <= set(tflat)
    for path, ref in jflat.items():
        got = tflat[path]
        assert got.dtype == getattr(torch, dtype), path
        back = got.view(torch.int16) if dtype == "bfloat16" else got
        np.testing.assert_array_equal(back.numpy(),
                                      ref.view(np.int16) if dtype == "bfloat16"
                                      else ref, err_msg=path)


def test_forward_logits_match(jax_params, port_params):
    jcfg, pcfg = _cfgs()
    toks = _tokens(0, (B, 13))
    jl, _ = jax_build_model(jcfg).forward(jax_params,
                                          {"tokens": jnp.asarray(toks)})
    tl, aux = build_model(pcfg).forward(port_params,
                                        {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, 13, 256)
    _close(tl, jl)
    assert aux == 0.0


def test_prefill_and_decode_match_with_caches(jax_params, port_params):
    """Ragged prefill (pad zeroed inside every block) then three decode
    steps: logits and both state leaves, (L, B, ...) each."""
    jcfg, pcfg = _cfgs()
    jm, tm = jax_build_model(jcfg), build_model(pcfg)
    toks, ks = _tokens(1, (B, 12)), np.array([0, 4, 9], np.int32)
    jl, jc = jm.prefill(jax_params, {"tokens": jnp.asarray(toks),
                                     "kv_start": jnp.asarray(ks)},
                        jm.init_cache(B, 16))
    tl, tc = tm.prefill(port_params, {"tokens": torch.from_numpy(toks),
                                      "kv_start": torch.from_numpy(ks)},
                        tm.init_cache(B, 16, device="cpu"))
    _close(tl, jl)
    assert set(tc) == set(jc) == {"ssm"}
    for k in ("conv", "ssm"):
        assert tuple(tc["ssm"][k].shape) == jc["ssm"][k].shape
        _close(tc["ssm"][k], jc["ssm"][k])
    for step, tok in enumerate(_tokens(2, (3, B, 1))):
        jl, jc = jm.decode_step(jax_params, jnp.asarray(tok), jc,
                                jnp.int32(12 + step), jnp.asarray(ks))
        tl, tc = tm.decode_step(port_params, torch.from_numpy(tok), tc,
                                12 + step, torch.from_numpy(ks))
        _close(tl, jl)
    for k in ("conv", "ssm"):
        _close(tc["ssm"][k], jc["ssm"][k])


def test_decode_step_gemm_shapes(port_params):
    """Per layer the in_proj and out_proj; then the tied unembed."""
    from repro_torch.core import capture_gemm_shapes
    _, pcfg = _cfgs()
    tm = build_model(pcfg)
    with capture_gemm_shapes() as shapes:
        tm.decode_step(port_params, torch.zeros(B, 1, dtype=torch.int32),
                       tm.init_cache(B, 16, device="cpu"), 0)
    assert shapes == [(B, 64, 2 * 128 + 2 * 16 + 8), (B, 128, 64)] * 2 + [
        (B, 64, 256)]


def test_engine_matches_jax_engine_on_the_forced_wave(jax_params, port_params):
    """Four requests over three slots, continuous asked: both engines force
    the wave scheduler (no self-attention KV cache) and give the same
    tokens, one host transfer a wave, no prefix cache."""
    jcfg, pcfg = _cfgs()
    kw = dict(max_batch=3, max_len=64)
    jeng = JaxEngine(jax_build_model(jcfg), jax_params, JaxServeConfig(**kw))
    peng = Engine(build_model(pcfg), port_params,
                  ServeConfig(device="cpu", **kw))
    want = jeng.generate(PROMPTS, MAX_NEW)
    got = peng.generate(PROMPTS, MAX_NEW)
    assert got == want
    st, jst = peng.stats(), jeng.stats()
    assert st["scheduler"] == jst["scheduler"] == "wave"
    assert st["scheduler_forced"] == jst["scheduler_forced"] == \
        "no self-attention KV cache"
    assert st["device_transfers"] == st["waves"] == 2
    assert not st["prefix_cache"]["enabled"]


def test_ragged_batch_matches_each_prompt_alone(port_params):
    """As tests/test_serve_engine.py:47-54: pad zeroing keeps each short
    prompt's state what its solo run gives."""
    _, pcfg = _cfgs()
    eng = Engine(build_model(pcfg), port_params,
                 ServeConfig(max_batch=3, max_len=64, device="cpu"))
    batched = eng.generate(RAGGED, 4)
    assert batched == [eng.generate([p], 4)[0] for p in RAGGED]


def test_prompt_shorter_than_the_conv_window(port_params):
    """A prompt of 1 or 2 tokens prefills alone (the oracle) with a conv
    state of zeros before its tokens, the left context the engine's padded
    prefill gives it: both decode the same tokens."""
    _, pcfg = _cfgs()
    model = build_model(pcfg)
    prompts = [[7], [7, 3]]
    eng = Engine(model, port_params,
                 ServeConfig(max_batch=2, max_len=32, device="cpu"))
    assert eng.generate(prompts, 5) == generate_per_prompt(
        model, port_params, prompts, 5, max_len=32)


def test_port_oracle_matches_jax_oracle(jax_params, port_params):
    from repro.serve import generate_per_prompt as jax_generate
    jcfg, pcfg = _cfgs()
    want = jax_generate(jax_build_model(jcfg), jax_params, PROMPTS, MAX_NEW,
                        max_len=64)
    got = generate_per_prompt(build_model(pcfg), port_params, PROMPTS,
                              MAX_NEW, max_len=64)
    assert got == want


def test_launcher_serves_ssm_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--reduced", "--device", "cpu", "--prompts",
          "1,2,3;4,5", "--max-new", "3", "--stats"])
    out = capsys.readouterr().out
    assert out.count("prompt=") == 2
    assert "scheduler=wave (forced: no self-attention KV cache)" in out
    assert "1 host transfer(s)" in out and "prefix cache: off" in out
