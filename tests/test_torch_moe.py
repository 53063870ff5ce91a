"""Reduced olmoe-1b-7b: the port's MoE layer, model and serve engine
against the JAX package on the same numpy-seeded inputs and bridged weights.

Tolerances: routing (expert, slot position, keep) bit for bit, and the gate
too where the logits hold exact ties (XLA's and torch's CPU ``exp`` differ
in the last ulp elsewhere); the layer's output at atol=rtol=1e-6 in float32
and bit for bit in bfloat16; logits, caches and the auxiliary loss at
atol=rtol=1e-4 (as tests/test_torch_model.py); engine tokens exactly.

XLA on the CPU has no bf16 x bf16 -> f32 dot, so the bf16 case runs the
reference's expert einsums on operands upcast to f32, which is the same
product: bf16 products are exact in f32 and both sum in f32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.catalog import ARCHITECTURES  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.serve import Engine as JaxEngine  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro_torch.configs.catalog import ARCHITECTURES as PORT_ARCHS  # noqa: E402
from repro_torch.core import matmul  # noqa: E402
from repro_torch.core.gemm_api import contract_f32  # noqa: E402
from repro_torch.models import build_model, moe, params_from_numpy  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

ARCH = "olmoe-1b-7b"
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, MAX_LEN = 3, 11, 16
KV_START = np.array([0, 4, 9], np.int32)      # ragged left pad per row
RAGGED = [[5, 9, 2, 7], [1, 3, 3], [2, 4, 6, 8, 1, 5, 3]]     # test_serve_engine.py:26
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


def _bridge(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.int32)


def _close(torch_x, jax_x, tol=TOL):
    np.testing.assert_allclose(torch_x.float().numpy(),
                               np.asarray(jax_x, np.float32), **tol)


# ---------------------------------------------------------------------------
# routing and the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,e,k,cf", [(1, 64, 8, 1.25), (11, 8, 2, 1.25),
                                      (256, 64, 8, 1.25), (300, 64, 8, 1.25),
                                      (40, 8, 2, 0.25), (256, 64, 8, 8.0)])
def test_capacity_matches_reference(s, e, k, cf):
    assert moe.capacity(s, e, k, cf) == jax_moe.capacity(s, e, k, cf)
    assert moe.capacity(s, e, k, cf) % 8 == 0 and moe.capacity(s, e, k, cf) >= 8


@pytest.mark.parametrize("cap", [3, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_group_bit_equal_with_ties(cap, dtype):
    """Logits on a 0.25 grid tie many times per token: expert order,
    positions, keep and gates equal the reference's (vmapped per group)
    bit for bit; the small capacity drops slots, the large one (more
    than a group's 40 choices) none."""
    rng = np.random.default_rng(0)
    b, s, d, e, k = 3, 20, 16, 8, 2
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    logits = rng.integers(-3, 4, size=(b, s, e)).astype(np.float32) * 0.25
    jx, jl = (jnp.asarray(a).astype(dtype) for a in (x, logits))
    jbuf, jroute = jax.vmap(lambda xg, lg: jax_moe._route_group(
        xg, lg, top_k=k, num_experts=e, cap=cap))(jx, jl)
    tx, tl = (torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, logits))
    tbuf, troute = moe._route_group(tx, tl, top_k=k, num_experts=e, cap=cap)
    for name, want, got in zip(("slot_exp", "slot_pos", "keep", "gate"),
                               jroute, troute):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)
    # expert-major (E, B, C, D) buffer == the reference's (B, E, C, D)
    np.testing.assert_array_equal(
        tbuf.float().numpy(),
        np.asarray(jbuf.astype(jnp.float32)).transpose(1, 0, 2, 3))
    dropped = int((~troute[2]).sum())
    assert (dropped > 0) == (cap == 3), dropped


def test_topk_tie_order_is_lax_top_k():
    """Among equal values the lower expert comes first (torch.topk gives
    [2, 4, 1] here)."""
    logits = np.log(np.array([[[0.1, 0.3, 0.3, 0.2, 0.3, 0.1]]], np.float32))
    _, route = moe._route_group(torch.zeros(1, 1, 4),
                                torch.from_numpy(logits), top_k=3,
                                num_experts=6, cap=8)
    _, jroute = jax.vmap(lambda xg, lg: jax_moe._route_group(
        xg, lg, top_k=3, num_experts=6, cap=8))(jnp.zeros((1, 1, 4)),
                                                jnp.asarray(logits))
    assert route[0].tolist() == [[1, 2, 4]] == np.asarray(jroute[0]).tolist()


def _upcast_einsum(subscripts, *operands, **kw):
    return jnp.einsum(subscripts, *(o.astype(jnp.float32) for o in operands),
                      preferred_element_type=jnp.float32)


@pytest.mark.parametrize("cf", [1.25, 0.25])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_layer_matches_jax(dtype, cf, monkeypatch):
    """One layer at reduced width (E = 8, k = 2) on 3 rows of 40 tokens: the
    same routing (from the same router logits), the output within 1e-6 in
    float32 and bit for bit in bfloat16 (which holds the gate's rounding to
    bf16 before the f32 product), the auxiliary loss within 1e-6."""
    monkeypatch.setattr(jax_moe, "einsum", _upcast_einsum)
    cfg, _ = _cfgs(dtype=dtype)
    jp = jax_build_model(cfg).init(jax.random.PRNGKey(1))
    mp = jax.tree_util.tree_map(lambda a: a[0], jp["blocks"]["moe"])
    tp = _bridge(mp)
    x = np.random.default_rng(0).standard_normal((3, 40, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    kw = dict(top_k=2, num_experts=8, capacity_factor=cf)
    jout, jaux = jax.jit(lambda p, v: jax_moe.moe_layer(p, v, **kw))(mp, jx)
    tout, taux = moe.moe_layer(tp, tx, **kw)
    assert tout.dtype == getattr(torch, dtype) and tuple(tout.shape) == x.shape
    cap = moe.capacity(40, 8, 2, cf)
    _, jroute = jax.vmap(lambda xg, lg: jax_moe._route_group(
        xg, lg, top_k=2, num_experts=8, cap=cap))(jx, jax_moe.matmul(
            jx, mp["router"]))
    _, troute = moe._route_group(tx, matmul(tx, tp["router"]), top_k=2,
                                 num_experts=8, cap=cap)
    for want, got in zip(jroute[:3], troute[:3]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (int((~troute[2]).sum()) > 0) == (cf == 0.25)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(
            tout.float().numpy(), np.asarray(jout.astype(jnp.float32)))
    else:
        _close(tout, jout, dict(atol=1e-6, rtol=1e-6))
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=1e-6)
    _, none = moe.moe_layer(tp, tx, with_aux=False, **kw)
    assert none is None


@pytest.mark.parametrize("subscripts,shapes", [
    ("ebcd,edf->ebcf", ((4, 3, 5, 6), (4, 6, 7))),
    ("ebcf,efd->ebcd", ((4, 3, 5, 7), (4, 7, 6))),
    ("becd,edf->becf", ((3, 4, 5, 6), (4, 6, 7))),
    ("bqkgt,btkd->bqkgd", ((2, 3, 2, 2, 5), (2, 5, 2, 4))),
])
def test_contract_f32_matches_einsum(subscripts, shapes):
    """The card's bf16 einsum is one bmm over permuted views; its index
    bookkeeping, run here through an f32 bmm, equals torch.einsum."""
    gen = torch.Generator().manual_seed(0)
    a, b = (torch.randn(s, generator=gen) for s in shapes)
    seen = []

    def bmm(x, y):
        seen.append((x.shape, y.shape))
        return torch.bmm(x, y)
    got = contract_f32(subscripts, a, b, bmm=bmm)
    torch.testing.assert_close(got, torch.einsum(subscripts, a, b))
    assert len(seen) == 1
    with pytest.raises(ValueError):
        contract_f32("ii,ij->j", a, b, bmm=bmm)


def test_contract_f32_reads_the_weight_stack_in_place():
    """Under the layer's subscripts the (E, D, F) stack reaches bmm as a
    view of its own storage (no copy)."""
    w = torch.randn(4, 6, 7)
    seen = []

    def bmm(x, y):
        seen.append(y)
        return torch.bmm(x, y)
    contract_f32("ebcd,edf->ebcf", torch.randn(4, 3, 5, 6), w, bmm=bmm)
    assert seen[0].data_ptr() == w.data_ptr() and seen[0].is_contiguous()


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_template_has_the_moe_branch():
    cfg = PORT_ARCHS[ARCH].reduced()
    blocks = build_model(cfg).template["blocks"]
    assert "moe" in blocks and "mlp" not in blocks
    assert blocks["moe"]["w_gate"].shape == (2, 8, 64, 128)


@pytest.mark.parametrize("cf", [1.25, 0.25])
def test_forward_logits_and_aux_match(cf, jax_params, port_params):
    jcfg, pcfg = _cfgs(moe_capacity_factor=cf)
    toks = _tokens(0, (B, 40))
    jl, jaux = jax_build_model(jcfg).forward(jax_params,
                                             {"tokens": jnp.asarray(toks)})
    tl, taux = build_model(pcfg).forward(port_params,
                                         {"tokens": torch.from_numpy(toks)})
    assert tl.dtype == torch.float32 and tuple(tl.shape) == (B, 40, 256)
    _close(tl, jl)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    dense_l, dense_aux = build_model(PORT_ARCHS["llama3.2-1b"].reduced()).forward(
        build_model(PORT_ARCHS["llama3.2-1b"].reduced()).init(0, device="cpu"),
        {"tokens": torch.from_numpy(toks)})
    assert dense_aux == 0.0


def _prefill_both(impl, jax_params, port_params):
    jcfg, pcfg = _cfgs(attention_impl=impl)
    jm, tm = jax_build_model(jcfg), build_model(pcfg)
    toks = _tokens(1, (B, S))
    jc = jm.init_cache(B, MAX_LEN)
    tc = tm.init_cache(B, MAX_LEN, device="cpu")
    jl, jc = jm.prefill(jax_params, {"tokens": jnp.asarray(toks),
                                     "kv_start": jnp.asarray(KV_START)}, jc)
    tl, tc = tm.prefill(port_params, {"tokens": torch.from_numpy(toks),
                                      "kv_start": torch.from_numpy(KV_START)},
                        tc)
    return jm, tm, jl, jc, tl, tc


@pytest.mark.parametrize("impl", ["chunked", "flash"])
def test_prefill_and_decode_match(impl, jax_params, port_params):
    jm, tm, jl, jc, tl, tc = _prefill_both(impl, jax_params, port_params)
    _close(tl, jl)
    for t_leaf, j_leaf in zip(tc["self"], jc["self"]):
        assert tuple(t_leaf.shape) == j_leaf.shape
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


def test_decode_step_gemm_shapes(port_params):
    """Attention projections, the router (N = E) and the unembed go
    through ``matmul``; the experts do not (einsum)."""
    from repro_torch.core import capture_gemm_shapes
    _, pcfg = _cfgs()
    tm = build_model(pcfg)
    cache = tm.init_cache(B, MAX_LEN, device="cpu")
    with capture_gemm_shapes() as shapes:
        tm.decode_step(port_params, torch.zeros(B, 1, dtype=torch.int32),
                       cache, 0)
    d, hd, h, kv = 64, 16, 4, 2
    layer = [(B, d, h * hd), (B, d, kv * hd), (B, d, kv * hd), (B, h * hd, d),
             (B, d, 8)]
    assert shapes == layer * 2 + [(B, d, 256)]


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _long_prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, int(n)).tolist()
            for n in rng.integers(70, 121, size=3)]


def _count_drops(monkeypatch):
    """Count dropped slots over every routing the port runs."""
    dropped = []
    route = moe._route_group

    def counting(*a, **kw):
        buf, r = route(*a, **kw)
        dropped.append(int((~r[2]).sum()))
        return buf, r
    monkeypatch.setattr(moe, "_route_group", counting)
    return dropped


@pytest.mark.parametrize("traffic", ["ragged, flash", "long, cf 0.25"])
@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
def test_engine_matches_jax_engine(scheduler, traffic, jax_params,
                                   port_params, monkeypatch):
    """Tokens equal the JAX engine's; at capacity factor 0.25 with 70-120
    token prompts the prefill drops slots (asserted), so the rows' results
    depend on their padded length exactly as the reference's do.

    The forced-drop case runs the chunked attention path: the JAX engine's
    jitted prefill takes it even under ``attention_impl="flash"`` (its cache
    offset is traced, "cached-continuation"), and a fully masked pad row
    comes out of the chunked path as a mean over the row's columns but out
    of flash as 0.  Pad tokens route and take capacity before the real
    ones, so with drops the two paths give other tokens."""
    long = traffic != "ragged, flash"
    model_kw = dict(attention_impl="chunked" if long else "flash")
    if long:
        model_kw["moe_capacity_factor"] = 0.25
    prompts = _long_prompts() if long else RAGGED
    max_len = 160 if long else 64
    jcfg, pcfg = _cfgs(**model_kw)
    kw = dict(max_batch=3, max_len=max_len, scheduler=scheduler)
    jeng = JaxEngine(jax_build_model(jcfg), jax_params, JaxServeConfig(**kw))
    peng = Engine(build_model(pcfg), port_params,
                  ServeConfig(device="cpu", **kw))
    dropped = _count_drops(monkeypatch)
    got = peng.generate(prompts, MAX_NEW)
    assert got == jeng.generate(prompts, MAX_NEW)
    assert (sum(dropped) > 0) == long, dropped
    st = peng.stats()
    if scheduler == "wave":
        assert st["device_transfers"] == st["waves"] == 1
    else:
        assert st["device_transfers"] == st["chunks"] > 0


def test_one_device_transfer_per_chunk(port_params):
    _, pcfg = _cfgs(attention_impl="flash")
    eng = Engine(build_model(pcfg), port_params,
                 ServeConfig(max_batch=3, max_len=64, decode_chunk=2,
                             device="cpu"))
    eng.generate(RAGGED, 7)
    st = eng.stats()
    assert st["chunks"] == 4            # ceil(7 / 2) chunks for the batch
    assert st["device_transfers"] == st["chunks"]
    assert st["tokens_generated"] == 21


def test_launcher_serves_olmoe_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--arch", ARCH, "--reduced", "--device", "cpu", "--attn-impl",
          "flash", "--prompts", "1,2,3;4,5", "--max-new", "3", "--stats"])
    out = capsys.readouterr().out
    assert out.count("prompt=") == 2 and "host transfer(s)" in out
