"""The port's optimizer pieces against the JAX package's on the same
numpy inputs: AdamW over 3 updates (with and without clipping, with a
schedule, with weight decay), ``global_norm``, both schedules, and int8
gradient compression with its error-feedback residual.

Tolerance: float32 rtol=atol=1e-6 (elementwise arithmetic in one order;
XLA's and torch's sqrt, cos and pow may differ in the last ulp).  The
compression's int8 values and scales are compared exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.optim import constant as jax_constant  # noqa: E402
from repro.optim import global_norm as jax_global_norm  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro_torch.models.params import params_from_numpy, tree_paths  # noqa: E402
from repro_torch.optim import AdamW, constant, global_norm, warmup_cosine  # noqa: E402
from repro_torch.optim import compression as comp  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "stack": {"k": (rng.standard_normal((2, 4, 3)) * scale
                            ).astype(np.float32)},
            "scale": (rng.standard_normal(5) * scale).astype(np.float32)}


def _t(tree):
    return params_from_numpy(tree, device="cpu")


def _close(torch_tree, jax_tree, tol=TOL):
    want = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(jax_tree)[0]}
    got = tree_paths(torch_tree)
    assert set(got) == set(want)
    for path, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[path], err_msg=path, **tol)


@pytest.mark.parametrize("case", ["clip", "no-clip", "schedule", "no-decay"])
def test_adamw_three_updates_match_jax(case):
    kw = {"clip": dict(grad_clip_norm=1.0),
          "no-clip": dict(grad_clip_norm=None),
          "schedule": dict(grad_clip_norm=0.5),
          "no-decay": dict(weight_decay=0.0)}[case]
    if case == "schedule":
        jopt = JAdamW(learning_rate=jax_warmup_cosine(1e-2, 2, 5), **kw)
        topt = AdamW(learning_rate=warmup_cosine(1e-2, 2, 5), **kw)
    else:
        jopt, topt = JAdamW(learning_rate=1e-2, **kw), AdamW(
            learning_rate=1e-2, **kw)
    params = _tree(0)
    jp, tp = jax.tree_util.tree_map(jnp.asarray, params), _t(params)
    js, ts = jopt.init(jp), topt.init(tp)
    for i in range(3):
        grads = _tree(10 + i, scale=3.0)    # global norm > 1: clipping acts
        jp, js, jm = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                 js, jp)
        tp, ts, tm = topt.update(_t(grads), ts, tp)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    assert int(ts.count) == 3
    _close(tp, jp)
    _close(ts.m, js.m)
    _close(ts.v, js.v)
    _close(ts.master, js.master)


def test_adamw_decays_matrices_only():
    opt = AdamW(learning_rate=0.1, weight_decay=0.5, grad_clip_norm=None)
    params = _t(_tree(0))
    zeros = {p: torch.zeros_like(t) for p, t in tree_paths(params).items()}
    grads = {"w": zeros["w"], "stack": {"k": zeros["stack/k"]},
             "scale": zeros["scale"]}
    new, _, _ = opt.update(grads, opt.init(params), params)
    assert torch.equal(new["scale"], params["scale"])         # ndim 1
    torch.testing.assert_close(new["w"], params["w"] * (1 - 0.1 * 0.5))
    torch.testing.assert_close(new["stack"]["k"],
                               params["stack"]["k"] * (1 - 0.1 * 0.5))


def test_adamw_master_is_f32_and_params_keep_their_dtype():
    opt = AdamW()
    params = {"w": torch.randn(4, 4).bfloat16()}
    st = opt.init(params)
    assert st.master["w"].dtype == torch.float32
    assert st.master["w"].data_ptr() != params["w"].data_ptr()
    new, st2, _ = opt.update({"w": torch.randn(4, 4).bfloat16()}, st, params)
    assert new["w"].dtype == torch.bfloat16 and st2.m["w"].dtype == torch.float32
    torch.testing.assert_close(new["w"], st2.master["w"].bfloat16(), atol=0,
                               rtol=0)


def test_global_norm_matches_jax():
    tree = _tree(3, scale=2.0)
    np.testing.assert_allclose(
        float(global_norm(_t(tree))),
        float(jax_global_norm(jax.tree_util.tree_map(jnp.asarray, tree))),
        **TOL)


def test_schedules_match_jax():
    wc, jwc = warmup_cosine(3e-3, 4, 20), jax_warmup_cosine(3e-3, 4, 20)
    for step in range(0, 25):
        np.testing.assert_allclose(
            float(wc(torch.tensor(step, dtype=torch.int32))),
            float(jwc(jnp.int32(step))), **TOL)
    got = constant(5e-4)(torch.tensor(7, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert float(got) == float(jax_constant(5e-4)(jnp.int32(7)))


def test_compression_with_residual_matches_jax():
    params = _tree(0)
    js = jcomp.init_state(jax.tree_util.tree_map(jnp.asarray, params))
    ts = comp.init_state(_t(params))
    for i in range(3):
        grads = _tree(20 + i, scale=0.01 * (i + 1))
        jdeq, js = jcomp.compress_grads(
            jax.tree_util.tree_map(jnp.asarray, grads), js)
        tdeq, ts = comp.compress_grads(_t(grads), ts)
        _close(tdeq, jdeq)
        _close(ts.residual, js.residual, dict(rtol=1e-5, atol=1e-9))


def test_quantize_matches_jax_exactly():
    x = np.random.default_rng(5).standard_normal(1000).astype(np.float32)
    x[:4] = [0.5, -0.5, 1.5, 2.5]       # ties round half to even in both
    q, s = comp._quantize(torch.from_numpy(x))
    jq, js_ = jcomp._quantize(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js_)
    zero_q, zero_s = comp._quantize(torch.zeros(3))
    assert not zero_q.any() and float(zero_s) > 0
