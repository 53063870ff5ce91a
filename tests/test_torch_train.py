"""Training in the port against the JAX package's, on the CPU: the
differentiable ``core.matmul`` (its autograd Function over ``gemm_ref``),
``lm_loss``, the train step for reduced llama3.2-1b and olmoe-1b-7b from a
bridged state, microbatching, ``Trainer.run`` and the train launcher.  The
JAX side runs on its default XLA backend (its Pallas GEMM has no
transpose rule, so the reference trains on XLA dots).

Tolerances (float32): the matmul Function's gradients 1e-5 against
autograd through ``gemm_ref`` and 1e-4 against ``jax.grad`` (bf16 outputs:
one bf16 ulp, 2e-2); losses and metrics rtol 1e-5; gradient leaves atol
1e-6 / rtol 1e-4 (summation order over the batch and the vocab); parameters
after the steps atol 1e-4 / rtol 1e-4 (AdamW divides each update by the
root of its second moment, which spreads a last-ulp gradient difference
over a fraction of the learning rate, 1e-3).
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.catalog import ARCHITECTURES  # noqa: E402
from repro.core import matmul as jax_matmul  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import TokenPipeline as JTokenPipeline  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import warmup_cosine as jax_warmup_cosine  # noqa: E402
from repro.train import Trainer as JTrainer  # noqa: E402
from repro.train import TrainerConfig as JTrainerConfig  # noqa: E402
from repro.train import init_train_state as jax_init_train_state  # noqa: E402
from repro.train import lm_loss as jax_lm_loss  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs.catalog import ARCHITECTURES as PORT_ARCHS  # noqa: E402
from repro_torch.core import matmul  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.kernels.ref import gemm_ref  # noqa: E402
from repro_torch.models import build_model, train_state_from_numpy  # noqa: E402
from repro_torch.models.params import tree_paths  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.train import (Trainer, TrainerConfig, lm_loss,  # noqa: E402
                               make_train_step)
from repro_torch.train.trainer import _value_and_grad  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ACTIVATIONS = [None, "relu", "gelu", "silu", "tanh"]
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
#: one architecture a family: dense, moe, vlm, audio, ssm, hybrid
ARCHS = ["llama3.2-1b", "olmoe-1b-7b", "llama-3.2-vision-11b",
         "whisper-large-v3", "mamba2-130m", "zamba2-2.7b"]
B, S = 4, 16


def _jax_paths(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


#: Held within the reference's own spread: reduced zamba2's loss has a
#: gradient norm near 150, so one f32 ulp of noise on the reference's
#: weights (1e-7 relative, ``_ulp_noise``) moves its own gradients by 2-6e-5
#: of each leaf's max and its grad norm by 3e-6 to 1e-5: past GRAD_TOL and
#: METRIC_TOL, and as far as the port is from it.  A leaf or metric of
#: these is within its tolerance or within SPREAD_FACTOR times the largest
#: distance of three such perturbed references from the reference (relative
#: to the leaf's max over the tree; to the value for a metric).
SPREAD_ARCHS = ("zamba2-2.7b",)
SPREAD_FACTOR = 4
NOISE_SEEDS = (1, 2, 3)


def _ulp_noise(tree, seed):
    """The reference's leaves times (1 + 1e-7 N(0, 1)), seeded."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: a * (1 + 1e-7 * rng.standard_normal(a.shape)
                       ).astype(np.float32), tree)


def _close(got, want, tol, scale, msg):
    """``got`` within ``tol`` of ``want``, or (``scale`` not None) within
    SPREAD_FACTOR * scale * max|want| where that is larger."""
    if scale is None:
        np.testing.assert_allclose(got, want, err_msg=msg, **tol)
        return
    err = np.abs(got - want)
    bound = np.maximum(tol["atol"] + tol["rtol"] * np.abs(want),
                       SPREAD_FACTOR * scale * np.abs(want).max())
    assert (err <= bound).all(), (msg, float(err.max()), scale)


def _close_trees(torch_tree, jax_tree, tol, noisy=None):
    """Every leaf of the port's tree against the reference's; ``noisy``:
    the perturbed references' trees (SPREAD_ARCHS)."""
    want = _jax_paths(jax_tree)
    got = tree_paths(torch_tree)
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    scale = None
    if noisy is not None:
        scale = max(np.abs(n[p] - w).max() / max(np.abs(w).max(), 1e-30)
                    for n in map(_jax_paths, noisy) for p, w in want.items())
    for path, t in got.items():
        _close(t.float().numpy(), want[path], tol, scale, path)


# ---------------------------------------------------------------------------
# the matmul Function
# ---------------------------------------------------------------------------

def _mm_operands(seed, m=6, k=24, n=10, kmajor=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, m // 2, k)).astype(np.float32)
    w = (rng.standard_normal((n, k) if kmajor else (k, n))
         * k ** -0.5).astype(np.float32)
    bias = rng.standard_normal(n).astype(np.float32)
    ct = rng.standard_normal((2, m // 2, n)).astype(np.float32)
    return x, w, bias, ct


def _torch_grads(fn, x, w, bias, ct, kmajor):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y = fn(xt, wt.t() if kmajor else wt, bt)
    (y.float() * torch.from_numpy(ct)).sum().backward()
    return y.detach(), xt.grad, wt.grad, bt.grad


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_matmul_function_grads_match_plain_autograd_and_jax(activation,
                                                            out_dtype):
    x, w, bias, ct = _mm_operands(0)
    od = getattr(torch, out_dtype)
    y, dx, dw, db = _torch_grads(
        lambda a, b, c: matmul(a, b, bias=c, activation=activation,
                               out_dtype=od), x, w, bias, ct, False)
    assert y.dtype == od
    plain = _torch_grads(
        lambda a, b, c: gemm_ref(a.reshape(-1, a.shape[-1]), b, bias=c,
                                 activation=activation, out_dtype=od
                                 ).reshape(*a.shape[:-1], -1),
        x, w, bias, ct, False)
    tol = 1e-5 if out_dtype == "float32" else 2e-2
    for got, want in zip((y, dx, dw, db), plain):
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)

    def jax_loss(a, b, c):
        out = jax_matmul(a, b, bias=c, activation=activation,
                         out_dtype=jnp.dtype(out_dtype))
        return (out.astype(jnp.float32) * ct).sum()
    jg = jax.grad(jax_loss, argnums=(0, 1, 2))(x, w, bias)
    tol = 1e-4 if out_dtype == "float32" else 2e-2
    for got, want in zip((dx, dw, db), jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                                   rtol=tol)


def test_matmul_function_kmajor_tied_view_gives_the_embedding_its_grad():
    """The tied head: ``embedding.t()``, f32 out; the gradient lands on the
    (V, D) embedding through the view."""
    x, emb, _, ct = _mm_operands(1, kmajor=True)
    y, dx, demb, _ = _torch_grads(
        lambda a, b, c: matmul(a, b, out_dtype=torch.float32), x, emb,
        np.zeros(emb.shape[0], np.float32), ct, True)
    assert demb.shape == emb.shape
    jg = jax.grad(lambda a, e: (jax_matmul(a, e.T, out_dtype=jnp.float32)
                                * ct).sum(), argnums=(0, 1))(x, emb)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jg[0]), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(demb.numpy(), np.asarray(jg[1]), atol=1e-5,
                               rtol=1e-5)


def test_matmul_function_bf16_operands_run_bf16_products():
    """bf16 operands, bf16 out: dX and dW come out bf16, within one bf16
    ulp of the f32 autograd through ``gemm_ref``."""
    x, w, bias, ct = _mm_operands(2)
    xb = torch.from_numpy(x).bfloat16().requires_grad_()
    wb = torch.from_numpy(w).bfloat16().requires_grad_()
    y = matmul(xb, wb, activation="silu")
    (y.float() * torch.from_numpy(ct)).sum().backward()
    assert xb.grad.dtype == wb.grad.dtype == torch.bfloat16
    xf = xb.detach().float().requires_grad_()
    wf = wb.detach().float().requires_grad_()
    yf = gemm_ref(xf.reshape(-1, 24), wf, activation="silu").reshape(2, 3, 10)
    (yf * torch.from_numpy(ct)).sum().backward()
    torch.testing.assert_close(xb.grad.float(), xf.grad, atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(wb.grad.float(), wf.grad, atol=2e-2, rtol=2e-2)


def test_matmul_without_grad_keeps_the_fused_path_and_records_backward():
    from repro_torch.core import capture_gemm_shapes
    x = torch.randn(6, 8)
    w = torch.randn(8, 4)
    with capture_gemm_shapes() as shapes:
        y = matmul(x, w, activation="silu")
    assert y.grad_fn is None and shapes == [(6, 8, 4)]
    wg = w.clone().requires_grad_()
    with capture_gemm_shapes() as shapes:
        matmul(x, wg, activation="silu").sum().backward()
    # forward, then dW = x.T @ dZ (x needs no grad: no dX product)
    assert shapes == [(6, 8, 4), (8, 6, 4)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_matmul_function_pads_a_bf16_dw_to_whole_rows(dtype):
    """dW = x.T @ dZ takes M as its K: in bf16 an M that is not a multiple
    of 8 (13 here; vlm's 4 x 1601 image tokens) is padded with zero rows to
    one, which the bf16 kernels need, and dW is unchanged; f32 is not
    padded."""
    from repro_torch.core import capture_gemm_shapes
    x, w, _, ct = _mm_operands(3, m=26, k=16, n=24)
    x = x.reshape(2, 13, 16)
    ct = ct.reshape(2, 13, 24)
    dt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(dt).requires_grad_()
    wt = torch.from_numpy(w).to(dt).requires_grad_()
    with capture_gemm_shapes() as shapes:
        y = matmul(xt[0], wt)
        (y.float() * torch.from_numpy(ct[0])).sum().backward()
    assert shapes[-1] == ((16, 16, 24) if dtype == "bfloat16"
                          else (16, 13, 24))
    wr = wt.detach().float().requires_grad_()
    yr = gemm_ref(xt.detach()[0].float(), wr).to(dt)
    (yr.float() * torch.from_numpy(ct[0])).sum().backward()
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    torch.testing.assert_close(wt.grad.float(), wr.grad, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# loss and train step
# ---------------------------------------------------------------------------

def _pair(arch, **kw):
    jcfg = dataclasses.replace(ARCHITECTURES[arch].reduced(), **kw)
    tcfg = dataclasses.replace(PORT_ARCHS[arch].reduced(), **kw)
    return jax_build_model(jcfg), build_model(tcfg)


def _extras(arch, batch, step):
    """Seeded extra inputs of ``arch``'s reduced model at ``step`` (vlm:
    ``image_embeds``, audio: ``encoder_embeds``; else none): the same
    numpy arrays for both packages."""
    rng = np.random.default_rng(1000 + step)
    return {k: (0.02 * rng.standard_normal(spec.shape)).astype(np.float32)
            for k, spec in build_model(PORT_ARCHS[arch].reduced())
            .extra_inputs(batch).items()}


def _pipes(seq=S, batch=B, arch=None, vocab=256):
    """(JAX pipeline, port pipeline) over the synthetic tokens; with
    ``arch``, each step's batch also carries :func:`_extras`."""
    jp = JTokenPipeline(JDataConfig(vocab_size=vocab, seq_len=seq,
                                    global_batch=batch))
    tp = TokenPipeline(DataConfig(vocab_size=vocab, seq_len=seq,
                                  global_batch=batch), device="cpu")
    if arch is None:
        return jp, tp

    def with_extras(pipe, conv):
        return lambda step: dict(pipe(step), **{
            k: conv(v) for k, v in _extras(arch, batch, step).items()})
    return with_extras(jp, jnp.asarray), with_extras(tp, torch.from_numpy)


def _states(jm, jopt, use_compression=False):
    js = jax_init_train_state(jm, jopt, jax.random.PRNGKey(0),
                              use_compression=use_compression)
    return js, train_state_from_numpy(jax.tree_util.tree_map(np.asarray, js),
                                      device="cpu")


@pytest.mark.parametrize("chunk", [0, 4])
def test_lm_loss_matches_jax_with_and_without_logit_chunk(chunk):
    jm, tm = _pair("llama3.2-1b")
    js, ts = _states(jm, JAdamW())
    jp, tp = _pipes()
    jl, jmet = jax_lm_loss(jm, js.params, jp(0), logit_chunk=chunk)
    tl, tmet = lm_loss(tm, ts.params, tp(0), logit_chunk=chunk)
    np.testing.assert_allclose(float(tl), float(jl), **METRIC_TOL)
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   err_msg=k, **METRIC_TOL)


def test_logit_chunk_gives_the_one_pass_gradient():
    _, tm = _pair("llama3.2-1b")
    jm, _ = _pair("llama3.2-1b")
    _, ts = _states(jm, JAdamW())
    batch = _pipes()[1](0)
    chunked = dataclasses.replace(tm.cfg, logit_chunk=4)
    _, _, g0 = _value_and_grad(tm, ts.params, batch)
    _, _, g4 = _value_and_grad(build_model(chunked), ts.params, batch)
    for path, g in tree_paths(g0).items():
        torch.testing.assert_close(tree_paths(g4)[path], g, atol=1e-6,
                                   rtol=1e-5, msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax(arch):
    jm, tm = _pair(arch)
    js, ts = _states(jm, JAdamW())
    jp, tp = _pipes(arch=arch)
    grad_fn = jax.value_and_grad(lambda p, b: jax_lm_loss(jm, p, b),
                                 has_aux=True)
    (jl, jmet), jg = grad_fn(js.params, jp(0))
    tl, tmet, tg = _value_and_grad(tm, ts.params, tp(0))
    np.testing.assert_allclose(float(tl), float(jl), **METRIC_TOL)
    if arch.startswith("olmoe"):
        assert float(tmet["moe_aux"]) > 0
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   err_msg=k, **METRIC_TOL)
    noisy = ([grad_fn(_ulp_noise(js.params, seed), jp(0))[1]
              for seed in NOISE_SEEDS] if arch in SPREAD_ARCHS else None)
    _close_trees(tg, jg, GRAD_TOL, noisy)


def _check_remat(arch, policy="full"):
    """The port's gradients under ``remat_policy=policy`` against the
    reference's under the same policy (``"dots"``: ``jax.checkpoint`` with
    ``dots_with_no_batch_dims_saveable``), and bit-equal to its own without
    remat and (``"dots"``) under ``"full"``."""
    jm, tm = _pair(arch, remat=True, remat_policy=policy)
    js, ts = _states(jm, JAdamW())
    jp, tp = _pipes(arch=arch)
    grad_fn = jax.value_and_grad(lambda p, b: jax_lm_loss(jm, p, b),
                                 has_aux=True)
    _, jg = grad_fn(js.params, jp(0))
    _, _, tg = _value_and_grad(tm, ts.params, tp(0))
    noisy = ([grad_fn(_ulp_noise(js.params, seed), jp(0))[1]
              for seed in NOISE_SEEDS] if arch in SPREAD_ARCHS else None)
    _close_trees(tg, jg, GRAD_TOL, noisy)
    others = [_pair(arch)[1]]
    if policy != "full":
        others.append(_pair(arch, remat=True, remat_policy="full")[1])
    for other in others:
        _, _, og = _value_and_grad(other, ts.params, tp(0))
        for path, g in tree_paths(og).items():
            torch.testing.assert_close(tree_paths(tg)[path], g, atol=0,
                                       rtol=0, msg=path)


def test_remat_gives_the_same_gradients():
    """``cfg.remat`` (policy full) recomputes each block in the backward:
    the same gradients as without, and as the reference's remat."""
    _check_remat("llama3.2-1b")


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-large-v3",
                                  "mamba2-130m", "zamba2-2.7b"])
def test_remat_gives_the_same_gradients_in_every_stack(arch):
    """The same in the cross-attention stacks (each cross layer projects
    its K, V inside its recomputed block; whisper's encoder layers too)
    and the Mamba2 stacks (each Mamba2 layer and each application of the
    shared block recomputed)."""
    _check_remat(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_remat_gives_the_reference_dots_gradients(arch):
    """``remat_policy="dots"`` (K1's outputs saved, the rest recomputed)
    in every family's stacks, the hybrid's Mamba2 layers and shared-block
    applications included: the reference's ``"dots"`` gradients, and the
    port's own without remat and under ``"full"``, bit for bit."""
    _check_remat(arch, "dots")


def _backward_calls(arch, **cfg_kw):
    """(K1 products, ``torch.einsum`` calls) that one gradient of ``arch``'s
    loss issues inside its backward (the products of the forward run
    before it are not counted)."""
    from unittest import mock

    from repro_torch.kernels import ops
    jm, tm = _pair(arch, **cfg_kw)
    _, ts = _states(jm, JAdamW())
    n = {"gemm": 0, "einsum": 0}

    def counting(fn, key):
        def call(*a, **kw):
            if torch._C._current_graph_task_id() != -1:
                n[key] += 1
            return fn(*a, **kw)
        return call
    with mock.patch.object(ops, "gemm", counting(ops.gemm, "gemm")), \
            mock.patch.object(torch, "einsum", counting(torch.einsum,
                                                        "einsum")):
        _value_and_grad(tm, ts.params, _pipes(arch=arch)[1](0))
    return n["gemm"], n["einsum"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b",
                                  "mamba2-130m", "zamba2-2.7b"])
def test_dots_backward_recomputes_no_gemm_but_every_einsum(arch):
    """Under ``"dots"`` the backward issues K1 products only for dX and dW,
    as without remat; ``"full"`` issues one more a rematted forward
    product.  The batched einsums (attention, SSD, experts) are recomputed
    under both policies, and never without remat."""
    none_gemm, none_einsum = _backward_calls(arch, remat=False)
    full_gemm, full_einsum = _backward_calls(arch, remat=True)
    dots_gemm, dots_einsum = _backward_calls(arch, remat=True,
                                             remat_policy="dots")
    cfg = PORT_ARCHS[arch].reduced()
    # forward products in the rematted blocks: 7 a dense or shared-block
    # application (q, k, v, o, gate, up, down; a MoE layer its router in
    # place of the MLP's 3), 2 a Mamba2 layer
    per_block = {"llama3.2-1b": 7 * cfg.num_layers,
                 "olmoe-1b-7b": 5 * cfg.num_layers,
                 "mamba2-130m": 2 * cfg.num_layers,
                 "zamba2-2.7b": 2 * cfg.num_layers
                 + 7 * (cfg.num_layers // max(cfg.attn_period, 1))}[arch]
    assert dots_gemm == none_gemm
    assert full_gemm == none_gemm + per_block
    assert none_einsum == 0
    assert dots_einsum == full_einsum > 0


def test_unknown_remat_policy_raises_under_grad():
    jm, tm = _pair("llama3.2-1b", remat=True, remat_policy="offload")
    _, ts = _states(jm, JAdamW())
    with pytest.raises(ValueError, match="offload"):
        _value_and_grad(tm, ts.params, _pipes()[1](0))


def test_gemm_op_reads_a_transposed_operand_in_place():
    """The ``repro_torch::gemm`` operator hands ``ops.gemm`` a transposed
    weight (a tied head's ``embedding.t()``) with its strides, uncopied,
    in the forward and (K-major again) in dX."""
    from unittest import mock

    from repro_torch.kernels import ops
    emb = torch.randn(10, 6, requires_grad=True)
    x = torch.randn(4, 6, requires_grad=True)
    seen = []
    real = ops.gemm

    def gemm(a, b, *args, **kw):
        seen.append(b.data_ptr() == emb.data_ptr() and b.stride())
        return real(a, b, *args, **kw)
    with mock.patch.object(ops, "gemm", gemm):
        matmul(x, emb.t()).sum().backward()
    assert seen[:2] == [(1, 6), (6, 1)], seen
    torch.testing.assert_close(x.grad, torch.ones(4, 10) @ emb.detach())


def _metrics_close(tm_, jm_, noisy=None):
    assert set(tm_) == set(jm_), (sorted(tm_), sorted(jm_))
    for k in jm_:
        want = float(jm_[k])
        scale = None if noisy is None else max(
            abs(float(n[k]) - want) for n in noisy) / max(abs(want), 1e-30)
        _close(float(tm_[k]), want, METRIC_TOL, scale, k)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch, steps):
    jm, tm = _pair(arch)
    jopt = JAdamW(learning_rate=jax_warmup_cosine(1e-3, 2, 4))
    topt = AdamW(learning_rate=warmup_cosine(1e-3, 2, 4))
    js, ts = _states(jm, jopt)
    jstep = jax.jit(jax_make_train_step(jm, jopt))
    tstep = make_train_step(tm, topt)
    jp, tp = _pipes(arch=arch)
    # the reference from ulp-perturbed weights (SPREAD_ARCHS)
    jns = [js._replace(params=_ulp_noise(js.params, seed),
                       opt=js.opt._replace(master=_ulp_noise(js.opt.master,
                                                             seed)))
           for seed in NOISE_SEEDS] if arch in SPREAD_ARCHS else None
    for i in range(steps):
        js, jmet = jstep(js, jp(i))
        ts, tmet = tstep(ts, tp(i))
        nmets = None
        if jns is not None:
            jns, nmets = zip(*(jstep(n, jp(i)) for n in jns))
        _metrics_close(tmet, jmet, nmets)
    assert int(ts.step) == steps and int(ts.opt.count) == steps

    def noisy(field):
        return None if jns is None else [field(n) for n in jns]
    _close_trees(ts.params, js.params, PARAM_TOL, noisy(lambda s: s.params))
    _close_trees(ts.opt.master, js.opt.master, PARAM_TOL,
                 noisy(lambda s: s.opt.master))
    _close_trees(ts.opt.m, js.opt.m, GRAD_TOL, noisy(lambda s: s.opt.m))


def test_train_step_with_compression_matches_jax():
    jm, tm = _pair("llama3.2-1b")
    jopt, topt = JAdamW(learning_rate=1e-3), AdamW(learning_rate=1e-3)
    js, ts = _states(jm, jopt, use_compression=True)
    jstep = jax.jit(jax_make_train_step(jm, jopt, use_compression=True))
    tstep = make_train_step(tm, topt, use_compression=True)
    jp, tp = _pipes()
    for i in range(2):
        js, jmet = jstep(js, jp(i))
        ts, tmet = tstep(ts, tp(i))
        _metrics_close(tmet, jmet)
    _close_trees(ts.params, js.params, PARAM_TOL)
    _close_trees(ts.compression.residual, js.compression.residual,
                 dict(rtol=1e-3, atol=1e-6))


def test_microbatches_match_one_batch_and_jax():
    jm, tm = _pair("llama3.2-1b")
    jopt, topt = JAdamW(learning_rate=1e-3), AdamW(learning_rate=1e-3)
    js, ts = _states(jm, jopt)
    jp, tp = _pipes()
    j4, jmet4 = jax.jit(jax_make_train_step(jm, jopt, microbatches=4))(
        js, jp(0))
    t4, tmet4 = make_train_step(tm, topt, microbatches=4)(ts, tp(0))
    t1, tmet1 = make_train_step(tm, topt, microbatches=1)(ts, tp(0))
    _metrics_close(tmet4, jmet4)
    assert set(tmet4) == {"loss", "grad_norm", "lr"}
    np.testing.assert_allclose(float(tmet4["loss"]), float(tmet1["loss"]),
                               rtol=1e-5)
    _close_trees(t4.params, j4.params, PARAM_TOL)
    for path, p in tree_paths(t4.params).items():
        torch.testing.assert_close(p, tree_paths(t1.params)[path], atol=1e-4,
                                   rtol=1e-4, msg=path)


def test_train_step_leaves_its_input_state_as_it_was():
    jm, tm = _pair("llama3.2-1b")
    _, ts = _states(jm, JAdamW())
    before = {p: t.clone() for p, t in tree_paths(ts.params).items()}
    make_train_step(tm, AdamW())(ts, _pipes()[1](0))
    for path, t in tree_paths(ts.params).items():
        assert torch.equal(t, before[path]), path


def test_trainer_history_matches_jax():
    jm, tm = _pair("llama3.2-1b")
    jopt = JAdamW(learning_rate=jax_warmup_cosine(3e-3, 2, 6))
    topt = AdamW(learning_rate=warmup_cosine(3e-3, 2, 6))
    js, ts = _states(jm, jopt)
    jp, tp = _pipes()
    jcfg = JTrainerConfig(total_steps=6, log_every=1, checkpoint_every=100)
    tcfg = TrainerConfig(total_steps=6, log_every=1, checkpoint_every=100)
    js, jhist = JTrainer(jm, jopt, jp, jcfg).run(js)
    ts, thist = Trainer(tm, topt, tp, tcfg).run(ts)
    assert [s for s, _ in thist] == [s for s, _ in jhist] == list(range(1, 7))
    np.testing.assert_allclose([l for _, l in thist], [l for _, l in jhist],
                               rtol=1e-5)
    assert int(ts.step) == 6
    _close_trees(ts.params, js.params, PARAM_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_family_takes_a_train_step(arch):
    """Each family builds a train step from seeded port weights and takes
    one: finite metrics, every parameter leaf moved or its gradient 0."""
    from repro_torch.train import init_train_state
    model = build_model(PORT_ARCHS[arch].reduced())
    opt = AdamW(learning_rate=1e-3)
    state = init_train_state(model, opt, 0, device="cpu")
    batch = _pipes(arch=arch)[1](0)
    new, metrics = make_train_step(model, opt)(state, batch)
    assert int(new.step) == 1
    assert all(np.isfinite(float(v)) for v in metrics.values()), metrics
    moved = [not torch.equal(a, b) for a, b in zip(
        tree_paths(state.params).values(), tree_paths(new.params).values())]
    assert sum(moved) > 0.9 * len(moved), (arch, sum(moved), len(moved))


# ---------------------------------------------------------------------------
# the SSD's intra-chunk decay under autograd
# ---------------------------------------------------------------------------

def _ssd_case(arch_kw, s, dt_bias=None, seed=0):
    """The reference's seeded first Mamba2 layer of reduced mamba2-130m
    (with ``arch_kw``), its ``dt_bias`` set to ``dt_bias`` when given, and
    an input (2, s, D): (JAX cfg, port cfg, numpy params, numpy x)."""
    jm, tm = _pair("mamba2-130m", **arch_kw)
    jp = jm.init(jax.random.PRNGKey(seed))
    bp = jax.tree_util.tree_map(lambda a: np.asarray(a[0], np.float32),
                                jp["blocks"]["ssm"])
    if dt_bias is not None:
        bp["dt_bias"] = np.full_like(bp["dt_bias"], dt_bias)
    x = np.random.default_rng(seed).standard_normal(
        (2, s, tm.cfg.d_model)).astype(np.float32)
    return jm.cfg, tm.cfg, bp, x


def _ssd_port(cfg, bp, x, ct):
    """(output, {name: gradient} of params and x) of the port's block."""
    from repro_torch.models import ssm as PS
    params = {k: torch.from_numpy(v).requires_grad_() for k, v in bp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = PS.ssm_block(params, xt, cfg)
    grads = torch.autograd.grad((out * torch.from_numpy(ct)).sum(),
                                list(params.values()) + [xt])
    return out.detach(), dict(zip(list(params) + ["x"], grads))


def _ssd_reference_grads(cfg, bp, x, ct):
    from repro.models import ssm as JS
    g = jax.grad(lambda p, xx: (JS.ssm_block(p, xx, cfg) * ct).sum(),
                 argnums=(0, 1))(bp, x)
    return dict({k: np.asarray(v) for k, v in g[0].items()},
                x=np.asarray(g[1]))


def test_ssd_decay_masks_before_exp_where_the_chunk_overflows(monkeypatch):
    """A chunk of 64 at dt_bias 4: above the diagonal the sums of dt |A|
    pass 88.7 and exp overflows in f32.  The masked exp gives the
    where(causal, exp(seg), 0) forward bit for bit, and finite gradients
    where the where's backward (and the reference's) is NaN."""
    from repro_torch.models import ssm as PS
    jcfg, cfg, bp, x = _ssd_case(dict(ssm_chunk=64), 64, dt_bias=4.0)
    ct = np.random.default_rng(1).standard_normal(
        (2, 64, cfg.d_model)).astype(np.float32)
    out, grads = _ssd_port(cfg, bp, x, ct)
    assert all(torch.isfinite(g).all() for g in grads.values())
    monkeypatch.setattr(PS, "_intra_chunk_decay",
                        lambda seg, causal: torch.where(causal, torch.exp(seg),
                                                        0.0))
    seg_max = []
    real_exp = torch.exp
    monkeypatch.setattr(torch, "exp", lambda t: (seg_max.append(
        float(t.max())), real_exp(t))[1])
    where_out, where_grads = _ssd_port(cfg, bp, x, ct)
    monkeypatch.undo()
    assert max(seg_max) > 88.8, max(seg_max)        # the overflow is there
    assert torch.equal(out, where_out)
    assert any(torch.isnan(g).any() for g in where_grads.values())
    ref = _ssd_reference_grads(jcfg, bp, x, ct)
    assert any(np.isnan(g).any() for g in ref.values())


def test_ssd_gradients_match_jax_where_nothing_overflows():
    jcfg, cfg, bp, x = _ssd_case({}, 16)
    # a cotangent of the size the mean loss over the 2 x 16 tokens gives
    ct = (np.random.default_rng(1).standard_normal((2, 16, cfg.d_model))
          / 32).astype(np.float32)
    _, grads = _ssd_port(cfg, bp, x, ct)
    ref = _ssd_reference_grads(jcfg, bp, x, ct)
    for k, g in grads.items():
        assert np.isfinite(ref[k]).all(), k
        np.testing.assert_allclose(g.numpy(), ref[k], err_msg=k, **GRAD_TOL)


# ---------------------------------------------------------------------------
# a K-major head through updates and a checkpoint
# ---------------------------------------------------------------------------

def test_kmajor_head_stays_kmajor_through_adamw_and_a_checkpoint(tmp_path):
    """Reduced whisper at vocab 250 (not a multiple of 8): its ``lm_head``
    is K-major (the transpose of a contiguous (vocab, d_model) buffer),
    and stays so in the parameters, ``m``, ``v`` and ``master`` after two
    AdamW steps and after a checkpoint's save and restore, with the values
    of the same run from a row-major state, bit for bit."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.train import abstract_train_state, init_train_state
    arch = "whisper-large-v3"
    jm, tm = _pair(arch, vocab_size=250)
    d = tm.cfg.d_model
    assert tm.template["lm_head"].kmajor
    opt = AdamW(learning_rate=1e-3)
    js = jax_init_train_state(jm, JAdamW(), jax.random.PRNGKey(0))
    np_state = jax.tree_util.tree_map(np.asarray, js)
    kmaj = train_state_from_numpy(np_state, device="cpu",
                                  template=tm.template)
    rowm = train_state_from_numpy(np_state, device="cpu")
    assert rowm.params["lm_head"].is_contiguous()
    tp = _pipes(arch=arch, vocab=250)[1]
    step = make_train_step(tm, opt)

    def heads(state):
        return (state.params["lm_head"], state.opt.m["lm_head"],
                state.opt.v["lm_head"], state.opt.master["lm_head"])

    def leaves(state):
        """{name: leaf}, matched by path (a restored tree's dicts follow
        the template's key order)."""
        out = {"step": state.step, "count": state.opt.count}
        for name in ("params", "m", "v", "master"):
            tree = state.params if name == "params" else getattr(state.opt,
                                                                 name)
            out.update({f"{name}/{p}": t for p, t in tree_paths(tree).items()})
        return out

    def equal(a, b):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    assert all(h.stride() == (1, d) for h in heads(kmaj))
    # the port's own init, and a state whose optimizer trees are row-major
    # (as the bridge made them before): the update writes the layout back
    fresh = init_train_state(tm, opt, 0, device="cpu")
    mixed = kmaj._replace(opt=rowm.opt)
    for state in (fresh, step(fresh, tp(0))[0], step(mixed, tp(0))[0]):
        assert all(h.stride() == (1, d) for h in heads(state))
    for i in range(2):
        kmaj, _ = step(kmaj, tp(i))
        rowm, _ = step(rowm, tp(i))
    assert all(h.stride() == (1, d) for h in heads(kmaj))
    equal(leaves(kmaj), leaves(rowm))
    ck = Checkpointer(str(tmp_path))
    ck.save(2, kmaj)
    back = ck.restore(2, abstract_train_state(tm, opt), device="cpu")
    assert all(h.stride() == (1, d) for h in heads(back))
    equal(leaves(back), leaves(kmaj))
    again, _ = step(back, tp(2))
    more, _ = step(kmaj, tp(2))
    assert all(h.stride() == (1, d) for h in heads(again))
    equal(leaves(again), leaves(more))


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(REPO)},
        capture_output=True, text=True, timeout=300)


def test_launcher_trains_on_the_cpu_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    common = ["--arch", "llama3.2-1b", "--reduced", "--seq-len", "16",
              "--batch", "2", "--device", "cpu", "--ckpt-dir", ck]
    full = _launch(*common, "--steps", "20", "--ckpt-every", "10", "--stats")
    assert full.returncode == 0, full.stderr
    lines = full.stdout.splitlines()
    assert lines[0].startswith("[hw] profile=")
    assert any(l.startswith("[tuned] ") for l in lines)
    assert "done at step 20" in lines
    assert any(l.startswith("[stats] ") and "tok/s" in l for l in lines)
    losses = [l for l in lines if l.startswith("step ")]
    assert len(losses) == 2
    # resume from step 20's checkpoint (keep 3: steps 10 and 20) to step 30
    more = _launch(*common, "--steps", "30", "--resume")
    assert more.returncode == 0, more.stderr
    assert "resumed from step 20" in more.stdout
    assert "done at step 30" in more.stdout


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_launcher_trains_the_ssm_and_hybrid_families(arch):
    res = _launch("--arch", arch, "--reduced", "--seq-len", "16", "--batch",
                  "2", "--device", "cpu", "--steps", "10", "--stats")
    assert res.returncode == 0, res.stderr
    assert f"family={PORT_ARCHS[arch].family}" in res.stdout
    assert "done at step 10" in res.stdout
    assert any(l.startswith("step     10  loss ")
               for l in res.stdout.splitlines()), res.stdout


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-large-v3"])
def test_launcher_refuses_vlm_and_audio(arch):
    res = _launch("--arch", arch, "--reduced", "--device", "cpu", "--steps",
                  "1")
    assert res.returncode != 0
    assert "beside the tokens" in res.stderr, res.stderr


def test_launcher_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = _launch("--arch", "llama3.2-1b", "--reduced", "--steps", "1")
    assert res.returncode != 0
    assert "no CUDA device available" in res.stderr


# ---------------------------------------------------------------------------
# the flash kernel has no gradient
# ---------------------------------------------------------------------------

def test_flash_attention_refuses_autograd():
    """K2 has no backward (nor has the reference's): under grad it raises
    instead of returning a tensor autograd cannot see, and it does not fall
    back to the chunked path."""
    from repro_torch.core import flash_attention
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 6, 4, 8, generator=gen, requires_grad=True)
    k = torch.randn(1, 6, 2, 8, generator=gen)
    v = torch.randn(1, 6, 2, 8, generator=gen)
    with pytest.raises(RuntimeError, match="no gradient.*chunked"):
        flash_attention(q, k, v)
    with torch.no_grad():
        assert flash_attention(q, k, v).shape == (1, 6, 4, 8)
    assert flash_attention(q.detach(), k, v).grad_fn is None


def test_training_forward_with_flash_attention_raises():
    jm, tm = _pair("llama3.2-1b", attention_impl="flash")
    _, ts = _states(jm, JAdamW())
    with pytest.raises(RuntimeError, match="attention_impl='chunked'"):
        _value_and_grad(tm, ts.params, _pipes()[1](0))
