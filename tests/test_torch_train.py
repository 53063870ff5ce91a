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
ARCHS = ["llama3.2-1b", "olmoe-1b-7b"]
B, S = 4, 16


def _jax_paths(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path):
            np.asarray(v, np.float32)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close_trees(torch_tree, jax_tree, tol):
    want = _jax_paths(jax_tree)
    got = tree_paths(torch_tree)
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    for path, t in got.items():
        np.testing.assert_allclose(t.float().numpy(), want[path], err_msg=path,
                                   **tol)


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


# ---------------------------------------------------------------------------
# loss and train step
# ---------------------------------------------------------------------------

def _pair(arch, **kw):
    jcfg = dataclasses.replace(ARCHITECTURES[arch].reduced(), **kw)
    tcfg = dataclasses.replace(PORT_ARCHS[arch].reduced(), **kw)
    return jax_build_model(jcfg), build_model(tcfg)


def _pipes(seq=S, batch=B):
    return (JTokenPipeline(JDataConfig(vocab_size=256, seq_len=seq,
                                       global_batch=batch)),
            TokenPipeline(DataConfig(vocab_size=256, seq_len=seq,
                                     global_batch=batch), device="cpu"))


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
    jp, tp = _pipes()
    (jl, jmet), jg = jax.value_and_grad(
        lambda p, b: jax_lm_loss(jm, p, b), has_aux=True)(js.params, jp(0))
    tl, tmet, tg = _value_and_grad(tm, ts.params, tp(0))
    np.testing.assert_allclose(float(tl), float(jl), **METRIC_TOL)
    if arch.startswith("olmoe"):
        assert float(tmet["moe_aux"]) > 0
    for k in jmet:
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                   err_msg=k, **METRIC_TOL)
    _close_trees(tg, jg, GRAD_TOL)


def test_remat_gives_the_same_gradients():
    """``cfg.remat`` (policy full) recomputes each block in the backward:
    the same gradients as without, and as the reference's remat."""
    jm, tm = _pair("llama3.2-1b", remat=True)
    js, ts = _states(jm, JAdamW())
    jp, tp = _pipes()
    _, jg = jax.value_and_grad(lambda p, b: jax_lm_loss(jm, p, b),
                               has_aux=True)(js.params, jp(0))
    _, _, tg = _value_and_grad(tm, ts.params, tp(0))
    _, plain = _pair("llama3.2-1b")
    _, _, pg = _value_and_grad(plain, ts.params, tp(0))
    _close_trees(tg, jg, GRAD_TOL)
    for path, g in tree_paths(pg).items():
        torch.testing.assert_close(tree_paths(tg)[path], g, atol=0, rtol=0,
                                   msg=path)


def test_dots_remat_policy_is_refused_under_grad():
    jm, tm = _pair("llama3.2-1b", remat=True, remat_policy="dots")
    _, ts = _states(jm, JAdamW())
    with pytest.raises(NotImplementedError, match="dots"):
        _value_and_grad(tm, ts.params, _pipes()[1](0))


def _metrics_close(tm_, jm_):
    assert set(tm_) == set(jm_), (sorted(tm_), sorted(jm_))
    for k in jm_:
        np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), err_msg=k,
                                   **METRIC_TOL)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch, steps):
    jm, tm = _pair(arch)
    jopt = JAdamW(learning_rate=jax_warmup_cosine(1e-3, 2, 4))
    topt = AdamW(learning_rate=warmup_cosine(1e-3, 2, 4))
    js, ts = _states(jm, jopt)
    jstep = jax.jit(jax_make_train_step(jm, jopt))
    tstep = make_train_step(tm, topt)
    jp, tp = _pipes()
    for i in range(steps):
        js, jmet = jstep(js, jp(i))
        ts, tmet = tstep(ts, tp(i))
        _metrics_close(tmet, jmet)
    assert int(ts.step) == steps and int(ts.opt.count) == steps
    _close_trees(ts.params, js.params, PARAM_TOL)
    _close_trees(ts.opt.master, js.opt.master, PARAM_TOL)
    _close_trees(ts.opt.m, js.opt.m, GRAD_TOL)


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


def test_other_families_refuse_to_train():
    for arch in ("mamba2-130m", "whisper-large-v3"):
        with pytest.raises(NotImplementedError, match="not ported"):
            make_train_step(build_model(PORT_ARCHS[arch].reduced()), AdamW())


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
