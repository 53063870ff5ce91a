"""The port's per-token-sync baseline (``serve/reference.py``:
``PerTokenSyncEngine``, ``generate_per_token_sync``) against the JAX
package's on the same bridged weights, and its own contracts: one host copy
of the current tokens a decoded step, ``eos_token`` per row, uniform prompt
lengths, the prefill/decode split and the profiler markers.

Reduced configs in float32: tokens are compared exactly, also with the
port's per-prompt oracle.  The reference's engine feeds tokens only
(``src/repro/serve/reference.py:121-124``), so it serves the families with
no extra inputs; the vlm and audio families fail alike in both without
them.  The data=4,model=2 mesh leg runs in ``tests/test_torch_distributed.py``
(the 8-rank run).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.catalog import ARCHITECTURES  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serve import PerTokenSyncEngine as JaxSync  # noqa: E402
from repro_torch.configs.catalog import ARCHITECTURES as PORT_ARCHS  # noqa: E402
from repro_torch.models import build_model, params_from_numpy  # noqa: E402
from repro_torch.serve import (PerTokenSyncEngine,  # noqa: E402
                               generate_per_prompt, generate_per_token_sync)
from repro_torch.serve import reference  # noqa: E402

#: the families the reference's sync engine serves (tokens only)
ARCHS = ["llama3.2-1b", "olmoe-1b-7b", "mamba2-130m", "zamba2-2.7b"]
MAX_LEN, MAX_NEW = 64, 10


def _prompts(vocab: int, n: int = 4, plen: int = 16):
    """The serving suite's traffic, ``(7i + j) % vocab``
    (``benchmarks/serving.py:45-47``), at a reduced count and length."""
    return [[(7 * i + j) % vocab for j in range(plen)] for i in range(n)]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, the reference's engine, port model, port params): the port's
    weights bridged from the reference's.  The reference's engine is made
    once (it compiles its steps per instance)."""
    arch = request.param
    jmodel = jax_build_model(ARCHITECTURES[arch].reduced())
    jparams = jmodel.init(jax.random.PRNGKey(2))
    pmodel = build_model(PORT_ARCHS[arch].reduced())
    pparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu", template=pmodel.template)
    return arch, JaxSync(jmodel, jparams, MAX_LEN), pmodel, pparams


def test_tokens_equal_the_references_and_the_oracles(pair):
    arch, jeng, pmodel, pparams = pair
    prompts = _prompts(pmodel.cfg.vocab_size)
    want = jeng.generate(prompts, MAX_NEW)
    got = PerTokenSyncEngine(pmodel, pparams, MAX_LEN).generate(prompts,
                                                                MAX_NEW)
    assert got == want, arch
    assert all(len(o) == MAX_NEW for o in got)
    assert got == generate_per_prompt(pmodel, pparams, prompts, MAX_NEW,
                                      max_len=MAX_LEN)
    assert generate_per_token_sync(pmodel, pparams, prompts, MAX_NEW,
                                   max_len=MAX_LEN) == got


def test_eos_stops_each_row_as_the_reference(pair):
    """Each row stops at its own eos (kept as its last token); the loop
    runs on while any row is live."""
    arch, jeng, pmodel, pparams = pair
    prompts = _prompts(pmodel.cfg.vocab_size)
    free = PerTokenSyncEngine(pmodel, pparams, MAX_LEN).generate(prompts,
                                                                 MAX_NEW)
    eos = free[0][3]
    jeng.eos_token = eos          # read on the host only, never compiled
    try:
        want = jeng.generate(prompts, MAX_NEW)
    finally:
        jeng.eos_token = None
    got = generate_per_token_sync(pmodel, pparams, prompts, MAX_NEW,
                                  max_len=MAX_LEN, eos_token=eos)
    assert got == want, arch
    for row, full in zip(got, free):
        cut = full.index(eos) + 1 if eos in full else len(full)
        assert row == full[:cut]


def test_ragged_prompts_raise_the_references_value_error():
    jmodel = jax_build_model(ARCHITECTURES["llama3.2-1b"].reduced())
    pmodel = build_model(PORT_ARCHS["llama3.2-1b"].reduced())
    jparams = jmodel.init(jax.random.PRNGKey(2))
    pparams = pmodel.init(0, device="cpu")
    ragged = [[1, 2, 3], [4, 5], [6, 7, 8]]
    with pytest.raises(ValueError) as want:
        JaxSync(jmodel, jparams, MAX_LEN).generate(ragged, 3)
    with pytest.raises(ValueError) as got:
        PerTokenSyncEngine(pmodel, pparams, MAX_LEN).generate(ragged, 3)
    assert str(got.value) == str(want.value)
    assert "uniform prompt lengths, got [2, 3]" in str(got.value)


@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b",
                                  "whisper-large-v3"])
def test_extra_input_families_fail_alike_without_their_inputs(arch):
    jmodel = jax_build_model(ARCHITECTURES[arch].reduced())
    pmodel = build_model(PORT_ARCHS[arch].reduced())
    (name,) = pmodel.extra_inputs(1)
    prompts = _prompts(pmodel.cfg.vocab_size, n=2, plen=4)
    with pytest.raises(KeyError, match=name):
        JaxSync(jmodel, jmodel.init(jax.random.PRNGKey(2)),
                MAX_LEN).generate(prompts, 2)
    with pytest.raises(KeyError, match=name):
        PerTokenSyncEngine(pmodel, pmodel.init(0, device="cpu"),
                           MAX_LEN).generate(prompts, 2)


@pytest.fixture(scope="module")
def llama():
    model = build_model(PORT_ARCHS["llama3.2-1b"].reduced())
    return model, model.init(0, device="cpu")


@pytest.mark.parametrize("profile", [True, False])
def test_prefill_and_decode_split_is_recorded(llama, profile):
    model, params = llama
    eng = PerTokenSyncEngine(model, params, MAX_LEN, profile=profile)
    assert (eng.last_prefill_s, eng.last_decode_s) == (0.0, 0.0)
    eng.generate(_prompts(model.cfg.vocab_size), MAX_NEW)
    assert eng.last_prefill_s > 0 and eng.last_decode_s > 0
    assert eng.mesh is None and eng.rules is None
    assert eng.device == torch.device("cpu")


def test_one_host_copy_and_one_decode_marker_per_step(llama, monkeypatch):
    """The current tokens reach the host once a decoded token; each step
    but the last runs one ``decode_step`` inside ``reference.decode``."""
    model, params = llama
    copies, labels = [], []
    real_cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k: (
        copies.append(tuple(self.shape)), real_cpu(self, *a, **k))[1])
    real_annotate = reference.annotate

    def noted(label):
        labels.append(label)
        return real_annotate(label)
    monkeypatch.setattr(reference, "annotate", noted)
    prompts = _prompts(model.cfg.vocab_size)
    out = PerTokenSyncEngine(model, params, MAX_LEN).generate(prompts,
                                                              MAX_NEW)
    assert copies == [(len(prompts),)] * MAX_NEW
    assert labels == ["reference.prefill"] + ["reference.decode"] * (
        MAX_NEW - 1)
    assert all(len(o) == MAX_NEW for o in out)
    copies.clear()
    labels.clear()
    assert PerTokenSyncEngine(model, params, MAX_LEN).generate(
        prompts, 0) == [[] for _ in prompts]
    assert copies == [] and labels == ["reference.prefill"]
