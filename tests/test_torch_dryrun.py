"""The port's dry run on one device (``repro_torch.launch.specs``,
``dryrun.lower_cell``, ``step_stats``) against the reference's.

* Every (arch x shape) cell's inputs have the shapes and dtypes of the
  reference's ``launch/specs.py::input_specs``, leaf for leaf.
* For the (arch, kind) pairs of the reference's
  ``test_mini_dryrun_compiles_on_8dev_mesh`` (reduced configs in f32, 8 x
  16 tokens) and llama's prefill and decode, the port's product flops
  equal ``analyze_hlo(...).flops`` of the reference's step lowered on one
  device, exactly (tolerance 0: both count 2 * numel(out) * K a product;
  K1's ``repro_torch::gemm`` once, its plain version's inner product not
  again).
* The count on fake tensors equals the count on real CPU tensors.

The meshed cases run in subprocesses (``tests/test_torch_dryrun_mesh.py``):
the fake process group is process-wide.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import base as ref_base  # noqa: E402
from repro.configs.catalog import ARCHITECTURES as REF_ARCHS  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.launch.hlo_stats import analyze_hlo  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.optim.adamw import AdamW as RefAdamW  # noqa: E402
from repro.train import trainer as ref_trainer  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.catalog import get_config  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.dryrun import lower_cell  # noqa: E402

#: the reference's one-device HLO flops of each pair (reduced, f32, 8 x 16)
REF_FLOPS = {
    ("llama3.2-1b", "train"): 72_351_744,
    ("llama3.2-1b", "prefill"): 20_185_088,
    ("llama3.2-1b", "decode"): 1_507_328,
    ("olmoe-1b-7b", "train"): 186_384_384,
    ("mamba2-130m", "decode"): 1_196_032,
    ("zamba2-2.7b", "prefill"): 119_668_736,
    ("whisper-large-v3", "decode"): 1_572_864,
    ("llama-3.2-vision-11b", "train"): 305_659_904,
}
#: the reference's test_mini_dryrun_compiles_on_8dev_mesh pairs
MINI_PAIRS = [("llama3.2-1b", "train"), ("olmoe-1b-7b", "train"),
              ("mamba2-130m", "decode"), ("zamba2-2.7b", "prefill"),
              ("whisper-large-v3", "decode"),
              ("llama-3.2-vision-11b", "train")]
SHAPE = dict(seq_len=16, global_batch=8)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{path}/{k}"))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{path}/{i}"))
        return out
    return {path: tree}


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
@pytest.mark.parametrize("shape", sorted(ref_base.SHAPES))
def test_input_specs_match_the_references(arch, shape):
    """Kind, and every leaf's path, shape and dtype: batch, extra inputs
    (vlm image embeddings, whisper frames), the cache at the cell's
    length, decode tokens and offset."""
    rk, rspec = ref_specs.input_specs(REF_ARCHS[arch], ref_base.SHAPES[shape])
    pk, pspec = specs.input_specs(get_config(arch), base.SHAPES[shape])
    assert pk == rk
    want = {p: (tuple(x.shape), str(x.dtype))
            for p, x in _leaves(rspec).items()}
    got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in _leaves(pspec).items()}
    assert got == want
    assert all(x.device.type == "meta" for x in _leaves(pspec).values())


def _cfgs(arch):
    ref = dataclasses.replace(REF_ARCHS[arch].reduced(), dtype="float32")
    port = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    return ref, port


def _ref_flops(arch, kind):
    """``analyze_hlo`` flops of the reference's step lowered on one device
    (no mesh: the reference's meshed lowering fails on this host)."""
    cfg, _ = _cfgs(arch)
    shape = ref_base.ShapeSpec("t", kind=kind, **SHAPE)
    model = ref_build_model(cfg)
    k, sp = ref_specs.input_specs(cfg, shape)
    if k == "train":
        opt = RefAdamW(learning_rate=1e-4)
        lowered = jax.jit(ref_trainer.make_train_step(model, opt)).lower(
            ref_trainer.abstract_train_state(model, opt), sp["batch"])
    elif k == "prefill":
        lowered = jax.jit(ref_trainer.make_prefill_step(model)).lower(
            model.abstract(), sp["batch"], sp["cache"])
    else:
        lowered = jax.jit(ref_trainer.make_decode_step(model)).lower(
            model.abstract(), sp["tokens"], sp["cache"], sp["offset"])
    return analyze_hlo(lowered.compile().as_text()).flops


@functools.lru_cache(maxsize=None)
def _port(arch, kind, fake=True):
    _, cfg = _cfgs(arch)
    return lower_cell(cfg, base.ShapeSpec("t", kind=kind, **SHAPE),
                      fake=fake)


@pytest.mark.parametrize("arch,kind", sorted(REF_FLOPS))
def test_one_device_flops_equal_the_references(arch, kind):
    stats, meta = _port(arch, kind)
    want = _ref_flops(arch, kind)
    assert want == REF_FLOPS[(arch, kind)]
    assert stats.flops == want                      # tolerance 0
    assert stats.flops_by_dtype == {"float32": want}
    assert meta["kind"] == kind
    if kind == "train":
        # K1's forward products as the torch.library op, each counted once
        assert stats.op_histogram["repro_torch.gemm"] > 0
    else:
        # no autograd: K1 as one unit a product, its plain version unseen
        assert "repro_torch.gemm" in stats.op_histogram
        assert "aten.mm" not in stats.op_histogram


def test_llama_train_counts_each_k1_product_once():
    """72,351,744 = the 15 forward products (the op) and their 30
    backward ones (dX, dW, K1's units), with no inner ``aten.mm`` counted
    beside them, and the attention's 4 einsums (QK^T, PV; 2 layers) with
    their 8 backward products: 57 products, the reference HLO's dots."""
    stats, _ = _port("llama3.2-1b", "train")
    assert stats.flops == 72_351_744
    assert stats.op_histogram["repro_torch.gemm"] == 15 * 3
    assert "aten.mm" not in stats.op_histogram
    assert stats.dot_count == 15 * 3 + 4 * 3 == 57


@pytest.mark.parametrize("arch,kind", MINI_PAIRS)
def test_fake_count_equals_the_count_on_real_cpu_tensors(arch, kind):
    """The same step on real CPU tensors: equal flops (by dtype), product
    count, peak bytes and collectives; bytes within 1e-3 (``F.one_hot``'s
    CPU kernel checks its ids' range, its fake version compares against an
    ``arange``: olmoe's routing issues a few other ops)."""
    fake, fmeta = _port(arch, kind)
    real, rmeta = _port(arch, kind, fake=False)
    assert real.flops == fake.flops == REF_FLOPS[(arch, kind)]
    assert real.flops_by_dtype == fake.flops_by_dtype
    assert real.dot_count == fake.dot_count
    assert real.peak_bytes == fake.peak_bytes
    assert rmeta["memory"] == fmeta["memory"]
    assert real.collective_count == fake.collective_count == 0
    assert real.traffic_bytes == pytest.approx(fake.traffic_bytes, rel=1e-3)


def test_memory_record_holds_the_arguments_and_the_step():
    """``argument_bytes`` is the state and inputs exactly (params, AdamW's
    f32 m, v, master, step, count; tokens and labels), the peak at least
    that plus the new state the step returns."""
    stats, meta = _port("llama3.2-1b", "train")
    _, cfg = _cfgs("llama3.2-1b")
    from repro_torch.models import build_model
    n = build_model(cfg).param_count()
    tokens = 2 * 8 * 16 * 4
    want = n * 4 * 4 + 4 + 4 + tokens
    assert meta["memory"]["argument_bytes"] == want
    assert meta["memory"]["peak_bytes"] == stats.peak_bytes
    assert stats.peak_bytes >= want + n * 4 * 4


def test_flash_calls_are_counted_as_k2_would_run_them():
    """attention_impl="flash" on a prefill: each call's 4 d H B pairs,
    the causal pairs as ``chip_smoke.py``'s ``flash_bound`` counts them."""
    from repro_torch.launch.step_stats import flash_pairs
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              attention_impl="flash")
    stats, _ = lower_cell(cfg, base.ShapeSpec("t", 16, 8, "prefill"))
    h, d = cfg.num_heads, cfg.resolved_head_dim
    assert stats.flash_calls == cfg.num_layers
    assert flash_pairs(16, 16, True) == 16 * 17 // 2
    assert stats.flash_flops == cfg.num_layers * 4 * d * h * 8 * 136
    assert stats.op_histogram["repro_torch.flash_attention"] == \
        cfg.num_layers
    # the unit moves q, k, v and writes o (plus kv_start when given)
    assert stats.traffic_bytes > 0
