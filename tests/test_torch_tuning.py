"""The port's tuning framework (``repro_torch.core``: hardware profiles,
registry, tuning DB, cost model, tuner) against the JAX package's on the
same inputs, the port's own registry rules, the committed ``h100`` table,
and the engine, launcher and CLI that use them.  CPU only: measured sweeps
need the card (``tests/test_torch_cuda.py``).

Cost-model numbers are compared to 1e-12 relative (the same formulas in
double precision); registry distances to 1e-12 absolute.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cost_model as ref_cost  # noqa: E402
from repro.core import hardware as ref_hw  # noqa: E402
from repro.core import registry as ref_registry  # noqa: E402
from repro.core import tile_config as ref_tc  # noqa: E402
from repro.core import tuning_db as ref_db  # noqa: E402
from repro_torch.core import cost_model, hardware, registry, tuner, tuning_db  # noqa: E402
from repro_torch.core.tile_config import (  # noqa: E402
    DecodeLoopConfig, FlashAttentionConfig, PagedAttentionConfig, TileConfig,
    block_of, config_from_block, flash_tiles, gemm_tiles)
from repro_torch.kernels.flash_attention import instantiated_head_dims  # noqa: E402
from repro_torch.kernels.gemm import KERNEL_CODES, instantiated_schedules  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
H100_JSON = REPO / "src" / "repro_torch" / "tuned" / "h100.json"
REF_DTYPE = {"bfloat16": jnp.bfloat16, "float32": jnp.float32}

#: the reference's profile built with the h100 profile's numbers
REF_H100 = ref_hw.HardwareProfile(
    name="h100", platform="gpu", peak_flops=dict(hardware.H100.peak_flops),
    hbm_bandwidth=hardware.H100.hbm_bandwidth,
    vmem_bytes=hardware.H100.smem_bytes, ici_link_bandwidth=450e9,
    hbm_bytes=hardware.H100.hbm_bytes, mxu_dim=hardware.H100.mxu_dim,
    sublane=hardware.H100.sublane)

WGMMA = sorted(TileConfig(bm, bk, bn, kernel="wgmma", stages=st, group_m=g)
               for bm, bk, bn, st in instantiated_schedules()["wgmma"]
               for g in (1, 8))
#: flash schedules instantiated at both d 64 and d 128
FLASH_64_128 = sorted(
    FlashAttentionConfig(bq, bk, kernel="wgmma", stages=st)
    for (bq, bk, st), dims in instantiated_head_dims()["wgmma"].items()
    if 64 in dims and 128 in dims)

#: the serving GEMM shapes of llama3.2-1b (decode, keyed at M = 16; prefill
#: at the 12 requests' buckets, 8 x 256 and 8 x 512) and its flash buckets
LLAMA_GEMMS = [(m, k, n) for m in (16, 2048, 4096) for k, n in (
    (2048, 2048), (2048, 512), (2048, 8192), (8192, 2048))] + [
    (16, 2048, 128256)]
LLAMA_FLASH = [(256, 256, 64), (512, 512, 64)]


# ---------------------------------------------------------------------------
# registry: the reference's tiers on the same entries and queries
# ---------------------------------------------------------------------------

def _ref_cfg(op, i):
    """An injective stand-in config for the reference's registry."""
    return {"gemm": ref_tc.TileConfig(i + 1, i + 1, i + 1),
            "flash_attention": ref_tc.FlashAttentionConfig(i + 1, i + 1),
            "paged_attn": ref_tc.PagedAttentionConfig(i + 1)}[op]


REGISTRY_CASES = {
    "gemm": (WGMMA, [(256, 2048, 2048), (2048, 2048, 512), (4096, 8192, 2048),
                     (1024, 1024, 1024), (8192, 1280, 5120)],
             [(m, k, n) for m in (17, 64, 256, 1000, 2048, 8192, 1 << 16)
              for k in (512, 2048, 8192) for n in (64, 512, 2048, 32000)]),
    "flash_attention": (FLASH_64_128,
                        [(256, 256, 64), (1024, 1024, 64), (512, 512, 128),
                         (4096, 4096, 128)],
                        [(s, t, d) for s in (8, 64, 256, 300, 1024, 8192)
                         for t in (s, 2 * s) for d in (64, 128)]),
    "paged_attn": ([PagedAttentionConfig(p) for p in (8, 16, 32, 64)],
                   [(8, 1024), (4, 256), (16, 4096)],
                   [(b, n) for b in (1, 4, 8, 32) for n in (64, 512, 1024,
                                                            1 << 15)]),
}


@pytest.mark.parametrize("op", sorted(REGISTRY_CASES))
@pytest.mark.parametrize("generic", [False, True])
def test_registry_tiers_match_reference(op, generic, monkeypatch):
    monkeypatch.setitem(ref_hw.HARDWARE, "h100", REF_H100)
    configs, entries, queries = REGISTRY_CASES[op]
    port = registry.TileRegistry()
    ref = ref_registry.TileRegistry(autoload=False)
    back = {}
    for i, shape in enumerate(entries):
        cfg = configs[i % len(configs)]
        port.put_op(op, cfg, "h100", torch.bfloat16, shape)
        ref.put_op(op, _ref_cfg(op, i), "h100", jnp.bfloat16, shape)
        back[_ref_cfg(op, i)] = cfg
    if generic:
        port.put_op(op, configs[0], "h100", torch.bfloat16)
        ref.put_op(op, _ref_cfg(op, 99), "h100", jnp.bfloat16)
        back[_ref_cfg(op, 99)] = configs[0]
    sources = set()
    for shape in queries:
        got = port.lookup_op(op, "h100", torch.bfloat16, shape)
        want = ref.lookup_op(op, "h100", jnp.bfloat16, shape)
        sources.add(got.source)
        assert got.source == want.source, shape
        assert got.matched_shape == want.matched_shape, shape
        assert math.isclose(got.distance, want.distance, abs_tol=1e-12)
        if want.source in ("exact", "nearest", "generic"):
            assert got.config == back[want.config], shape
    assert {"exact", "nearest"} <= sources
    assert ("generic" in sources) is generic


# ---------------------------------------------------------------------------
# the port's rules a-c
# ---------------------------------------------------------------------------

DECODE = TileConfig(16, 128, 64, kernel="decode", stages=5, split_k=4)


@pytest.mark.parametrize("m", [1, 2, 8, 15, 16, 17])
def test_rule_a_decode_regime_is_one_key(m):
    reg = registry.TileRegistry()
    reg.put_op("gemm", DECODE, "h100", torch.bfloat16, (8, 2048, 2048))
    res = reg.lookup_op("gemm", "h100", torch.bfloat16, (m, 2048, 2048))
    if m <= 16:
        assert (res.source, res.config) == ("exact", DECODE)
        assert res.matched_shape == (16, 2048, 2048)
    else:
        # M = 17 is the wgmma regime: the decode entry is not served
        assert res.source == "default"
        assert res.config == gemm_tiles(torch.bfloat16, 17, 2048, 2048)
        assert res.config.kernel == "wgmma"
    # f32 keeps M as it is
    reg.put_op("gemm", TileConfig(16, 16, 128, kernel="fma"), "h100",
               torch.float32, (8, 64, 64))
    assert reg.lookup_op("gemm", "h100", torch.float32,
                         (8, 64, 64)).source == "exact"
    assert reg.lookup_op("gemm", "h100", torch.float32,
                         (16, 64, 64)).source == "nearest"


def test_rule_b_no_tier_serves_a_schedule_the_wrapper_refuses():
    reg = registry.TileRegistry()
    for shape in ((8, 2048, 2048), (8, 2048, 8192), (8, 8192, 2048)):
        reg.put_op("gemm", DECODE, "h100", torch.bfloat16, shape)
    reg.put_op("gemm", DECODE, "h100", torch.bfloat16)            # generic
    for m in (17, 32, 64, 256, 2048):
        for k, n in ((2048, 2048), (2048, 8192), (8192, 2048)):
            res = reg.lookup_op("gemm", "h100", torch.bfloat16, (m, k, n))
            assert res.config.kernel == "wgmma" and res.source == "default"
    # a wgmma entry is not served to the decode regime, an f32 one to bf16
    reg.put_op("gemm", WGMMA[0], "h100", torch.bfloat16, (32, 2048, 512))
    assert reg.lookup_op("gemm", "h100", torch.bfloat16,
                         (8, 2048, 512)).config.kernel == "decode"
    # a schedule no dispatch line instantiates is skipped at its own shape
    ghost = dataclasses.replace(DECODE, stages=7)
    reg.put_op("gemm", ghost, "h100", torch.bfloat16, (8, 1024, 1024))
    res = reg.lookup_op("gemm", "h100", torch.bfloat16, (8, 1024, 1024))
    assert res.config != ghost and res.source == "nearest"
    # flash: a d-64-only schedule is never served at d 80 or 128
    d64 = FlashAttentionConfig(64, 64, kernel="wgmma", stages=3)
    assert instantiated_head_dims()["wgmma"][(64, 64, 3)] == (64,)
    reg.put_op("flash_attention", d64, "h100", torch.bfloat16, (256, 256, 64))
    reg.put_op("flash_attention", d64, "h100", torch.bfloat16)
    assert reg.lookup_op("flash_attention", "h100", torch.bfloat16,
                         (256, 256, 64)).source == "exact"
    for d in (80, 128, 160):
        res = reg.lookup_op("flash_attention", "h100", torch.bfloat16,
                            (256, 256, d))
        assert res.source == "default"
        assert res.config == flash_tiles(torch.bfloat16, 256, 256, d)
    assert registry.takes("flash_attention", "bfloat16", (256, 256, 80),
                          res.config) or d == 160


def test_rule_c_resolutions_are_cached_and_cleared():
    reg = registry.TileRegistry()
    shape = (8, 2048, 512)
    first = reg.lookup_op("gemm", "h100", torch.bfloat16, shape)
    again = reg.lookup_op("gemm", "h100", torch.bfloat16, list(shape))
    assert first is again and first.source == "default"
    assert reg.hit_stats == {"default": 1}        # resolutions, not calls
    reg.put_op("gemm", DECODE, "h100", torch.bfloat16, shape)
    res = reg.lookup_op("gemm", "h100", torch.bfloat16, shape)
    assert (res.source, res.config) == ("exact", DECODE)
    assert reg.hit_stats == {"default": 1, "exact": 1}
    reg.clear()
    assert reg.lookup_op("gemm", "h100", torch.bfloat16,
                         shape).source == "default"


def test_rule_c_load_clears_the_cache(tmp_path):
    reg = registry.TileRegistry()
    shape = (8, 2048, 8192)
    assert reg.lookup_op("gemm", "h100", "bfloat16", shape).source == "default"
    db = tuning_db.TuningDB("h100")
    db.add(tuning_db.TuningRecord("bfloat16", shape, block_of(DECODE)))
    db.save(str(tmp_path / "h100.json"))
    assert tuning_db.load_all(reg, str(tmp_path)) == {
        str(tmp_path / "h100.json"): 1}
    assert reg.lookup_op("gemm", "h100", "bfloat16", shape).config == DECODE


# ---------------------------------------------------------------------------
# hardware profiles and the default tier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_h100_default_tier_is_the_hand_table(dtype):
    reg = registry.TileRegistry()
    for m in (1, 8, 16, 17, 256, 4096):
        for k, n in ((2048, 2048), (2048, 512), (8192, 2048), (768, 3352),
                     (2048, 128256)):
            res = reg.lookup_op("gemm", "h100", dtype, (m, k, n))
            assert res.source == "default"
            assert res.config == gemm_tiles(dtype, m, k, n)
    for s in (8, 256, 1024, 4096):
        for d in (16, 64, 80, 128, 160):
            res = reg.lookup_op("flash_attention", "h100", dtype, (s, s, d))
            assert res.config == flash_tiles(dtype, s, s, d)
    res = reg.lookup_op("paged_attn", "h100", dtype, (8, 1024))
    assert (res.source, res.config) == ("fallback", PagedAttentionConfig(16))


def test_cpu_profile_has_no_tiles_and_unknown_hardware_warns_once():
    reg = registry.TileRegistry()
    res = reg.lookup_op("gemm", "cpu", torch.float32, (8, 64, 64))
    # no default tier: the fallback is the kernels' hand table
    assert res.source == "fallback"
    assert res.config == gemm_tiles(torch.float32, 8, 64, 64)
    registry._WARNED_UNKNOWN_HARDWARE.discard("a100-typo")
    with pytest.warns(UserWarning, match="unknown hardware 'a100-typo'"):
        res = reg.lookup_op("gemm", "a100-typo", torch.bfloat16, (8, 64, 64))
    assert res.source == "fallback"
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        reg.lookup_op("gemm", "a100-typo", torch.bfloat16, (8, 64, 128))


@pytest.mark.parametrize("hw_name", ["cpu", "a100-typo"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fallback_tier_serves_only_schedules_the_wrapper_takes(hw_name, dtype):
    """A CUDA tensor served under a profile with no default tier (or an
    unknown name) runs the hand tables, never a schedule the wrapper would
    refuse or a slower kernel than the regime's (rule b)."""
    import warnings
    reg = registry.TileRegistry()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for shape in ((1, 2048, 2048), (8, 2048, 128256), (17, 2048, 512),
                      (2048, 2048, 8192)):
            res = reg.lookup_op("gemm", hw_name, dtype, shape)
            assert res.source == "fallback"
            assert res.config == gemm_tiles(dtype, *shape)
            assert registry.takes("gemm", dtype, shape, res.config), shape
        for shape in ((256, 256, 64), (512, 512, 80), (4096, 4096, 128),
                      (256, 256, 160)):
            res = reg.lookup_op("flash_attention", hw_name, dtype, shape)
            assert res.source == "fallback"
            assert res.config == flash_tiles(dtype, *shape)
            assert registry.takes("flash_attention", dtype, shape,
                                  res.config), shape


def test_hardware_detection_order(monkeypatch):
    monkeypatch.delenv(hardware.HARDWARE_ENV, raising=False)
    assert hardware.detect_hardware("cpu") == "cpu"
    assert hardware.resolve_hardware("nvidia-h100") == "h100"
    assert hardware.resolve_hardware(None, torch.device("cpu")) == "cpu"
    monkeypatch.setenv(hardware.HARDWARE_ENV, "h100")
    assert hardware.detect_hardware("cpu") == "h100"
    assert hardware.resolve_hardware("cpu") == "cpu"      # explicit wins
    # the reference's variable is not the port's
    monkeypatch.delenv(hardware.HARDWARE_ENV)
    monkeypatch.setenv("REPRO_HARDWARE", "tpu-v5e")
    assert hardware.detect_hardware("cpu") == "cpu"
    from repro_torch.core import current_hardware, execution_context
    with execution_context(hardware="h100"):
        assert current_hardware("cpu") == "h100"
    assert current_hardware("cpu") == "cpu"
    monkeypatch.setattr(hardware.torch.cuda, "get_device_name",
                        lambda i: "NVIDIA H100 80GB HBM3")
    hardware._card_profile.cache_clear()
    try:
        assert hardware.detect_hardware("cuda:0") == "h100"
    finally:
        hardware._card_profile.cache_clear()


def test_h100_profile_numbers():
    h = hardware.get_profile("h100")
    assert h.platform == "gpu" and h.sm_count == 132
    assert h.peak_for(torch.bfloat16) == 989e12
    assert h.peak_for("float32") == 67e12
    assert h.hbm_bandwidth == 3.35e12 and h.hbm_bytes == 80 * 1024 ** 3
    assert h.smem_bytes == 227 * 1024
    assert hardware.get_profile("cpu").platform == "cpu"
    with pytest.raises(KeyError):
        hardware.get_profile("tpu-v5e")


# ---------------------------------------------------------------------------
# block encoding
# ---------------------------------------------------------------------------

def test_block_round_trip_for_every_instantiated_schedule():
    cfgs = [TileConfig(bm, bk, bn, kernel=kern, stages=st, split_k=3,
                       group_m=2)
            for kern, sched in instantiated_schedules().items()
            for bm, bk, bn, st in sched]
    cfgs += [FlashAttentionConfig(bq, bk, kernel=kern, stages=st)
             for kern, sched in instantiated_head_dims().items()
             for bq, bk, st in sched]
    cfgs += [PagedAttentionConfig(32), DecodeLoopConfig(4)]
    ops = {TileConfig: "gemm", FlashAttentionConfig: "flash_attention",
           PagedAttentionConfig: "paged_attn", DecodeLoopConfig: "decode_loop"}
    for cfg in cfgs:
        block = block_of(cfg)
        assert all(type(v) is int for v in block)
        assert config_from_block(ops[type(cfg)], block) == cfg
    assert block_of(TileConfig(16, 128, 64, kernel="decode", stages=4,
                               split_k=8)) == (16, 128, 64,
                                               KERNEL_CODES["decode"], 4, 8, 1)
    assert config_from_block("gemm", (64, 32, 64)) == TileConfig(64, 32, 64)
    with pytest.raises(ValueError):
        config_from_block("gemm", (16, 128, 64, 9))          # no kernel 9
    with pytest.raises(ValueError):
        config_from_block("nope", (1,))


# ---------------------------------------------------------------------------
# TuningDB: the reference's merge semantics, schema versions, errors
# ---------------------------------------------------------------------------

ADDS = [  # (key index, source, seconds)
    (0, "model", 3e-5), (0, "model", 5e-5),          # latest model wins
    (1, "model", 1e-5), (1, "measure", 9e-5),        # measure beats model
    (1, "model", 1e-6),                              # model never beats it
    (2, "measure", 4e-5), (2, "measure", 6e-5),      # better measure kept
    (2, "measure-pruned", 2e-5),                     # ...and improved
    (3, "measure", 7e-5), (3, "measure", 0.0),       # no score: replaces
]


@pytest.mark.parametrize("keep_best", [True, False])
def test_tuning_db_add_matches_reference(keep_best):
    shapes = [(256, 2048, 2048), (2048, 2048, 512), (1024, 1024, 1024),
              (4096, 4096, 4096)]
    port, ref = tuning_db.TuningDB("h100"), ref_db.TuningDB("h100")
    for i, (key, source, secs) in enumerate(ADDS):
        cfg = WGMMA[i % len(WGMMA)]
        port.add(tuning_db.TuningRecord("bfloat16", shapes[key], block_of(cfg),
                                        source=source, seconds=secs),
                 keep_best=keep_best)
        ref.add(ref_db.TuningRecord.gemm("bfloat16", *shapes[key], i + 1,
                                         i + 1, i + 1, source=source,
                                         seconds=secs), keep_best=keep_best)
    assert len(port) == len(ref) == len(shapes)
    for p, r in zip(port.records(), ref.records()):
        assert (p.shape, p.source, p.seconds) == (r.shape, r.source, r.seconds)
        assert p.config == WGMMA[(r.bm - 1) % len(WGMMA)]


def test_tuning_db_v4_round_trip(tmp_path):
    db = tuning_db.TuningDB("h100", measured_on="NVIDIA H100 80GB HBM3, 700.00 W")
    db.add(tuning_db.TuningRecord("bfloat16", (16, 2048, 2048),
                                  block_of(DECODE), source="measure",
                                  seconds=1e-5, gflops=800.0))
    db.add(tuning_db.TuningRecord("bfloat16", (256, 256, 64), block_of(
        FlashAttentionConfig(64, 64, kernel="wgmma", stages=3)),
        op="flash_attention", source="measure", seconds=2e-5))
    db.add(tuning_db.TuningRecord("bfloat16", (8, 1024), (32,),
                                  op="paged_attn"))
    db.add(tuning_db.TuningRecord("float32", (8, 256), (4,), op="decode_loop",
                                  mesh="data4xmodel2"))
    path = str(tmp_path / "h100.json")
    db.save(path)
    blob = json.loads(Path(path).read_text())
    assert blob["schema_version"] == 4 and blob["measured_on"].endswith("W")
    back = tuning_db.TuningDB.from_file(path)
    assert back.records() == db.records()
    assert back.measured_on == db.measured_on and back.ops() == db.ops()
    assert back.get("bfloat16", 16, 2048, 2048).config == DECODE
    assert "decode:16x128x64/s5/k4" in back.markdown()
    # the reference's loader ignores the top-level key it does not know
    assert len(ref_db.TuningDB.from_json(dict(blob, entries=[]))) == 0


@pytest.mark.parametrize("version", [1, 2, 3])
def test_legacy_schemas_load(version, tmp_path):
    if version < 3:
        entries = [{"dtype": "bfloat16", "m": 256, "k": 512, "n": 512,
                    "bm": 64, "bk": 32, "bn": 64, "source": "measure",
                    "seconds": 1e-5}]
    else:
        entries = [{"op": "gemm", "dtype": "bfloat16", "shape": [256, 512, 512],
                    "block": [64, 32, 64], "source": "measure",
                    "seconds": 1e-5},
                   {"op": "flash_attention", "dtype": "float32",
                    "shape": [128, 128, 64], "block": [64, 64]}]
    path = tmp_path / "old.json"
    path.write_text(json.dumps({"schema_version": version, "hardware": "h100",
                                "entries": entries}))
    db = tuning_db.TuningDB.from_file(str(path))
    assert db.get("bfloat16", 256, 512, 512).config == TileConfig(64, 32, 64)
    if version == 3:
        assert db.get_op("flash_attention", "float32",
                         (128, 128, 64)).config == FlashAttentionConfig(64, 64)
    # a WMMA tile is never served to aligned operands: stale for the registry
    assert db.get("bfloat16", 256, 512, 512) in db.stale()


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in (REPO / "tuned").glob("*.json")))
def test_reference_tuned_files_load(path):
    port = tuning_db.TuningDB.from_file(str(REPO / path))
    ref = ref_db.TuningDB.from_file(str(REPO / path))
    assert len(port) == len(ref) and port.ops() == ref.ops()
    assert [r.shape for r in port.records()] == [r.shape for r in ref.records()]


BAD_DBS = {
    "newer": {"schema_version": 5, "hardware": "h100", "entries": []},
    "no_version": {"hardware": "h100", "entries": []},
    "not_a_list": {"schema_version": 4, "entries": {"a": 1}},
    "no_dtype": {"schema_version": 4, "entries": [
        {"op": "gemm", "shape": [1, 2, 3], "block": [16, 128, 64]}]},
    "short_shape": {"schema_version": 4, "entries": [
        {"op": "gemm", "dtype": "bfloat16", "shape": [1, 2], "block": [1]}]},
    "long_block": {"schema_version": 4, "entries": [
        {"op": "paged_attn", "dtype": "bfloat16", "shape": [8, 64],
         "block": [16, 2]}]},
    "text_shape": {"schema_version": 4, "entries": [
        {"op": "gemm", "dtype": "bfloat16", "shape": ["a", 2, 3],
         "block": [16, 128, 64]}]},
    "unknown_op": {"schema_version": 4, "entries": [
        {"op": "conv", "dtype": "bfloat16", "shape": [1], "block": [1]}]},
    "bad_kernel_code": {"schema_version": 4, "entries": [
        {"op": "gemm", "dtype": "bfloat16", "shape": [8, 64, 64],
         "block": [16, 128, 64, 7, 1, 1, 1]}]},
}


@pytest.mark.parametrize("name", sorted(BAD_DBS))
def test_bad_db_files_raise(name, tmp_path):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(BAD_DBS[name]))
    with pytest.raises(tuning_db.TuningDBError):
        tuning_db.TuningDB.from_file(str(path))
    reg = registry.TileRegistry()
    with pytest.raises(tuning_db.TuningDBError):
        tuning_db.load_into_registry(reg, str(path), strict=True)
    with pytest.warns(UserWarning, match="skipping tuning DB"):
        assert tuning_db.load_into_registry(reg, str(path)) == 0


def test_tuned_dir_env_and_disable(tmp_path, monkeypatch):
    db = tuning_db.TuningDB("h100")
    db.add(tuning_db.TuningRecord("bfloat16", (16, 64, 64), block_of(DECODE)))
    db.save(str(tmp_path / "h100.json"))
    monkeypatch.setenv(tuning_db.TUNED_DIR_ENV, str(tmp_path))
    assert tuning_db.default_tuned_dir() == str(tmp_path)
    reg = registry.TileRegistry(autoload=True)
    assert reg.lookup_op("gemm", "h100", "bfloat16",
                         (4, 64, 64)).source == "exact"
    monkeypatch.setenv(tuning_db.DISABLE_ENV, "1")
    reg = registry.TileRegistry(autoload=True)
    assert reg.lookup_op("gemm", "h100", "bfloat16",
                         (4, 64, 64)).source == "default"
    monkeypatch.delenv(tuning_db.TUNED_DIR_ENV)
    assert tuning_db.default_tuned_dir() == str(
        REPO / "src" / "repro_torch" / "tuned")


# ---------------------------------------------------------------------------
# cost model: the reference's formulas on the h100 numbers
# ---------------------------------------------------------------------------

def _close(a, b):
    return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_gemm_cost_matches_reference(dtype):
    blocks = [(16, 128, 64), (128, 64, 64), (128, 64, 128), (128, 64, 256),
              (64, 32, 64), (16, 16, 128)]
    for m, k, n in [(8, 2048, 2048), (16, 2048, 128256), (2048, 2048, 512),
                    (37, 100, 77), (12000, 1280, 5120)]:
        for bm, bk, bn in blocks:
            got = cost_model.gemm_cost(m, k, n, TileConfig(bm, bk, bn),
                                       hardware.H100, getattr(torch, dtype))
            want = ref_cost.gemm_cost(m, k, n, ref_tc.TileConfig(bm, bk, bn),
                                      REF_H100, REF_DTYPE[dtype])
            assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)
            for f in ("compute_s", "hbm_s", "overhead_s", "total_s"):
                assert _close(getattr(got, f), getattr(want, f)), (m, k, n, f)
            assert _close(cost_model.mxu_utilization(
                TileConfig(bm, bk, bn), hardware.H100, getattr(torch, dtype)),
                ref_cost.mxu_utilization(ref_tc.TileConfig(bm, bk, bn),
                                         REF_H100, REF_DTYPE[dtype]))
    assert cost_model.ratio_model(4096, 128) == ref_cost.ratio_model(4096, 128)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_cost_matches_reference(causal):
    for sq, skv, d in [(256, 256, 64), (300, 300, 80), (4096, 4096, 128),
                       (100, 256, 160)]:
        for bq, bk in [(64, 64), (64, 128), (128, 128), (128, 64)]:
            for dtype in ("bfloat16", "float32"):
                got = cost_model.flash_cost(
                    sq, skv, d, FlashAttentionConfig(bq, bk), hardware.H100,
                    getattr(torch, dtype), causal=causal)
                want = ref_cost.flash_cost(
                    sq, skv, d, ref_tc.FlashAttentionConfig(bq, bk), REF_H100,
                    REF_DTYPE[dtype], causal=causal)
                assert (got.flops, got.hbm_bytes) == (want.flops,
                                                      want.hbm_bytes)
                assert _close(got.total_s, want.total_s)


# ---------------------------------------------------------------------------
# tuner: model-mode sweeps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,dtype", [
    ((8, 2048, 2048), torch.bfloat16), ((1, 768, 3352), torch.bfloat16),
    ((8, 2048, 128256), torch.bfloat16), ((2048, 2048, 512), torch.bfloat16),
    ((12000, 1280, 5120), torch.bfloat16), ((8, 2048, 2048), torch.float32),
    ((4096, 128256, 2048), torch.float32), ((1280, 4096, 51866), torch.float32)])
def test_model_sweep_gemm_records_exact_over_taken_schedules(shape, dtype):
    reg = registry.TileRegistry()
    res = tuner.sweep_gemm(*shape, dtype=dtype, mode="model",
                           search="exhaustive", registry=reg)
    assert res.evaluated == res.candidates_total == len(res.points) > 0
    for p in res.points:
        assert registry.takes("gemm", dtype, shape, p.config), p.config
    hand = gemm_tiles(dtype, *shape)
    assert any(p.config == hand or tuner_same(p.config, hand, shape[1])
               for p in res.points)
    got = reg.lookup_op("gemm", "h100", dtype, shape)
    assert (got.source, got.config) == ("exact", res.best.config)
    guided = tuner.sweep_gemm(*shape, dtype=dtype, mode="model", top_k=3,
                              record=False)
    assert guided.evaluated == min(3, res.candidates_total)
    assert [p.config for p in guided.points] == [
        p.config for p in res.points[:3]]


@pytest.mark.parametrize("m,k,n", [(4096, 128256, 2048), (2048, 4096, 128256),
                                   (4096, 50280, 768), (300, 64, 96)])
def test_tuning_space_f32_candidates_are_simt_schedules_by_group(m, k, n):
    """Above M = 16 an f32 product's candidates are every ``simt`` schedule
    ``gemm.cu`` instantiates (read from its ``dispatch_simt`` lines), each
    at every raster grouping up to the tile rows M has, and the hand
    table's schedule; at M <= 16 they stay ``fma``'s."""
    from repro_torch.core.tile_config import TuningSpace
    cands = list(TuningSpace().candidates(torch.float32, m, k, n))
    inst = instantiated_schedules()["simt"]
    assert {c.kernel for c in cands} == {"simt"}
    assert {(c.bm, c.bk, c.bn, c.stages) for c in cands} == inst
    hand = gemm_tiles(torch.float32, m, k, n)
    assert hand in cands
    for c in cands:
        assert c == hand or c.group_m == 1 or c.group_m <= -(-m // c.bm)
        assert registry.takes("gemm", torch.float32, (m, k, n), c)
    small = list(TuningSpace().candidates(torch.float32, 16, k, n))
    assert {c.kernel for c in small} == {"fma"}
    assert not registry.takes("gemm", torch.float32, (16, k, n), cands[0])


def tuner_same(a, b, k):
    from repro_torch.core.tile_config import _same_launch
    return _same_launch(a, b, k)


@pytest.mark.parametrize("d,dtype", [(64, torch.bfloat16), (80, torch.bfloat16),
                                     (128, torch.bfloat16), (160, torch.bfloat16),
                                     (32, torch.bfloat16), (64, torch.float32)])
def test_model_sweep_flash_records_exact_over_taken_schedules(d, dtype):
    reg = registry.TileRegistry()
    res = tuner.sweep_flash_attention(256, 256, d, dtype=dtype, mode="model",
                                      search="exhaustive", registry=reg)
    kernels = {p.config.kernel for p in res.points}
    assert kernels == ({"wgmma"} if dtype == torch.bfloat16 and d != 32
                       else {"fma"})
    for p in res.points:
        assert registry.takes("flash_attention", dtype, (256, 256, d),
                              p.config)
    got = reg.lookup_op("flash_attention", "h100", dtype, (256, 256, d))
    assert (got.source, got.config) == ("exact", res.best.config)


def test_model_sweep_paged_and_measure_needs_the_card():
    reg = registry.TileRegistry()
    res = tuner.sweep_paged_attention(8, 1024, mode="model", registry=reg)
    assert [p.config.page_size for p in res.points] == [8, 16, 32, 64]
    assert reg.lookup_op("paged_attn", "h100", "bfloat16",
                         (8, 1024)).source == "exact"
    if torch.cuda.is_available():
        pytest.skip("a card is present: measure mode runs")
    for fn, args in ((tuner.sweep_gemm, (8, 64, 64)),
                     (tuner.sweep_flash_attention, (64, 64, 64)),
                     (tuner.sweep_paged_attention, (8, 64))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args, mode="measure", record=False)


def test_db_from_sweeps_keys_decode_at_m16():
    res = [tuner.sweep_gemm(m, 2048, 512, mode="model", record=False)
           for m in (1, 8)]
    db = tuning_db.db_from_sweeps("h100", res)
    assert [r.shape for r in db.records()] == [(16, 2048, 512)]
    assert tuner.tune_model_gemms([(8, 64, 64), (32, 64, 64)],
                                  registry=registry.TileRegistry()).keys() == {
        (8, 64, 64), (32, 64, 64)}


# ---------------------------------------------------------------------------
# the committed h100 table
# ---------------------------------------------------------------------------

def test_committed_h100_table_loads_strictly_and_is_taken():
    db = tuning_db.TuningDB.from_file(str(H100_JSON))
    blob = json.loads(H100_JSON.read_text())
    assert blob["schema_version"] == tuning_db.SCHEMA_VERSION
    assert db.hardware == "h100"
    assert "H100" in db.measured_on and db.measured_on.endswith(" W")
    assert db.ops() == ["flash_attention", "gemm"]       # no paged_attn yet
    assert db.stale() == []
    gemm, flash = instantiated_schedules(), instantiated_head_dims()
    for rec in db.records():
        assert rec.source.startswith("measure") and rec.seconds > 0
        cfg = rec.config
        if rec.op == "gemm":
            assert (cfg.bm, cfg.bk, cfg.bn, cfg.stages) in gemm[cfg.kernel]
        else:
            assert rec.shape[2] in flash[cfg.kernel][(cfg.bq, cfg.bk,
                                                      cfg.stages)]


@pytest.mark.parametrize("shape", LLAMA_GEMMS + LLAMA_FLASH,
                         ids=lambda s: "x".join(map(str, s)))
def test_committed_h100_table_covers_llama_serving(shape):
    reg = registry.TileRegistry()
    tuning_db.load_into_registry(reg, str(H100_JSON), strict=True)
    op = "gemm" if shape in LLAMA_GEMMS else "flash_attention"
    res = reg.lookup_op(op, "h100", torch.bfloat16, shape)
    assert res.source == "exact"
    if op == "gemm" and shape[0] == 16:
        for m in (1, 8):       # every decode M resolves to the same entry
            assert reg.lookup_op(op, "h100", torch.bfloat16,
                                 (m,) + shape[1:]).config == res.config


def test_global_registry_autoloads_the_committed_table(monkeypatch):
    monkeypatch.delenv(tuning_db.TUNED_DIR_ENV, raising=False)
    monkeypatch.delenv(tuning_db.DISABLE_ENV, raising=False)
    reg = registry.TileRegistry(autoload=True)
    assert reg.lookup_op("gemm", "h100", torch.bfloat16,
                         (8, 2048, 8192)).source == "exact"
    assert isinstance(registry.GLOBAL_REGISTRY, registry.TileRegistry)
    # a put before any lookup lands on top of the table, not under it
    reg = registry.TileRegistry(autoload=True)
    reg.put_op("gemm", DECODE, "h100", torch.bfloat16, (8, 2048, 8192))
    assert reg.lookup_op("gemm", "h100", torch.bfloat16,
                         (8, 2048, 8192)).config == DECODE
    assert reg.lookup_op("gemm", "h100", torch.bfloat16,
                         (8, 2048, 512)).source == "exact"


# ---------------------------------------------------------------------------
# engine, launcher, CLI
# ---------------------------------------------------------------------------

def _tiny_engine(reg, monkeypatch, **serve_kw):
    from repro_torch.configs.catalog import ARCHITECTURES
    from repro_torch.core import attention_api
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.serve import engine as engine_mod
    monkeypatch.setattr(engine_mod, "GLOBAL_REGISTRY", reg)
    monkeypatch.setattr(attention_api, "GLOBAL_REGISTRY", reg)
    cfg = dataclasses.replace(ARCHITECTURES["llama3.2-1b"].reduced(),
                              dtype="bfloat16", attention_impl="flash")
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    return Engine(model, params, ServeConfig(max_batch=4, max_len=64,
                                             device="cpu", **serve_kw))


@pytest.mark.parametrize("scheduler", ["continuous", "wave"])
def test_cpu_engine_reports_h100_provenance(scheduler, tmp_path, monkeypatch):
    from repro_torch.serve import stats_schema
    prompts = [[5, 9, 2, 7], [1, 3, 3], [2, 4, 6, 8, 1, 5, 3]]
    reg = registry.TileRegistry()
    eng = _tiny_engine(reg, monkeypatch, hardware="h100", scheduler=scheduler)
    assert eng.stats()["decode_tile_lookups"] is None
    first = eng.generate(prompts, 4)
    st = eng.stats()
    assert (st["hardware"], st["hardware_platform"]) == ("h100", "gpu")
    shapes = [tuple(int(x) for x in s.split("x"))
              for s in st["decode_tile_lookups"]]
    assert shapes and all(s[0] == 4 for s in shapes)
    assert {v["source"] for v in st["decode_tile_lookups"].values()} == {
        "default"}
    assert set(st["prefill_flash_lookups"]) == {"8x8x16"}
    # a measured-looking table for exactly these shapes: now exact
    db = tuning_db.db_from_sweeps("h100", [
        tuner.sweep_gemm(*s, mode="model", record=False) for s in shapes]
        + [tuner.sweep_flash_attention(8, 8, 16, mode="model", record=False)])
    db.save(str(tmp_path / "h100.json"))
    tuning_db.load_all(reg, str(tmp_path))
    eng = _tiny_engine(reg, monkeypatch, hardware="h100", scheduler=scheduler)
    assert eng.generate(prompts, 4) == first        # CPU: plain versions
    st = eng.stats()
    for shape, res in st["decode_tile_lookups"].items():
        assert res["source"] == "exact", shape
        assert res["matched_shape"] == (16,) + tuple(
            int(x) for x in shape.split("x"))[1:]
        assert res["tile"].startswith("decode:")
    assert st["prefill_flash_lookups"]["8x8x16"]["source"] == "exact"
    assert st["registry_hit_stats"]["exact"] >= len(shapes)
    assert st["schema_version"] == stats_schema.SCHEMA_VERSION == 2
    assert stats_schema.validate_stats(st) == []
    if scheduler == "continuous":
        assert (st["page_size"], st["page_size_source"]) == (16, "fallback")
    else:
        assert "page_size_source" not in st


def test_cpu_engine_detects_cpu_and_takes_a_tuned_page_size(monkeypatch):
    monkeypatch.delenv(hardware.HARDWARE_ENV, raising=False)
    reg = registry.TileRegistry()
    eng = _tiny_engine(reg, monkeypatch)
    st = eng.stats()
    assert (st["hardware"], st["hardware_platform"]) == ("cpu", "cpu")
    assert (st["page_size"], st["page_size_source"]) == (16, "fallback")
    reg.put_op("paged_attn", PagedAttentionConfig(8), "h100", "bfloat16",
               (4, 64))
    eng = _tiny_engine(reg, monkeypatch, hardware="h100")
    st = eng.stats()
    assert (st["page_size"], st["page_size_source"]) == (8, "tuned:exact")
    eng = _tiny_engine(reg, monkeypatch, hardware="h100", page_size=32)
    assert eng.stats()["page_size_source"] == "config"


def _run(args, tmp_path, **env):
    full = dict(os.environ, PYTHONPATH=str(REPO / "src"), **env)
    return subprocess.run([sys.executable, *args], cwd=tmp_path, env=full,
                          capture_output=True, text=True, timeout=300)


def test_capture_gemm_shapes_records_layout_for_the_tuner():
    """One recorder: the (m, k, n) view by default, and with ``calls`` the
    B layout and out dtype a measured sweep lays its operands out by."""
    from repro_torch.core import capture_gemm_shapes, matmul
    x = torch.randn(2, 3, 16)
    w = torch.randn(16, 24)
    head = torch.randn(40, 16)
    with capture_gemm_shapes() as shapes:
        matmul(x, w)
        matmul(x, head.t(), out_dtype=torch.float64)
    assert shapes == [(6, 16, 24), (6, 16, 40)]
    with capture_gemm_shapes(calls=True) as calls:
        matmul(x, w)
        matmul(x, head.t(), out_dtype=torch.float64)
        assert calls == []              # filled when the scope closes
    assert calls == [(6, 16, 24, False, torch.float32),
                     (6, 16, 40, True, torch.float64)]


def test_launcher_prints_hardware_and_tuned_lines(tmp_path):
    db = tuning_db.TuningDB("h100")
    db.add(tuning_db.TuningRecord("float32", (2, 64, 64), block_of(
        TileConfig(16, 16, 128, kernel="fma"))))
    db.save(str(tmp_path / "h100.json"))
    out = _run(["-m", "repro_torch.launch.serve", "--arch", "llama3.2-1b",
                "--reduced", "--device", "cpu", "--hardware", "h100",
                "--tuned-dir", str(tmp_path), "--prompts", "1,2;3,4,5",
                "--max-new", "3", "--stats"], tmp_path)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "[hw] profile=h100 platform=gpu (flag)"
    assert lines[1] == f"[tuned] 1 configs from {tmp_path / 'h100.json'}"
    assert any(ln.startswith("[tiles] decode gemm 2x64x64: fma:16x16x128 "
                             "(exact") for ln in lines), out.stdout
    assert any("hardware=h100 platform=gpu" in ln for ln in lines)


@pytest.mark.parametrize("flag", [True, False], ids=["tuned-dir", "package"])
def test_launcher_tuned_dir_replaces_the_package_table(flag, tmp_path,
                                                       monkeypatch, capsys):
    """``--tuned-dir X`` serves X alone: a shape of the committed table
    that X lacks resolves ``default``.  Without it the package's table is
    loaded once, and that shape resolves ``exact``."""
    from repro_torch.core import attention_api
    from repro_torch.launch import serve as launch_serve
    from repro_torch.serve import engine as engine_mod
    monkeypatch.delenv(tuning_db.TUNED_DIR_ENV, raising=False)
    monkeypatch.delenv(tuning_db.DISABLE_ENV, raising=False)
    reg = registry.TileRegistry(autoload=True)
    for mod in (launch_serve, engine_mod, attention_api):
        monkeypatch.setattr(mod, "GLOBAL_REGISTRY", reg)
    loads = []
    real = tuning_db.load_into_registry
    monkeypatch.setattr(tuning_db, "load_into_registry",
                        lambda r, path, **kw: loads.append(path)
                        or real(r, path, **kw))
    mine = (2, 64, 64)
    db = tuning_db.TuningDB("h100")
    db.add(tuning_db.TuningRecord("float32", mine, block_of(
        TileConfig(16, 16, 128, kernel="fma"))))
    db.save(str(tmp_path / "h100.json"))
    argv = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
            "--hardware", "h100", "--prompts", "1,2;3,4,5", "--max-new", "2"]
    launch_serve.main(argv + (["--tuned-dir", str(tmp_path)] if flag else []))
    out = capsys.readouterr().out.splitlines()
    table = tuning_db.TuningDB.from_file(str(H100_JSON))
    committed = next(r.shape for r in table.records() if r.op == "gemm")
    res = reg.lookup_op("gemm", "h100", torch.bfloat16, committed)
    mine_res = reg.lookup_op("gemm", "h100", torch.float32, mine)
    if flag:
        assert loads == [str(tmp_path / "h100.json")]
        assert out[1] == f"[tuned] 1 configs from {tmp_path / 'h100.json'}"
        assert res.source == "default"
        assert mine_res.source == "exact"
    else:
        assert loads == [str(H100_JSON)]
        assert out[1] == f"[tuned] {len(table)} configs from {H100_JSON}"
        assert res.source == "exact"
        assert mine_res.source == "default"


def test_cli_sweep_show_export_verify(tmp_path):
    tune = str(REPO / "scripts" / "torch_tune.py")
    out = _run([tune, "sweep", "--hardware", "h100", "--mode", "model",
                "--op", "gemm", "--shapes", "8x2048x2048,2048x2048x512",
                "--db-dir", str(tmp_path)], tmp_path)
    assert out.returncode == 0, out.stderr
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    assert [ln["shape"] for ln in lines] == [[8, 2048, 2048],
                                             [2048, 2048, 512]]
    assert "wrote 2 entries" in out.stdout
    out = _run([tune, "export", "--hardware", "h100", "--format", "json",
                "--db-dir", str(tmp_path)], tmp_path)
    blob = json.loads(out.stdout)
    assert blob["schema_version"] == 4 and "measured_on" not in blob
    assert [e["shape"] for e in blob["entries"]] == [[16, 2048, 2048],
                                                     [2048, 2048, 512]]
    out = _run([tune, "show", "--hardware", "h100", "--db-dir",
                str(tmp_path)], tmp_path)
    assert "| bfloat16 | 16x2048x2048 | decode:" in out.stdout
    out = _run([tune, "verify", "--db-dir", str(tmp_path)], tmp_path)
    assert out.returncode == 0 and "2 entries, 0 stale" in out.stdout
    out = _run([tune, "diff", "--hardware", "h100", "--check", "--db-dir",
                str(tmp_path)], tmp_path)
    assert out.returncode == 0 and "0 of 2 entries changed" in out.stdout
    out = _run([tune, "sweep", "--hardware", "h100", "--mode", "measure",
                "--db-dir", str(tmp_path)], tmp_path)
    if not torch.cuda.is_available():
        assert out.returncode != 0 and "needs the card" in out.stderr
