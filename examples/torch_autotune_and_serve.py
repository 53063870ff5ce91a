"""The paper's single-source thesis on the port: tune the SAME GEMM kernel
source for two targets, persist the tuned table (the paper's Tab. 4) and
reload it, then tune every GEMM a model issues and its prefill
flash-attention problem, and serve with every lookup resolved ``exact``.

1. ``h100`` (measured on the card; ranked by the cost model on the CPU)
   and ``cpu`` (the cost model) for one 4096^3 product, persisted to a
   temporary file and reloaded;
2. ``capture_gemm_shapes`` over a forward and a decode step of
   llama3.2-1b; every captured shape tuned into ``GLOBAL_REGISTRY``, and
   the engine's bucketed prefill problem given a flash sweep;
3. a serve whose ``stats()`` shows every decode GEMM and prefill flash
   lookup ``exact``.

The committed table ``src/repro_torch/tuned/h100.json`` is never written:
the tuned entries live in the process's registry and a temporary file.

Run (on the card, llama3.2-1b at its published width and depth)::

    PYTHONPATH=src python examples/torch_autotune_and_serve.py [--layers N]

or on the CPU (plain versions, cost-model tuning)::

    PYTHONPATH=src python examples/torch_autotune_and_serve.py --device cpu --reduced
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.configs.catalog import get_config  # noqa: E402
from repro_torch.core import (TileRegistry,  # noqa: E402
                              capture_gemm_shapes, resolve_device)
from repro_torch.core.device import card_label  # noqa: E402
from repro_torch.core.hardware import resolve_hardware  # noqa: E402
from repro_torch.core.tuner import (sweep_flash_attention,  # noqa: E402
                                    sweep_gemm)
from repro_torch.core.tuning_db import (db_from_sweeps,  # noqa: E402
                                        db_path, default_tuned_dir,
                                        load_into_registry)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402

ARCH = "llama3.2-1b"
PROMPTS = ([11, 22, 33], [44, 55, 66, 77, 88])
MAX_BATCH = 2
#: the engine's prefill bucket for PROMPTS (the smallest, 8 tokens)
PREFILL_LEN = 8


def model_config(reduced: bool = False, layers: int = None):
    """llama3.2-1b at its published width in bf16 with flash prefill
    (``reduced``: the tiny f32 variant); ``layers`` cuts depth only."""
    cfg = get_config(ARCH)
    cfg = cfg.reduced() if reduced else dataclasses.replace(
        cfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, attention_impl="flash")
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def committed_table_hash() -> str:
    """sha256 of the committed ``h100`` table (it must never change)."""
    with open(db_path("h100", default_tuned_dir()), "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def tune_two_targets(device, n: int = 4096):
    """One kernel source, two targets: ``h100`` (measured on the card, the
    cost model elsewhere) in bf16 and ``cpu`` (the cost model) in f32,
    into a private registry, persisted per target and reloaded.  Returns
    [(hardware, SweepResult)] and the entries the reload found."""
    reg = TileRegistry()
    runs = [("h100", torch.bfloat16,
             "measure" if device.type == "cuda" else "model"),
            ("cpu", torch.float32, "model")]
    results = [(hw, sweep_gemm(n, n, n, dtype=dt, hardware=hw, mode=mode,
                               registry=reg))
               for hw, dt, mode in runs]
    reloaded = TileRegistry()
    with tempfile.TemporaryDirectory() as d:
        count = 0
        for hw, res in results:
            path = os.path.join(d, f"{hw}.json")
            db_from_sweeps(hw, [res], measured_on=card_label(device)
                           if res.best.source != "model" else None
                           ).save(path)
            count += load_into_registry(reloaded, path, strict=True)
    return results, count


def capture_shapes(model, params, device):
    """Every (m, k, n) a forward at (2, 16) tokens and an engine decode
    step (``MAX_BATCH`` rows) issue."""
    with torch.no_grad(), capture_gemm_shapes() as shapes:
        model.forward(params, {"tokens": torch.zeros(
            (2, 16), dtype=torch.int32, device=device)})
        cache = model.init_cache(MAX_BATCH, 32, device=device)
        model.decode_step(params, torch.zeros((MAX_BATCH, 1),
                                              dtype=torch.int32,
                                              device=device), cache, 16)
    return sorted(set(shapes))


def tune_captured(shapes, cfg, device):
    """Sweep every captured GEMM shape and the prefill flash problem for
    this device's profile into ``GLOBAL_REGISTRY``.  Returns
    ({shape: schedule}, the flash SweepResult)."""
    hardware = resolve_hardware(None, device)
    mode = "measure" if device.type == "cuda" else "model"
    dtype = getattr(torch, cfg.dtype)
    tuned = {}
    for m, k, n in shapes:
        res = sweep_gemm(m, k, n, dtype=dtype, hardware=hardware, mode=mode)
        tuned[(m, k, n)] = res.best.config.schedule
    flash = sweep_flash_attention(
        PREFILL_LEN, PREFILL_LEN, cfg.resolved_head_dim, dtype=dtype,
        hardware=hardware, mode=mode, heads=cfg.num_heads,
        kv_heads=cfg.num_kv_heads)
    return tuned, flash


def serve(model, params, device, max_new: int = 6):
    """Serve ``PROMPTS``; returns (tokens, stats)."""
    eng = Engine(model, params, ServeConfig(max_batch=MAX_BATCH, max_len=64,
                                            device=str(device)))
    outs = eng.generate([list(p) for p in PROMPTS], max_new_tokens=max_new)
    return outs, eng.stats()


def not_exact(stats):
    """Every decode GEMM or prefill flash lookup not resolved ``exact``."""
    out = {}
    for key in ("decode_tile_lookups", "prefill_flash_lookups"):
        for shape, info in (stats.get(key) or {}).items():
            if info["source"] != "exact":
                out[f"{key}:{shape}"] = info["source"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny f32 config of the CPU tests")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (width unchanged)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"[autotune] {e}", file=sys.stderr)
        return 2
    before = committed_table_hash()
    print(f"[autotune] on {card_label(device)}; committed h100 table "
          f"sha256 {before[:16]}")

    results, count = tune_two_targets(device)
    for hw, res in results:
        print(f"[tune] {hw:5s} 4096^3 {res.dtype}: best "
              f"{res.best.config.schedule} ({res.best.gflops / 1000:.2f} "
              f"TFLOP/s {res.best.source})")
    print(f"[tune] persisted and reloaded {count} tuned entries (Tab. 4)")

    cfg = model_config(args.reduced, args.layers)
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    shapes = capture_shapes(model, params, device)
    print(f"[trace] {cfg.name}: {len(shapes)} unique GEMM shapes "
          f"(forward + decode step)")
    tuned, flash = tune_captured(shapes, cfg, device)
    for shape, schedule in tuned.items():
        print(f"[tune]   {'x'.join(map(str, shape)):>18s} -> {schedule}")
    print(f"[tune]   flash {PREFILL_LEN}x{PREFILL_LEN}x"
          f"{cfg.resolved_head_dim} -> {flash.best.config.schedule}")

    outs, st = serve(model, params, device)
    for p, o in zip(PROMPTS, outs):
        print(f"[serve] {list(p)} -> {o}")
    for key, what in (("decode_tile_lookups", "decode GEMM"),
                      ("prefill_flash_lookups", "prefill flash")):
        for shape, info in (st[key] or {}).items():
            print(f"[serve]   {what} {shape:>16s} -> {info['tile']} "
                  f"({info['source']})")
    after = committed_table_hash()
    bad = not_exact(st)
    if bad or not st["decode_tile_lookups"] or after != before:
        print(f"[autotune] FAIL: lookups not exact {bad}; committed table "
              f"{'unchanged' if after == before else 'CHANGED'}",
              file=sys.stderr)
        return 1
    print("[autotune] OK: every decode GEMM and prefill flash lookup exact; "
          "committed table unchanged")
    return 0


if __name__ == "__main__":
    sys.exit(main())
