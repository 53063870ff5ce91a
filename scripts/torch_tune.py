#!/usr/bin/env python3
"""Tuning CLI of the PyTorch/CUDA port: sweep, inspect and check the tuned
schedule tables (``src/repro_torch/tuned/<hardware>.json``).

    python3 scripts/torch_tune.py sweep --arch llama3.2-1b --op all \\
        --mode measure --search exhaustive          # on the card
    python3 scripts/torch_tune.py sweep --hardware h100 --mode model \\
        --op gemm --shapes 8x2048x2048,2048x2048x512
    python3 scripts/torch_tune.py show   [--hardware h100]
    python3 scripts/torch_tune.py diff   [--hardware h100] [--check]
    python3 scripts/torch_tune.py verify [--prune]
    python3 scripts/torch_tune.py export --format markdown|json [--out F]

``--hardware`` names a profile (``h100``, ``cpu``); without it the profile
is ``$REPRO_TORCH_HARDWARE``, else detected from the device.  ``--db-dir``
(or ``$REPRO_TORCH_TUNED_DIR``) reads and writes another directory than the
package's ``tuned/``.

``sweep`` tunes problems and merges the winners into ``<hardware>.json``
(``--fresh`` starts the file anew): ``--shapes`` lists them (``MxKxN``
for gemm, B row-major, or ``MxKxNt``, B K-major as the models keep a
transposed head; ``SQxSKVxD`` for flash_attention, ``BxL`` for
paged_attn);
``--arch A`` collects A's serving problems on the card instead: A is built
at full width in bf16 with flash prefill and seeded random weights, and
serves the 12 seeded requests of ``chip_smoke.py``'s serve phase (8
slots, ``max_len`` 1024) under ``core.capture_gemm_shapes(calls=True)``,
which gives every GEMM of its prefills (at 8 x plen) and decode steps (at
the engine's M) with the layout the model uses; the flash problems are
``(plen, plen, d)`` for the plen buckets the serve used.  A flash entry is
keyed by ``(sq, skv, d)`` alone, so every flash problem is measured at one
layout, ``FLASH_LAYOUT`` (batch 8, 32 query and 8 KV heads), whichever
model it came from: two models' measurements of one key are then of the
same problem, and the better one is the winner.  With ``--arch``, ``--op all`` means gemm and flash_attention: a
``paged_attn`` entry would change the page size the engine serves with,
so it is swept only when named.  ``--mode measure`` (the card only) times
each candidate with CUDA events on the device (``core.tuner``) and writes
the card's ``nvidia-smi`` name and power limit as ``measured_on``; it
prints one JSON line per problem: the winner, the hand table's schedule
and their device times, the guided top-k's pick among the same
measurements, and one ``torch.matmul`` / SDPA call's device time.

``show`` / ``export`` render the DB; ``diff`` re-runs the model-mode sweep
of every ``model`` entry and reports changed winners (``--check``: exit 1
if any); ``verify`` loads every DB strictly and reports entries the
wrapper would not take at their own shape (``--prune`` drops them).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.core import tuner, tuning_db  # noqa: E402
from repro_torch.core.hardware import get_profile, resolve_hardware  # noqa: E402
from repro_torch.core.tile_config import (  # noqa: E402
    OP_FLASH_ATTENTION, OP_GEMM, OP_PAGED_ATTN, flash_tiles, gemm_tiles)

#: default problems without --arch or --shapes: llama3.2-1b's serving GEMMs
#: (decode at M = 8, prefill at 8 x 256), its prefill flash buckets, and the
#: serve pool of chip_smoke.py's engines
DEFAULT_SHAPES = {
    OP_GEMM: [(8, 2048, 2048), (8, 2048, 512), (8, 2048, 8192),
              (8, 8192, 2048), (8, 2048, 128256), (2048, 2048, 2048),
              (2048, 2048, 512), (2048, 2048, 8192), (2048, 8192, 2048)],
    OP_FLASH_ATTENTION: [(256, 256, 64), (512, 512, 64), (256, 256, 128)],
    OP_PAGED_ATTN: [(8, 1024)],
}
#: (batch, heads, kv_heads) of every measured flash problem (the registry
#: keys a flash entry by (sq, skv, d) only)
FLASH_LAYOUT = (8, 32, 8)
DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "float32": torch.float32, "f32": torch.float32}


def smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _parse_shapes(text, op):
    shapes = []
    for part in text.split(","):
        part = part.lower()
        kmajor = op == OP_GEMM and part.endswith("t")
        try:
            dims = tuple(int(x) for x in
                         (part[:-1] if kmajor else part).split("x"))
        except ValueError:
            dims = ()
        if len(dims) not in (2, 3):
            raise SystemExit(f"error: bad --shapes entry {part!r}; expected "
                             f"MxKxN[t], SQxSKVxD or BxL")
        shapes.append(dims + (True,) if kmajor else dims)
    return shapes


def _resolve_hw(args) -> str:
    name = resolve_hardware(args.hardware)
    if not args.hardware:
        print(f"[hw] no --hardware given; resolved to {name!r}")
    args.hardware = name
    return name


def _db_path(args) -> str:
    return tuning_db.db_path(args.hardware, args.db_dir)


def arch_problems(arch: str):
    """A's serving problems, collected on the card (see the module doc):
    ``{op: [problem]}``; a GEMM problem is ``(m, k, n, b_kmajor,
    out_dtype)``."""
    import dataclasses

    import numpy as np

    from repro_torch.configs.catalog import get_config
    from repro_torch.core import capture_gemm_shapes
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig

    cfg = dataclasses.replace(get_config(arch), dtype="bfloat16",
                              attention_impl="flash")
    model = build_model(cfg)
    params = model.init(seed=0, device="cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(5, 301, size=12)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in lens]
    gen = torch.Generator(device="cuda").manual_seed(0)
    extra = {k: torch.randn(spec.shape, generator=gen, device="cuda"
                            ).to(spec.dtype)
             for k, spec in model.extra_inputs(len(prompts)).items()}
    eng = Engine(model, params, ServeConfig(max_batch=8, max_len=1024,
                                            decode_chunk=8))
    with capture_gemm_shapes(calls=True) as calls:
        eng.generate(prompts, 8, extra_inputs=extra or None)
    gemms = sorted({(m, k, n, bool(km), out) for m, k, n, km, out in calls},
                   key=lambda c: c[:3])
    flash = []
    if cfg.num_heads and not cfg.attention_free:
        d = cfg.resolved_head_dim
        flash = [(p, p, d) for p in eng.stats()["prefill_plen_buckets"]]
    del eng, params
    torch.cuda.empty_cache()
    return {OP_GEMM: gemms, OP_FLASH_ATTENTION: flash}


def _library_us(op, problem, dtype):
    """One torch.matmul / SDPA call's device time (us) on the problem's
    operands: a yardstick beside the kernel's times."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(0)
    if op == OP_GEMM:
        m, k, n, kmajor = (problem + (False,))[:4]
        a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        b = torch.randn(n, k, generator=gen, device="cuda").to(dtype)
        b = b.t() if kmajor else b.t().contiguous()
        fn = lambda: torch.matmul(a, b)  # noqa: E731
    else:
        sq, skv, d = problem
        b, h, _ = FLASH_LAYOUT
        q = torch.randn(b, h, sq, d, generator=gen, device="cuda").to(dtype)
        k = torch.randn(b, h, skv, d, generator=gen, device="cuda").to(dtype)
        fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, k, is_causal=True)
    return tuner._timer()(fn, 10)[0] * 1e6


def _sweep_one(op, problem, hw, dtype, args):
    kw = dict(dtype=dtype, hardware=hw, mode=args.mode, search=args.search,
              top_k=args.top_k, repeats=args.repeats, record=False)
    if op == OP_GEMM:
        m, k, n, kmajor, out = (problem + (False, None))[:5]
        return tuner.sweep_gemm(m, k, n, b_kmajor=kmajor, out_dtype=out, **kw)
    if op == OP_FLASH_ATTENTION:
        batch, heads, kv_heads = FLASH_LAYOUT
        return tuner.sweep_flash_attention(
            *problem, batch=batch, heads=heads, kv_heads=kv_heads, **kw)
    return tuner.sweep_paged_attention(
        *problem, dtype=dtype, hardware=hw, mode=args.mode,
        repeats=args.repeats, record=False)


def _report(op, problem, res, dtype, args) -> None:
    """One JSON line: the winner, the hand table's schedule, the guided
    top-k's pick among the same points (an exhaustive sweep scores every
    candidate in the cost model's order) and the library's time."""
    best = res.best
    line = {"op": op, "shape": list(res.shape), "dtype": res.dtype,
            "best": best.config.schedule, "best_us": best.seconds * 1e6,
            "evaluated": res.evaluated, "candidates": res.candidates_total,
            "pruned": res.pruned, "search": res.search}
    if op in (OP_GEMM, OP_FLASH_ATTENTION):
        line["kmajor"] = bool(op == OP_GEMM and len(problem) > 3
                              and problem[3])
        hand = (gemm_tiles(dtype, *res.shape) if op == OP_GEMM
                else flash_tiles(dtype, *res.shape))
        times = {p.config: p.seconds for p in res.points}
        line["hand"] = hand.schedule
        line["hand_us"] = (times[hand] * 1e6 if hand in times else None)
        if res.search == tuner.SEARCH_EXHAUSTIVE:
            top = min(res.points[:args.top_k], key=lambda p: p.seconds)
            line["guided_top_k"] = args.top_k
            line["guided_pick"] = top.config.schedule
            line["guided_found_best"] = top.config == best.config
        if args.mode == "measure":
            line["library_us"] = _library_us(op, problem, dtype)
            line["us_by_schedule"] = {p.config.schedule: p.seconds * 1e6
                                      for p in res.points}
    print(json.dumps(line), flush=True)


def cmd_sweep(args) -> int:
    hw = get_profile(_resolve_hw(args))
    if args.mode == "measure" and not torch.cuda.is_available():
        raise SystemExit("error: --mode measure needs the card (no CUDA "
                         "device); use --mode model")
    if args.shapes and (args.arch or args.op == "all"):
        raise SystemExit("error: --shapes takes one --op and no --arch")
    dtype = DTYPES[args.dtype]
    if args.arch:
        if not torch.cuda.is_available():
            raise SystemExit("error: --arch serves the model on the card")
        problems = arch_problems(args.arch)
        ops = ([OP_GEMM, OP_FLASH_ATTENTION] if args.op == "all"
               else [args.op])
        if OP_PAGED_ATTN in ops:
            raise SystemExit("error: --arch collects gemm and flash problems;"
                             " sweep paged_attn with --shapes")
    else:
        ops = (list(DEFAULT_SHAPES) if args.op == "all" else [args.op])
        problems = {op: (_parse_shapes(args.shapes, op) if args.shapes
                         else DEFAULT_SHAPES[op]) for op in ops}
    path = _db_path(args)
    db = tuning_db.TuningDB(hw.name)
    if os.path.exists(path) and not args.fresh:
        db.merge(tuning_db.TuningDB.from_file(path))
    results = []
    for op in ops:
        for problem in problems[op]:
            res = _sweep_one(op, tuple(problem), hw, dtype, args)
            results.append(res)
            _report(op, tuple(problem), res, dtype, args)
    measured_on = smi() if args.mode == "measure" else None
    db.merge(tuning_db.db_from_sweeps(hw.name, results, measured_on))
    db.save(path)
    print(f"[sweep] wrote {len(db)} entries -> {path}"
          + (f" (measured on {measured_on})" if measured_on else ""))
    return 0


def _load_db(args) -> tuning_db.TuningDB:
    _resolve_hw(args)
    path = _db_path(args)
    if not os.path.exists(path):
        raise SystemExit(f"error: no tuning DB at {path}; run `torch_tune.py "
                         f"sweep --hardware {args.hardware}` first")
    return tuning_db.TuningDB.from_file(path)


def cmd_show(args) -> int:
    print(_load_db(args).markdown())
    return 0


def cmd_diff(args) -> int:
    """Re-sweep the DB's model-mode entries; report changed winners."""
    db = _load_db(args)
    hw = get_profile(args.hardware)
    changed = 0
    for rec in db.records():
        if rec.source != "model":
            continue        # measured entries are what the card said
        kw = dict(dtype=DTYPES[rec.dtype], hardware=hw, mode="model",
                  record=False)
        if rec.op == OP_GEMM:
            res = tuner.sweep_gemm(*rec.shape, search=args.search,
                                   top_k=args.top_k, **kw)
        elif rec.op == OP_FLASH_ATTENTION:
            res = tuner.sweep_flash_attention(*rec.shape, search=args.search,
                                              top_k=args.top_k, **kw)
        elif rec.op == OP_PAGED_ATTN:
            res = tuner.sweep_paged_attention(*rec.shape, **kw)
        else:
            continue
        if res.best.config != rec.config:
            changed += 1
            print(f"[diff] {rec.op} {rec.dtype} "
                  f"{'x'.join(map(str, rec.shape))}: {rec.config.schedule} "
                  f"-> {res.best.config.schedule}")
    print(f"[diff] {changed} of {len(db)} entries changed vs {_db_path(args)}")
    return 1 if changed and args.check else 0


def cmd_verify(args) -> int:
    """Load every DB strictly; report (or --prune) entries the wrapper
    would not take at their own shape."""
    if args.hardware:
        _resolve_hw(args)
        paths = [_db_path(args)]
    else:
        d = args.db_dir or tuning_db.default_tuned_dir()
        paths = sorted(os.path.join(d, f) for f in os.listdir(d)
                       if f.endswith(".json")) if os.path.isdir(d) else []
    if not paths:
        print("[verify] no tuned DBs")
        return 0
    code = 0
    for path in paths:
        try:
            db = tuning_db.TuningDB.from_file(path)
        except (tuning_db.TuningDBError, OSError) as e:
            print(f"[verify] {path}: error: {e}")
            code = 1
            continue
        stale = db.stale()
        for rec in stale:
            print(f"[verify] {path}: stale {rec.op} {rec.dtype} "
                  f"{'x'.join(map(str, rec.shape))}: {rec.config.schedule}")
        print(f"[verify] {path}: {len(db)} entries, {len(stale)} stale"
              + (f", measured on {db.measured_on}" if db.measured_on else ""))
        if stale and args.prune:
            keep = tuning_db.TuningDB(db.hardware, db.measured_on)
            for rec in db.records():
                if rec not in stale:
                    keep.add(rec, keep_best=False)
            keep.save(path)
            print(f"[verify] pruned {len(stale)} -> {path}")
        elif stale:
            code = 1
    return code


def cmd_export(args) -> int:
    db = _load_db(args)
    if args.format == "markdown":
        text = db.markdown() + "\n"
    else:
        text = json.dumps(db.to_json(), indent=1, sort_keys=True) + "\n"
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"[export] wrote {args.out}")
    else:
        print(text, end="")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--hardware", default=None,
                       help="hardware profile (default: $REPRO_TORCH_HARDWARE"
                            " or detected from the device)")
        p.add_argument("--db-dir", default=None,
                       help="tuned-DB directory (default: "
                            "$REPRO_TORCH_TUNED_DIR or the package's tuned/)")

    p = sub.add_parser("sweep", help="tune problems and update the DB")
    common(p)
    p.add_argument("--op", choices=[OP_GEMM, OP_FLASH_ATTENTION,
                                    OP_PAGED_ATTN, "all"], default="all")
    p.add_argument("--arch", default=None,
                   help="collect this model's serving problems on the card")
    p.add_argument("--mode", choices=["model", "measure"], default="model")
    p.add_argument("--search", choices=[tuner.SEARCH_GUIDED,
                                        tuner.SEARCH_EXHAUSTIVE],
                   default=tuner.SEARCH_GUIDED)
    p.add_argument("--top-k", type=int, default=tuner.DEFAULT_TOP_K)
    p.add_argument("--shapes", default=None,
                   help="comma-separated problems for one --op")
    p.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--fresh", action="store_true",
                   help="start the DB anew instead of merging into it")
    p.set_defaults(fn=cmd_sweep)
    p = sub.add_parser("show", help="print the DB as markdown")
    common(p)
    p.set_defaults(fn=cmd_show)
    p = sub.add_parser("diff", help="re-sweep model entries, report changes")
    common(p)
    p.add_argument("--search", default=tuner.SEARCH_GUIDED)
    p.add_argument("--top-k", type=int, default=tuner.DEFAULT_TOP_K)
    p.add_argument("--check", action="store_true",
                   help="exit 1 when a winner changed")
    p.set_defaults(fn=cmd_diff)
    p = sub.add_parser("verify", help="load DBs strictly, report stale entries")
    common(p)
    p.add_argument("--prune", action="store_true",
                   help="rewrite each DB without its stale entries")
    p.set_defaults(fn=cmd_verify)
    p = sub.add_parser("export", help="export the DB (markdown/json)")
    common(p)
    p.add_argument("--format", choices=["markdown", "json"],
                   default="markdown")
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_export)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
