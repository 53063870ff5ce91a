#!/usr/bin/env python3
"""Time the flash-attention kernel K2 at the serving prefill shape and at
two long prompts, under every schedule the wgmma kernel instantiates.

    python scripts/torch_flash_sweep.py [--reps 10] [--src DIR --table-only]

The cases are ``chip_smoke.py``'s bf16 flash rows that the targets name
(the serve path's prefill (8, 256, 32, 64) / (8, 256, 8, 64) with ragged
``kv_start``, a 4096-token causal prompt and four ragged 1024-token
prompts) and a 4096-token causal prompt at head dim 128.  For each it
times the table's pick through the public entry point
``repro_torch.core.flash_attention`` (the same call in every commit of the
port), each candidate schedule, and one
``F.scaled_dot_product_attention`` call as a yardstick, each launch alone
with CUDA events after an L2 flush, under both of ``chip_smoke.Timer``'s
timers (``*_ms``: the first slice's timer; ``*_device_ms``: device only).
It prints one JSON line per case, then the card's name and power limit.

``--src DIR --table-only`` times only the table's pick of another tree's
``repro_torch`` (e.g. an unpacked earlier commit's ``src/``) with this
tree's timers, so two versions compare in one call on one card.  Needs a
CUDA device; there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

#: chip_smoke.flash_cases() labels of the three cases the targets name
CASES = ("prefill (8,256,32,64)", "long causal", "long ragged")
#: a head dim of 128 (not on the serve path), for the tile table's d = 128 row
EXTRA = (("long causal d=128 (1,4096,16,128)", 1, 4096, 4096, 16, 4, 128,
          "bfloat16", [0], False),)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--table-only", action="store_true",
                    help="time the table's pick only, not the candidates")
    args = ap.parse_args(argv)
    import torch

    from chip_smoke import (Timer, flash_bound, flash_cases, flash_library,
                            flash_operands, smi)
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import flash_attention

    if not torch.cuda.is_available():
        print("torch_flash_sweep: no CUDA device available", file=sys.stderr)
        return 2
    timer, device_timer = Timer(torch), Timer(torch, device_only=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [c for c in flash_cases() if c[0].startswith(CASES)]
    for case in cases + list(EXTRA):
        q, k, v, kv_start = flash_operands(torch, case, gen)
        runs = {"table": lambda: flash_attention(q, k, v, causal=True,
                                                 kv_start=kv_start)}
        if not args.table_only:
            from repro_torch.core.tile_config import FlashAttentionConfig
            from repro_torch.kernels.flash_attention import (
                flash_attention_cuda, instantiated_schedules)
            for bq, bk, stages in sorted(instantiated_schedules()["wgmma"]):
                cfg = FlashAttentionConfig(bq, bk, kernel="wgmma", stages=stages)
                runs[cfg.schedule] = (
                    lambda cfg=cfg: flash_attention_cuda(
                        q, k, v, config=cfg, kv_start=kv_start))
        times = {name: timer(run, reps=args.reps) for name, run in runs.items()}
        device_times = {name: device_timer(run, reps=args.reps)
                        for name, run in runs.items()}
        library = flash_library(torch, q, k, v, kv_start)
        b_ms, b_by = flash_bound(torch, case)
        best = min(device_times, key=device_times.get)
        print(json.dumps({
            "src": args.src, "case": case[0], "table_ms": times["table"],
            "table_device_ms": device_times["table"], "best": best,
            "best_device_ms": device_times[best],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer(library, reps=args.reps),
            "library_device_ms": device_timer(library, reps=args.reps),
            "candidates_ms": times, "candidates_device_ms": device_times,
        }), flush=True)
        del q, k, v
    print(smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
