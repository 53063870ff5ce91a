#!/usr/bin/env python
"""Prefix-cache smoke on the port: savings must scale with the shared-prefix
length.

The port's counterpart of ``scripts/prefix_cache_smoke.py``, with the same
traffic and the same assertions.  Serving a repeated-prefix workload must
skip prefill work *proportional to the shared-prefix length*, and the
versioned ``stats()["prefix_cache"]`` counters are the measurement.  One
engine serves three workloads whose only difference is the shared-prefix
length L, and per L:

* a cold pass (cache just cleared) inserts every prompt;
* a same-prefix/new-suffix pass hits **partial** on every prompt and
  serves exactly ``n * (L rounded down to the page size)`` cached tokens;
* an exact-repeat pass hits **full** on every prompt and its
  ``prefill_tokens_saved`` delta equals the workload's prompt tokens;
* across lengths, the partial-hit savings scale exactly as ``L_aligned``.

Greedy parity of the served tokens is the tests' job
(``tests/test_torch_prefix_cache.py``); :func:`drive` returns them, so a
test can hold them against the reference script's.  Exit 0 = every
assertion holds.

    PYTHONPATH=src python scripts/torch_prefix_cache_smoke.py --device cpu
    python3 scripts/torch_prefix_cache_smoke.py --full     # on the card
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.configs.catalog import ARCHITECTURES  # noqa: E402
from repro_torch.core import resolve_device  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serve import Engine, Request, ServeConfig  # noqa: E402

ARCH = "llama3.2-1b"
PAGE = 4
PREFIX_LENGTHS = (8, 16, 24)    # page-aligned multiples of PAGE
N_REQUESTS = 4
MAX_NEW = 3
SEED = 7


def make_engine(params, model, device) -> Engine:
    """The engine the smoke drives: ``N_REQUESTS`` slots of 64 tokens over
    pages of ``PAGE``."""
    return Engine(model, params, ServeConfig(
        max_batch=N_REQUESTS, max_len=64, page_size=PAGE,
        device=str(device)))


def _drive(eng, prompts):
    handles = [eng.submit(Request(prompt=p, max_new_tokens=MAX_NEW))
               for p in prompts]
    eng.run()
    return [h.result(timeout=0) for h in handles]


def drive(eng, vocab_size: int, log=print):
    """The three passes for every prefix length on ``eng``.  Returns
    (failed assertions, [each pass's served token lists, in order])."""
    rng = np.random.RandomState(SEED)
    failures, served_tokens = [], []
    partial_served = {}

    def check(cond, msg):
        log(f"[prefix-smoke] {'ok  ' if cond else 'FAIL'} {msg}")
        if not cond:
            failures.append(msg)

    def run(prompts):
        results = _drive(eng, prompts)
        served_tokens.append([list(r.tokens) for r in results])
        return eng.stats()["prefix_cache"]

    for L in PREFIX_LENGTHS:
        prefix = [int(t) for t in rng.randint(1, vocab_size, L)]

        def suffix():
            return [int(t) for t in rng.randint(1, vocab_size, 3)]
        cold_prompts = [prefix + suffix() for _ in range(N_REQUESTS)]
        new_prompts = [prefix + suffix() for _ in range(N_REQUESTS)]
        total_cold_tokens = sum(len(p) for p in cold_prompts)

        eng.clear_prefix_cache()
        st0 = eng.stats()["prefix_cache"]
        st1 = run(cold_prompts)
        # cold pass: later requests may partial-hit the pages the first
        # insert pinned, but nothing was cached before it
        check(st1["inserts"] - st0["inserts"] == N_REQUESTS,
              f"L={L}: cold pass inserted all {N_REQUESTS} prompts")

        st2 = run(new_prompts)
        aligned = (L // PAGE) * PAGE
        served = st2["cached_tokens_served"] - st1["cached_tokens_served"]
        check(st2["hits_partial"] - st1["hits_partial"] == N_REQUESTS,
              f"L={L}: every new-suffix prompt partial-hit the prefix")
        check(served == N_REQUESTS * aligned,
              f"L={L}: partial hits served {served} cached tokens "
              f"(= {N_REQUESTS} x {aligned} page-aligned prefix)")
        partial_served[L] = served

        st3 = run(cold_prompts)
        saved = st3["prefill_tokens_saved"] - st2["prefill_tokens_saved"]
        check(st3["hits_full"] - st2["hits_full"] == N_REQUESTS,
              f"L={L}: exact repeats all full-hit")
        check(saved == total_cold_tokens,
              f"L={L}: full hits skipped prefill for all "
              f"{total_cold_tokens} prompt tokens (got {saved})")

    # proportionality across lengths: savings scale as the aligned prefix
    base_l = PREFIX_LENGTHS[0]
    for L in PREFIX_LENGTHS[1:]:
        want = partial_served[base_l] * L // base_l
        check(partial_served[L] == want,
              f"savings scale with prefix length: served[{L}]="
              f"{partial_served[L]} == served[{base_l}] * {L}/{base_l}")
    return failures, served_tokens


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", default=None,
                    help="also write the engine's final stats() dict to "
                         "this path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--full", action="store_true",
                    help="llama3.2-1b at its published width and depth in "
                         "bf16 (default: the reduced f32 config)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"[prefix-smoke] {e}", file=sys.stderr)
        return 2
    cfg = ARCHITECTURES[ARCH]
    cfg = dataclasses.replace(cfg, dtype="bfloat16") if args.full \
        else cfg.reduced()
    model = build_model(cfg)
    eng = make_engine(model.init(seed=1, device=device), model, device)
    failures, _ = drive(eng, cfg.vocab_size)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(eng.stats(), f, indent=1, sort_keys=True, default=str)
            f.write("\n")
        print(f"[prefix-smoke] wrote stats -> {args.json}")
    if failures:
        print(f"[prefix-smoke] FAILED: {len(failures)} assertion(s)")
        return 1
    print("[prefix-smoke] PASS: prefill savings proportional to "
          f"shared-prefix length over L={list(PREFIX_LENGTHS)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
