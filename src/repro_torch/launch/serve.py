"""Serving driver: greedy continuous-batching generation with the Engine.

  python -m repro_torch.launch.serve --arch llama3.2-1b --attn-impl flash \
      --prompts "1,2,3;4,5,6,7,8" --max-new 16 --stats

Runs on the card by default (the GEMM and flash-attention CUDA kernels are
built from ``repro_torch/kernels/csrc`` at first use); ``--device cpu`` runs
the kernels' plain versions instead, e.g. with ``--reduced``.  Weights are
random, drawn from seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs.catalog import get_config
from repro_torch.models import build_model
from repro_torch.serve import Engine, ServeConfig


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompts", default="1,2,3;7,8,9",
                    help="';'-separated comma-token prompts")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="KV-cache slots (default: number of prompts)")
    ap.add_argument("--attn-impl", choices=["chunked", "flash"], default=None,
                    help="override the config's attention implementation "
                         "(flash = the CUDA flash kernel for prefill)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "versions of the kernels)")
    ap.add_argument("--stats", action="store_true",
                    help="print engine counters and kernel launch counts "
                         "(synchronizes after prefill to split timings)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attention_impl=args.attn_impl)
    model = build_model(cfg)
    params = model.init(0, device=args.device)
    prompts = [[int(t) % cfg.vocab_size for t in p.split(",")]
               for p in args.prompts.split(";")]
    eng = Engine(model, params, ServeConfig(
        max_batch=args.max_batch or len(prompts), profile=args.stats,
        device=args.device))
    outs = eng.generate(prompts, args.max_new)
    for p, o in zip(prompts, outs):
        print(f"prompt={p} -> {o}")
    if args.stats:
        st = eng.stats()
        toks = st["tokens_generated"]
        dec_s = st["decode_seconds"] or 1e-9
        print(f"[stats] device={st['device']} scheduler={st['scheduler']}, "
              f"{int(toks)} tokens, {int(st['chunks'])} chunk(s), "
              f"{int(st['device_transfers'])} host transfer(s), "
              f"prefill {st['prefill_seconds']:.4f} s, "
              f"decode {toks / dec_s:.1f} tok/s")
        pages = st["pages"] or {}
        print(f"[stats] paged KV: page_size={st['page_size']}, "
              f"capacity={st['capacity_tokens']} tokens, high water "
              f"{pages.get('high_water_pages', 0)}/"
              f"{pages.get('usable_pages', 0)} pages, "
              f"admissions={st['admissions']} evictions={st['evictions']} "
              f"preemptions={st['preemptions']}")
        print(f"[stats] kernel launches: {st['kernel_launches']}")


if __name__ == "__main__":
    main()
