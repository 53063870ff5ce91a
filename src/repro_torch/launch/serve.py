"""Serving driver: generation with the Engine, or through the streaming Server.

  python -m repro_torch.launch.serve --arch llama3.2-1b --attn-impl flash \
      --prompts "1,2,3;4,5,6,7,8" --max-new 16 --stats

Runs on the card by default (the GEMM and flash-attention CUDA kernels are
built from ``repro_torch/kernels/csrc`` at first use); ``--device cpu`` runs
the kernels' plain versions instead, e.g. with ``--reduced``.  Weights are
random, drawn from seed 0.  ``--scheduler``, ``--page-size``,
``--capacity-tokens``, ``--decode-chunk`` and ``--no-prefix-cache`` set the
engine's ``ServeConfig``; ``--temperature`` samples instead of greedy
decoding; ``--kv-int8`` serves with an int8 KV cache (which runs the wave
scheduler); ``--server`` submits every prompt to a threaded ``Server`` with
a stream callback instead of one batched ``generate`` call.
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs.catalog import get_config
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request, ServeConfig, Server


def _serve_with_server(eng: Engine, prompts, max_new: int):
    """Every prompt through a Server with a stream callback; returns the
    tokens and the server's stats."""
    streamed = [[] for _ in prompts]
    with Server(eng) as srv:
        handles = [srv.submit(Request(
            prompt=p, max_new_tokens=max_new,
            stream=lambda e, i=i: streamed[i].append(e)))
            for i, p in enumerate(prompts)]
        outs = [h.result(timeout=600).tokens for h in handles]
    for events, toks in zip(streamed, outs):
        assert [e.token for e in events if not e.finished] == toks
    return outs, srv.stats()["server"]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prompts", default="1,2,3;7,8,9",
                    help="';'-separated comma-token prompts")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="KV-cache slots (default: number of prompts)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples (Gumbel-max, seed 0)")
    ap.add_argument("--attn-impl", choices=["chunked", "flash"], default=None,
                    help="override the config's attention implementation "
                         "(flash = the CUDA flash kernel for prefill)")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache (kv_quant; runs the wave scheduler)")
    ap.add_argument("--server", action="store_true",
                    help="serve through the threaded streaming Server "
                         "instead of one batched generate call")
    ap.add_argument("--scheduler", choices=["continuous", "wave"],
                    default="continuous",
                    help="continuous = paged KV + admit/evict at chunk "
                         "boundaries (default); wave = slot-per-request")
    ap.add_argument("--page-size", type=int, default=None,
                    help="paged-KV page size in tokens (default 16)")
    ap.add_argument("--capacity-tokens", type=int, default=None,
                    help="paged-pool capacity in tokens (default: "
                         "max_batch * max_len)")
    ap.add_argument("--decode-chunk", type=int, default=8,
                    help="tokens per decode chunk between scheduling "
                         "boundaries (power of two)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable shared-prefix KV reuse (continuous "
                         "scheduler only; on by default)")
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
    if args.kv_int8:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    model = build_model(cfg)
    params = model.init(0, device=args.device)
    prompts = [[int(t) % cfg.vocab_size for t in p.split(",")]
               for p in args.prompts.split(";")]
    eng = Engine(model, params, ServeConfig(
        max_batch=args.max_batch or len(prompts),
        temperature=args.temperature, profile=args.stats,
        scheduler=args.scheduler, page_size=args.page_size,
        capacity_tokens=args.capacity_tokens, decode_chunk=args.decode_chunk,
        prefix_cache=not args.no_prefix_cache, device=args.device))
    server = None
    if args.server:
        outs, server = _serve_with_server(eng, prompts, args.max_new)
    else:
        outs = eng.generate(prompts, args.max_new)
    for p, o in zip(prompts, outs):
        print(f"prompt={p} -> {o}")
    if args.stats:
        st = eng.stats()
        toks = st["tokens_generated"]
        dec_s = st["decode_seconds"] or 1e-9
        forced = (f" (forced: {st['scheduler_forced']})"
                  if st["scheduler_forced"] else "")
        print(f"[stats] device={st['device']} scheduler={st['scheduler']}"
              f"{forced}, temperature={args.temperature}, {int(toks)} "
              f"tokens, {int(st['waves'])} wave(s), {int(st['chunks'])} "
              f"chunk(s), {int(st['device_transfers'])} host transfer(s), "
              f"prefill {st['prefill_seconds']:.4f} s, "
              f"decode {toks / dec_s:.1f} tok/s")
        if st["scheduler"] == "continuous":
            pages = st["pages"] or {}
            print(f"[stats] paged KV: page_size={st['page_size']}, "
                  f"capacity={st['capacity_tokens']} tokens, high water "
                  f"{pages.get('high_water_pages', 0)}/"
                  f"{pages.get('usable_pages', 0)} pages, "
                  f"admissions={st['admissions']} "
                  f"evictions={st['evictions']} "
                  f"preemptions={st['preemptions']}")
        pc = st["prefix_cache"]
        if pc["enabled"]:
            print(f"[stats] prefix cache: hits full={pc['hits_full']} "
                  f"partial={pc['hits_partial']} misses={pc['misses']}, "
                  f"{pc['pinned_pages']} pinned pages")
        else:
            print("[stats] prefix cache: off")
        if server is not None:
            print(f"[stats] server: {server['served']} served, "
                  f"{server['failed_drains']} failed drains")
        print(f"[stats] kernel launches: {st['kernel_launches']}")


if __name__ == "__main__":
    main()
