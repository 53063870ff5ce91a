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
scheduler, as the ssm family ``--arch mamba2-130m`` does); ``--server``
submits every prompt to a threaded ``Server`` with a stream callback
instead of one batched ``generate`` call; ``--trace-dir DIR`` captures a
``torch.profiler`` trace of the serve (or of the Server's drains) into
``DIR`` (read it with ``scripts/torch_profile.py``'s breakdown); ``--mesh
data=N,model=M`` serves on a mesh of N x M ranks, one process a rank,
under ``torchrun --standalone --nproc_per_node N*M`` (with ``--device
cpu``, over gloo on the CPU), and prints ``[mesh] ...`` (only rank 0
prints; with ``--server`` rank 0 owns the Server and the other ranks
follow it).  A model
with
extra inputs (the vlm family's image embeddings, the audio family's frame
embeddings) gets random ones drawn from seed 0, one row a prompt, like its
weights (the reference's launcher gives zeros), and cannot be served
through ``--server``.

It first prints the hardware profile the tuning registry is keyed by
(``[hw] profile=... (flag|detected)``; ``--hardware`` names it, else
``$REPRO_TORCH_HARDWARE`` or the device decides) and the tuning files it
loaded (``[tuned] N configs from ...``; ``--tuned-dir`` reads another
directory than the package's ``tuned/``).  ``--stats`` also prints where
each decode GEMM's and prefill bucket's schedule came from.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs.catalog import get_config
from repro_torch.core import resolve_device, tuning_db
from repro_torch.core.hardware import find_profile, resolve_hardware
from repro_torch.core.registry import GLOBAL_REGISTRY
from repro_torch.distributed.sharding import rules_for_mesh
from repro_torch.launch.common import (add_common_args, add_serving_args,
                                       end_process_group, rank_zero_stdout)
from repro_torch.launch.mesh import build_mesh, describe_mesh, rank
from repro_torch.models import build_model
from repro_torch.profiling import trace
from repro_torch.serve import Engine, Request, ServeConfig, Server
from repro_torch.serve.server import follow


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
    with rank_zero_stdout():
        try:
            _main(argv)
        finally:
            end_process_group()


def _main(argv=None) -> None:
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
    add_serving_args(ap)
    add_common_args(ap)
    args = ap.parse_args(argv)

    hardware = resolve_hardware(args.hardware, resolve_device(args.device))
    prof = find_profile(hardware)
    print(f"[hw] profile={hardware} "
          f"platform={prof.platform if prof else 'unknown'} "
          f"({'flag' if args.hardware else 'detected'})")
    mesh = build_mesh(args.mesh, device=args.device)
    if mesh is not None:
        print(f"[mesh] {describe_mesh(mesh)}")
    # the files loaded here are the whole table: no lazy autoload of the
    # package's tuned/ under (or before) them
    GLOBAL_REGISTRY.clear()
    GLOBAL_REGISTRY.mark_autoloaded()
    loaded = tuning_db.load_all(GLOBAL_REGISTRY, args.tuned_dir)
    for path, count in loaded.items():
        print(f"[tuned] {count} configs from {path}")
    if not loaded:
        print("[tuned] no tuning DB found; using the profile's default "
              "schedules")

    cfg = get_config(args.arch)
    if args.server and build_model(cfg).extra_inputs(1):
        ap.error("--server cannot carry extra-input models "
                 "(extras are positional per drain)")
    if args.reduced:
        cfg = cfg.reduced()
    if args.attn_impl:
        cfg = dataclasses.replace(cfg, attention_impl=args.attn_impl)
    if args.kv_int8:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    model = build_model(cfg)
    # on a mesh each rank draws the weights whole, leaf by leaf, and keeps
    # its block under the engine's inference rules
    params = model.init(0, device=args.device, mesh=mesh,
                        rules=mesh and rules_for_mesh(mesh, fsdp=False))
    prompts = [[int(t) % cfg.vocab_size for t in p.split(",")]
               for p in args.prompts.split(";")]
    eng = Engine(model, params, ServeConfig(
        max_batch=args.max_batch or len(prompts),
        temperature=args.temperature,
        scheduler=args.scheduler, page_size=args.page_size,
        capacity_tokens=args.capacity_tokens, decode_chunk=args.decode_chunk,
        prefix_cache=not args.no_prefix_cache, device=args.device,
        hardware=hardware, mesh=mesh))
    gen = torch.Generator(device=eng.device).manual_seed(0)
    extra = {k: torch.randn(spec.shape, generator=gen,
                            device=eng.device).to(spec.dtype)
             for k, spec in model.extra_inputs(len(prompts)).items()}
    server = None
    with trace(args.trace_dir, enabled=bool(args.trace_dir)) as session:
        if args.server and rank() != 0:
            # rank 0's Server drives every rank's engine
            follow(eng)
            outs = []
        elif args.server:
            outs, server = _serve_with_server(eng, prompts, args.max_new)
        else:
            outs = eng.generate(prompts, args.max_new,
                                extra_inputs=extra or None)
    for p, o in zip(prompts, outs):
        print(f"prompt={p} -> {o}")
    if session.enabled:
        print(f"[trace] captured {len(session.trace_files())} trace file(s) "
              f"under {args.trace_dir}")
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
            print(f"[stats] paged KV: page_size={st['page_size']} "
                  f"({st['page_size_source']}), "
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
        print(f"[stats] hardware={st['hardware']} "
              f"platform={st['hardware_platform']}, registry resolutions "
              f"{st['registry_hit_stats']}")
        for shape, res in (st["decode_tile_lookups"] or {}).items():
            print(f"[tiles] decode gemm {shape}: {res['tile']} "
                  f"({res['source']}, matched {res['matched_shape']})")
        for shape, res in st["prefill_flash_lookups"].items():
            print(f"[tiles] prefill flash {shape}: {res['tile']} "
                  f"({res['source']}, matched {res['matched_shape']})")


if __name__ == "__main__":
    main()
