#!/usr/bin/env python3
"""Where the serving time goes in the PyTorch/CUDA port, on one GPU.

    python scripts/torch_serve_profile.py [--arch NAME] [--walls N] [--src DIR]
        [--out DIR] [--scheduler continuous|wave] [--kv-int8]
        [--traffic random|shared-prefix] [--walls-only]

Serves the same workload as ``chip_smoke.py``'s serve phase (full-width
llama3.2-1b in bf16, flash prefill, 12 seeded requests, 8 slots,
``max_new=32``; ``--arch olmoe-1b-7b``, ``llama-3.2-vision-11b``,
``whisper-large-v3``, ``mamba2-130m`` or ``zamba2-2.7b`` serves that model
on it, the vlm and audio ones with seeded random image or frame
embeddings, mamba2-130m on the wave scheduler it is forced onto) once
to warm up, ``--walls`` times unprofiled, then once
under ``torch.profiler``.  ``--scheduler wave`` serves it on the wave
scheduler, ``--kv-int8`` with an int8 KV cache (which runs the wave
scheduler).  ``--traffic shared-prefix`` serves ``chip_smoke.py``'s
prefix-cache traffic warm instead: one engine, and each timed serve is the
warm drain (8 prompts sharing a 256-token prefix with fresh suffixes, and 4
repeats of cold prompts), each after ``clear_prefix_cache()`` and a cold
drain that is neither timed nor profiled.  It prints one JSON line: the unprofiled wall
times and their median, the device's busy time and idle share over the
run, and device time grouped by kernel family (the port's GEMM and flash
kernels, the decode attention's torch ops, the paged gather/scatter, and the
rest), plus the top kernels by device time.  ``--src`` serves another
tree's ``repro_torch`` (e.g. an unpacked earlier commit's ``src/``), so two
versions alternate under one script.  ``--out`` also writes the Chrome
trace there; ``--walls-only`` stops after the unprofiled walls and
prints them alone (the profiled serve of a large model takes minutes, a
cost parent-vs-change wall pairs do not need).  Needs a CUDA device;
there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

FAMILIES = (   # (family, substrings of the device kernel's name), first match
    ("gemm (port kernel)", ("gemm_decode_kernel", "gemm_wgmma_kernel",
                            "gemm_bf16_kernel", "gemm_simt_kernel",
                            "gemm_f32_kernel")),
    ("flash_attention (port kernel)", ("flash_fwd",)),
    ("decode attention matmuls (torch)", ("gemm", "sm90_xmma", "cutlass",
                                          "ampere", "sgemm", "Kernel2")),
    ("softmax / reductions (torch)", ("softmax", "reduce", "Reduce")),
    ("gather / scatter / copies (torch)", ("index", "Index", "copy", "Copy",
                                           "gather", "scatter", "cat")),
    ("elementwise (torch)", ("elementwise", "vectorized", "Elementwise")),
)


def family(name: str) -> str:
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"


def launching_ops(events, torch) -> dict:
    """Kernel name -> ``name.overload`` of a PyTorch op the profiler
    attaches a kernel of that name to (the MoE expert einsums' ``nvjet_*``
    kernels show ``aten::bmm``)."""
    out = {}
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CPU:
            for k in e.kernels:
                out.setdefault(k.name, f"{e.name}.{e.overload_name}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--arch", default="llama3.2-1b",
                    help="a ported catalog entry, served at full width")
    ap.add_argument("--walls", type=int, default=1,
                    help="unprofiled serves timed after the warm-up")
    ap.add_argument("--src", default=SRC,
                    help="the src/ directory whose repro_torch serves")
    ap.add_argument("--scheduler", choices=["continuous", "wave"],
                    default=None, help="ServeConfig.scheduler")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8 KV cache (runs the wave scheduler)")
    ap.add_argument("--traffic", choices=["random", "shared-prefix"],
                    default="random",
                    help="shared-prefix: the prefix cache's warm drain")
    ap.add_argument("--walls-only", action="store_true",
                    help="print the unprofiled walls and skip the profile")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.catalog import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import Engine, ServeConfig

    if not torch.cuda.is_available():
        print("torch_serve_profile: no CUDA device available", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cfg = dataclasses.replace(get_config(args.arch), dtype="bfloat16",
                              attention_impl="flash")
    params = build_model(cfg).init(seed=0, device="cuda")
    if args.kv_int8:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(5, 301, size=12)]
    # extra inputs (vlm image or audio frame embeddings): seeded, on the card
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    extra = {k: torch.randn(spec.shape, generator=gen, device="cuda").to(
        spec.dtype) for k, spec in model.extra_inputs(12).items()} or None
    # only the keys asked for, so a --src tree without them still serves
    serve_kw = dict(max_batch=8, max_len=1024, decode_chunk=8)
    if args.scheduler:
        serve_kw["scheduler"] = args.scheduler

    def prepare():
        pass

    def serve():
        eng = Engine(model, params, ServeConfig(**serve_kw))
        t0 = time.perf_counter()
        eng.generate(prompts, 32, **({"extra_inputs": extra} if extra else {}))
        torch.cuda.synchronize()
        return time.perf_counter() - t0, eng.stats()

    if args.traffic == "shared-prefix":
        if extra:
            ap.error("--traffic shared-prefix serves models without extra "
                     "inputs (the prefix cache skips requests with them)")
        sys.path.insert(0, os.path.join(os.path.dirname(SRC)))
        from chip_smoke import drain, prefix_traffic
        from repro_torch.serve import Request
        prng = np.random.default_rng(1)
        prefix = prng.integers(0, cfg.vocab_size, size=256).tolist()
        cold = prefix_traffic(prng, cfg.vocab_size, prefix, None)
        warm = prefix_traffic(prng, cfg.vocab_size, prefix, cold)
        eng = Engine(model, params, ServeConfig(page_size=16, **serve_kw))

        def prepare():                                     # noqa: F811
            eng.clear_prefix_cache()
            drain(eng, Request, cold, 32)
            torch.cuda.synchronize()

        def serve():                                       # noqa: F811
            before = eng.stats()
            t0 = time.perf_counter()
            drain(eng, Request, warm, 32)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = eng.stats()
            st["warm_hits"] = {k: st["prefix_cache"][k]
                               - before["prefix_cache"][k]
                               for k in ("hits_full", "hits_partial",
                                         "misses")}
            for k in ("tokens_generated", "chunks"):    # the warm drain's
                st[k] -= before[k]
            return wall, st

    def timed():
        prepare()                               # untimed, unprofiled
        return serve()

    timed()                                     # warm-up: builds, allocator
    walls = [timed()[0] for _ in range(args.walls)]   # the same run, unprofiled
    wall_plain = statistics.median(walls)
    if args.walls_only:
        print(json.dumps({"card": card, "arch": args.arch, "src": args.src,
                          "walls_unprofiled": walls,
                          "wall_seconds_unprofiled": wall_plain}), flush=True)
        return 0
    prepare()
    torch.cuda.reset_peak_memory_stats()        # peak_mem_gb: this serve's
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall, st = serve()
    events = [e for e in prof.events()
              if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    by_family, by_name = {}, {}
    for e in events:
        us = e.time_range.end - e.time_range.start
        by_family[family(e.name)] = by_family.get(family(e.name), 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy_s = sum(by_family.values()) / 1e6
    op_of_name = launching_ops(prof.events(), torch)
    gemm_by_kernel = {}
    for name, us in by_name.items():
        for kern in FAMILIES[0][1]:
            if kern in name:
                gemm_by_kernel[kern] = gemm_by_kernel.get(kern, 0.0) + us / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    out = {
        "card": card, "arch": args.arch, "src": args.src,
        "walls_unprofiled": walls,
        "wall_seconds_unprofiled": wall_plain,
        "wall_seconds": wall, "tokens": st["tokens_generated"],
        "chunks": st["chunks"], "waves": st.get("waves"),
        "scheduler": st["scheduler"], "traffic": args.traffic,
        "warm_hits": st.get("warm_hits"),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "device_kernels": len(events),
        "device_busy_seconds": busy_s,
        "device_idle_share": (1 - busy_s / wall) if events else None,
        "device_idle_share_unprofiled": (1 - busy_s / wall_plain) if events
        else None,
        "device_seconds_by_family": {k: v / 1e6 for k, v in sorted(
            by_family.items(), key=lambda kv: -kv[1])},
        "gemm_seconds_by_kernel": gemm_by_kernel,
        "gemm_share_of_busy": (by_family.get(FAMILIES[0][0], 0.0) / 1e6 / busy_s
                               if events else None),
        "top_kernels_seconds": [[n[:90], v / 1e6, op_of_name.get(n)]
                                for n, v in top],
        "kernel_launches": st["kernel_launches"],
    }
    print(json.dumps(out), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.out, "serve_trace.json"))
    return 0 if events else 1


if __name__ == "__main__":
    sys.exit(main())
