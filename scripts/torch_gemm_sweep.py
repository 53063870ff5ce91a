#!/usr/bin/env python3
"""Time the GEMM kernel K1 under candidate schedules at the serving shapes.

    python scripts/torch_gemm_sweep.py [--reps 10] [--f32]
                                       [--src DIR --table-only]

For each GEMM shape of llama3.2-1b's serving path (decode M = 8, prefill
M = 2048, the tied unembed), or with ``--f32`` each f32 product of the
five train phases (the unembed's dX and dW over its f32 cotangent,
operands laid out as the step lays them out, f32 out), it times the
tuner's candidates
(``core.tile_config.TuningSpace``: the regime's instantiated schedules by
split count or raster grouping, the hand table's own pick among them) and
one ``torch.matmul`` as a yardstick (``--f32``: also the ``fma`` kernel,
the earlier f32 path, and whether each candidate gives its bits),
each launch alone with CUDA events after an L2 flush, under both of
``chip_smoke.Timer``'s timers (``*_ms``: a dirty flush, as ``kernel_ms``;
``*_device_ms``: a clean flush and the device's time only).  It prints one
JSON line per shape, then the card's name and power limit.  The hand
table in ``core/tile_config.py`` was set from the device-only times; the
committed per-shape table comes from ``scripts/torch_tune.py``.

``--src DIR --table-only`` times only the table's pick of another tree's
``repro_torch`` (e.g. an unpacked earlier commit's ``src/``) with this
tree's timers, so two versions of the kernel compare in one process on one
card.  Needs a CUDA device; there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

#: (label, M, K, N, B K-major, out f32)
SHAPES = (
    ("decode q/o", 8, 2048, 2048, False, False),
    ("decode k/v", 8, 2048, 512, False, False),
    ("decode gate/up", 8, 2048, 8192, False, False),
    ("decode down", 8, 8192, 2048, False, False),
    ("unembed", 8, 2048, 128256, True, True),
    ("prefill q/o", 2048, 2048, 2048, False, False),
    ("prefill k/v", 2048, 2048, 512, False, False),
    ("prefill gate/up", 2048, 2048, 8192, False, False),
    ("prefill down", 2048, 8192, 2048, False, False),
)
#: the train phases' f32 products: (label, M, K, N, B K-major).  dX = dZ @
#: W.T reads a tied or K-major head's W.T row-major, an untied row-major
#: head's K-major; dW = X.T @ dZ reads the cotangent row-major.
F32_SHAPES = (
    ("llama3.2-1b unembed dX", 4096, 128256, 2048, False),
    ("llama3.2-1b unembed dW", 2048, 4096, 128256, False),
    ("llama-3.2-vision-11b unembed dX", 2048, 128256, 4096, True),
    ("llama-3.2-vision-11b unembed dW", 4096, 2048, 128256, False),
    ("zamba2-2.7b unembed dX", 4096, 32000, 2560, True),
    ("zamba2-2.7b unembed dW", 2560, 4096, 32000, False),
    ("whisper-large-v3 unembed dX", 4096, 51866, 1280, False),
    ("whisper-large-v3 unembed dW", 1280, 4096, 51866, False),
    ("mamba2-130m unembed dX", 4096, 50280, 768, False),
    ("mamba2-130m unembed dW", 768, 4096, 50280, False),
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--table-only", action="store_true",
                    help="time the table's pick only, not the candidates")
    ap.add_argument("--f32", action="store_true",
                    help="the train phases' f32 products, not llama's serving")
    args = ap.parse_args(argv)
    import torch

    from chip_smoke import Timer, bound, smi
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core.tile_config import TileConfig, gemm_tiles
    from repro_torch.kernels.gemm import gemm_cuda
    if not args.table_only:
        from repro_torch.core.tile_config import TuningSpace

    if not torch.cuda.is_available():
        print("torch_gemm_sweep: no CUDA device available", file=sys.stderr)
        return 2
    timer, device_timer = Timer(torch), Timer(torch, device_only=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    dtype = torch.float32 if args.f32 else torch.bfloat16
    shapes = ([(label, m, k, n, kmajor, True)
               for label, m, k, n, kmajor in F32_SHAPES] if args.f32
              else SHAPES)
    for label, m, k, n, kmajor, f32_out in shapes:
        a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        b = (torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
             ).to(dtype)
        b = b.t() if kmajor else b.t().contiguous()
        out = torch.float32 if f32_out else torch.bfloat16
        table = gemm_tiles(dtype, m, k, n)
        name = getattr(table, "schedule", table.label)
        times, device_times, bits = {}, {}, {}
        yard = None
        if args.f32:
            fma = TileConfig(64, 16, 64, kernel="fma")
            yard = gemm_cuda(a, b, config=fma, out_dtype=out)
            run = lambda: gemm_cuda(a, b, config=fma, out_dtype=out)
            device_times[fma.schedule] = device_timer(run, reps=args.reps)
        for cand in [table] if args.table_only else TuningSpace().candidates(
                dtype, m, k, n):
            run = lambda: gemm_cuda(a, b, config=cand, out_dtype=out)
            sched = getattr(cand, "schedule", cand.label)
            if yard is not None:
                bits[sched] = bool(torch.equal(run(), yard))
            times[sched] = timer(run, reps=args.reps)
            device_times[sched] = device_timer(run, reps=args.reps)
        del yard
        library = lambda: torch.matmul(a, b)
        size = a.element_size()
        nbytes = (m * k + k * n) * size + m * n * (4 if f32_out else 2)
        b_ms, b_by = bound(2.0 * m * n * k, nbytes, str(dtype).split(".")[1])
        best = min((s for s in device_times if s in times),
                   key=device_times.get)
        print(json.dumps({
            "src": args.src, "shape": label, "mnk": [m, k, n], "table": name,
            "table_ms": times[name], "table_device_ms": device_times[name],
            "best": best, "best_device_ms": device_times[best],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer(library, reps=args.reps),
            "library_device_ms": device_timer(library, reps=args.reps),
            "ms_by_schedule": times,
            "device_ms_by_schedule": device_times,
            "bit_equal_fma_by_schedule": bits}), flush=True)
    print(smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
