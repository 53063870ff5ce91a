#!/usr/bin/env python3
"""Time the GEMM kernel K1 under candidate schedules at the serving shapes.

    python scripts/torch_gemm_sweep.py [--reps 10] [--src DIR --table-only]

For each GEMM shape of llama3.2-1b's serving path (decode M = 8, prefill
M = 2048, the tied unembed) it times every candidate ``TileConfig`` of the
kernel that regime uses (``decode``: ring depth x split count; ``wgmma``:
tile width), the table's own pick and one ``torch.matmul`` as a yardstick,
each launch alone with CUDA events after an L2 flush, under both of
``chip_smoke.Timer``'s timers (``*_ms``: a dirty flush, as ``kernel_ms``;
``*_device_ms``: a clean flush and the device's time only).  It prints one
JSON line per shape, then the card's name and power limit.  The table in
``core/tile_config.py`` is set from the device-only times.

``--src DIR --table-only`` times only the table's pick of another tree's
``repro_torch`` (e.g. an unpacked earlier commit's ``src/``) with this
tree's timers, so two versions of the kernel compare in one process on one
card.  Needs a CUDA device; there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import dataclasses
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


def candidates(tile, k):
    """The schedules of ``tile``'s kernel that ``gemm.cu`` instantiates
    (read from its ``dispatch_*`` lines), by split count (``decode``) or
    raster grouping (``wgmma``)."""
    from repro_torch.core.tile_config import TileConfig
    from repro_torch.kernels.gemm import instantiated_schedules
    out = []
    for bm, bk, bn, stages in sorted(instantiated_schedules()[tile.kernel]):
        base = TileConfig(bm, bk, bn, kernel=tile.kernel, stages=stages)
        if tile.kernel == "decode":
            out += [dataclasses.replace(base, split_k=s)
                    for s in (1, 2, 4, 8, 16, 32) if s <= -(-k // bk)]
        else:
            out += [dataclasses.replace(base, group_m=g) for g in (1, 16)]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--table-only", action="store_true",
                    help="time the table's pick only, not the candidates")
    args = ap.parse_args(argv)
    import torch

    from chip_smoke import Timer, bound, smi
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core.tile_config import gemm_tiles
    from repro_torch.kernels.gemm import gemm_cuda

    if not torch.cuda.is_available():
        print("torch_gemm_sweep: no CUDA device available", file=sys.stderr)
        return 2
    timer, device_timer = Timer(torch), Timer(torch, device_only=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, m, k, n, kmajor, f32_out in SHAPES:
        a = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        b = (torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
             ).to(torch.bfloat16)
        b = b.t() if kmajor else b.t().contiguous()
        out = torch.float32 if f32_out else torch.bfloat16
        table = gemm_tiles(torch.bfloat16, m, k, n)
        name = getattr(table, "schedule", table.label)
        times, device_times = {}, {}
        for cand in [table] if args.table_only else candidates(table, k):
            run = lambda: gemm_cuda(a, b, config=cand, out_dtype=out)
            sched = getattr(cand, "schedule", cand.label)
            times[sched] = timer(run, reps=args.reps)
            device_times[sched] = device_timer(run, reps=args.reps)
        library = lambda: torch.matmul(a, b)
        nbytes = (m * k + k * n) * 2 + m * n * (4 if f32_out else 2)
        b_ms, b_by = bound(2.0 * m * n * k, nbytes, "bfloat16")
        best = min(device_times, key=device_times.get)
        print(json.dumps({
            "src": args.src, "shape": label, "mnk": [m, k, n], "table": name,
            "table_ms": times[name], "table_device_ms": device_times[name],
            "best": best, "best_device_ms": device_times[best],
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": timer(library, reps=args.reps),
            "library_device_ms": device_timer(library, reps=args.reps),
            "ms_by_schedule": times,
            "device_ms_by_schedule": device_times}), flush=True)
    print(smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
