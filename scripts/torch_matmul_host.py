#!/usr/bin/env python3
"""Host time of one ``core.matmul`` call at a decode shape, on the card.

    python3 scripts/torch_matmul_host.py [--src DIR] [--calls 200] [--rounds 50]

Calls ``repro_torch.core.matmul`` on bf16 operands of llama3.2-1b's decode
q/o projection (M = 8, K = N = 2048; the kernel runs ~8 us on the device)
``--calls`` times in a row, with no synchronize in between, and takes the
host wall clock of the loop over the call count; ``--rounds`` rounds, each
ending in a synchronize.  With fewer calls than the launch queue holds, the
loop measures the host's cost a launch: shape checks, the schedule lookup and
the launch.  Prints one JSON line with the median and the least round (us
a call), the card's name and power limit, and the ``src/`` it imported
(``--src`` points at another tree's, e.g. an unpacked earlier commit, so
two versions compare on one card: run them in turns).  Where the tree has
an ambient hardware context (``execution_context(hardware=...)``, as the
serve engine pins for a drain), it also times the calls inside one, and
the one part of the call the tuning registry changed, in one process:
the parent's schedule lookup (the ``lru_cache``'d hand table,
``gemm_tiles``) against the registry's (the launch-path hardware, the
capture check and ``GLOBAL_REGISTRY.lookup_op``), in alternating rounds
of ``timeit`` (``lookup``: us a call, their least and median, and the
median difference).  The loop's wall clock moves by several us between
processes on a shared host; the in-process difference does not.
Needs a CUDA device; there is no CPU fallback.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _rounds(torch, fn, calls: int, rounds: int):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return {"median_us": statistics.median(out), "min_us": min(out)}


def lookup_delta(torch, core, x, rounds: int = 20, number: int = 20000):
    """us a call of the parent's and the registry's schedule lookup for
    ``x`` at (8, 2048, 2048), timed in alternating rounds."""
    import timeit

    from repro_torch.core.gemm_api import _ctx
    from repro_torch.core.hardware import launch_hardware
    from repro_torch.core.tile_config import OP_GEMM, gemm_tiles
    reg = core.GLOBAL_REGISTRY

    # the two bodies differ where matmul's did: the capture check and the
    # schedule lookup (both fetch the ambient context, as matmul does)
    def parent():
        ctx = _ctx()
        if ctx.capture is not None:
            raise AssertionError("capturing")
        return gemm_tiles(x.dtype, 8, 2048, 2048) if x.is_cuda else None

    def change():
        ctx = _ctx()
        if ctx.capture is not None:
            raise AssertionError("capturing")
        return reg.lookup_op(OP_GEMM, ctx.hardware or launch_hardware(
            x.get_device()), x.dtype, (8, 2048, 2048)).config if x.is_cuda \
            else None

    assert parent() is not None and change() is not None
    times = {"parent": [], "change": []}
    for _ in range(rounds):
        for name, fn in (("parent", parent), ("change", change)):
            times[name].append(timeit.timeit(fn, number=number) / number * 1e6)
    out = {k: {"min_us": min(v), "median_us": statistics.median(v)}
           for k, v in times.items()}
    out["median_delta_us"] = statistics.median(
        c - p for c, p in zip(times["change"], times["parent"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=SRC)
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--rounds", type=int, default=50)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.src))
    import torch
    if not torch.cuda.is_available():
        print("torch_matmul_host: no CUDA device available", file=sys.stderr)
        return 2
    import repro_torch.core as core
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, 2048, generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn(2048, 2048, generator=gen, device="cuda")
         * 2048 ** -0.5).to(torch.bfloat16)
    line = {"src": os.path.abspath(args.src), "shape": [8, 2048, 2048],
            "calls": args.calls, "rounds": args.rounds,
            "bare": _rounds(torch, lambda: core.matmul(x, w), args.calls,
                            args.rounds)}
    if hasattr(core, "current_hardware"):
        with core.execution_context(hardware=core.current_hardware()):
            line["in_context"] = _rounds(torch, lambda: core.matmul(x, w),
                                         args.calls, args.rounds)
        line["lookup"] = lookup_delta(torch, core, x)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    line["card"] = smi.stdout.strip()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
