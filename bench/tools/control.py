"""Readings that set a cell's limits, on the card: runs of the cell as the
benchmark runs them, each judged as a run is and, besides, with the
control in the program's place (the reference in float8 over the same
prompts and served tokens; see ``harness/check.py``), judged by the same
limits.  The benchmark's own runs never read the control.

    python bench/tools/control.py --workload <cell> --seeds 11,12,13 \
        [--seconds 51] [--out build/control.jsonl]

One JSON line a seed: whether the program's run is correct and whether
the control is (it must not be), each with its numbers beside their
limits, the run's info and metrics.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]
import run as bench_run  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args()
    from harness import catalog
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    cell = catalog.find_cell(a.workload)
    seconds = a.seconds or catalog.load_spec()["run_seconds"]
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        res = bench_run.run_cell(cell, seed, seconds, False, "cuda", t,
                                 control=True)
        line = json.dumps({"workload": a.workload, "seed": seed,
                           "correct": res["correct"],
                           "checks": res["checks"],
                           "control_correct": res["info"]["control"][
                               "correct"],
                           "info": res["info"],
                           "metrics": res["metrics"]})
        print(line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
        del res
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
