"""Roofline analysis over dry-run records.

Three terms per (arch x shape x mesh) cell, in seconds a step, against one
hardware profile (default ``h100``: 989 TFLOP/s bf16 and 67 TFLOP/s f32,
3.35 TB/s HBM, 50 GB/s an NVLink link; ``--hardware`` picks another):

  compute    = sum over dtypes of that dtype's flops / its peak
  memory     = traffic bytes per device / HBM rate
  collective = per-device link bytes (ring model) / link rate

The counts come from ``launch.dryrun``'s ``step_stats`` (each device's
products, the bytes eager PyTorch moves, the collectives DTensor issues).
``compute_bf16_peak_s`` keeps the reference's compute term, every flop at
the bf16 peak, beside the port's: an f32 product (the unembed's backward
on the card's FMA path) runs at 1/15 of that rate.  MODEL_FLOPS = 6 N D
(train) or 2 N D (inference), N the active parameters.  ``model_hlo_ratio``
is MODEL_FLOPS over the counted flops (the name is the reference's: the
"HLO" is here the traced step); below 1 it flags remat or redundant
compute.  The dominant term is the bottleneck to work on.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --results results/torch_dryrun.json
  ... --emit markdown   (a table)
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from repro_torch.core.hardware import H100, HardwareProfile, get_profile

RESULTS_DEFAULT = "results/torch_dryrun.json"


def compute_seconds(flops_by_dtype: Dict[str, float],
                    profile: HardwareProfile) -> float:
    """Each dtype's flops over its own peak (a dtype the profile has no
    peak for, int8 say, at the bf16 one)."""
    bf16 = profile.peak_flops["bfloat16"]
    return sum(f / profile.peak_flops.get(dt, bf16)
               for dt, f in flops_by_dtype.items())


def roofline_row(rec: dict,
                 profile: HardwareProfile = H100) -> Optional[dict]:
    if rec.get("status") != "OK":
        return None
    peak = profile.peak_flops["bfloat16"]
    ss = rec["step_stats"]
    chips = rec["chips"]
    compute_s = compute_seconds(ss["flops_by_dtype"], profile)
    memory_s = ss["traffic_bytes"] / profile.hbm_bandwidth
    collective_s = ss["collective_link_bytes"] / profile.link_bandwidth
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    est_step = max(terms.values())
    model_flops_dev = rec["model_flops"] / chips
    ratio = model_flops_dev / ss["flops"] if ss["flops"] else 0.0
    # MFU proxy: useful model flops a second against the bf16 peak, at the
    # bottleneck-bound step time (the "fraction of roofline" score)
    mfu = model_flops_dev / est_step / peak if est_step else 0.0
    hw_util = ss["flops"] / est_step / peak if est_step else 0.0
    return {
        "hardware": profile.name,
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "kind": rec["kind"], "chips": chips,
        "compute_s": compute_s, "memory_s": memory_s,
        "collective_s": collective_s, "dominant": dominant,
        "est_step_s": est_step, "model_flops": rec["model_flops"],
        "model_hlo_ratio": ratio, "mfu_proxy": mfu, "hw_util": hw_util,
        "collective_count": ss["collective_count"],
        "compute_bf16_peak_s": ss["flops"] / peak,
        "flops_by_dtype": dict(ss["flops_by_dtype"]),
        "peak_bytes": rec.get("memory", {}).get("peak_bytes"),
    }


_ADVICE = {
    "compute": ("cut issued FLOPs or move them onto the tensor cores: a "
                "lighter remat policy (dots), bf16 operands for the f32 "
                "products (the unembed's backward runs on FMA at 67 of 989 "
                "TFLOP/s), larger fused GEMMs for wgmma occupancy"),
    "memory": ("raise arithmetic intensity: fuse the elementwise chains "
               "eager PyTorch runs one kernel each (epilogues, norms, "
               "RoPE), chunk the vocab unembed, keep KV/states in bf16 or "
               "int8, batch more decode rows per weight read from HBM"),
    "collective": ("cut NVLink bytes: reduce-scatter + all-gather instead "
                   "of all-reduce, int8 gradient compression on the DP "
                   "axis, overlap TP collectives with the next block's "
                   "GEMMs on another stream"),
}


def advice(row: dict) -> str:
    return _ADVICE[row["dominant"]]


def fmt_s(x: float) -> str:
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def markdown_table(rows: List[dict], skips: List[dict]) -> str:
    out = ["| arch | shape | mesh | kind | compute | memory | collective | "
           "dominant | MODEL/HLO | MFU-proxy |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['kind']} | "
            f"{fmt_s(r['compute_s'])} | {fmt_s(r['memory_s'])} | "
            f"{fmt_s(r['collective_s'])} | **{r['dominant']}** | "
            f"{r['model_hlo_ratio']:.2f} | {r['mfu_proxy'] * 100:.1f}% |")
    for s in sorted(skips, key=lambda r: (r["arch"], r["shape"])):
        out.append(f"| {s['arch']} | {s['shape']} | {s['mesh']} | — | SKIP | "
                   f"| | | | |")
    return "\n".join(out)


def load_rows(path: str, mesh: Optional[str] = None,
              profile: HardwareProfile = H100):
    with open(path) as f:
        results = json.load(f)
    rows, skips = [], []
    for key, rec in results.items():
        if mesh and rec.get("mesh") != mesh:
            continue
        if "#" in key or "tag" in rec:   # perf-iteration runs: --emit perf
            continue
        if rec.get("status") == "SKIP":
            skips.append(rec)
            continue
        row = roofline_row(rec, profile)
        if row:
            rows.append(row)
    return rows, skips


def perf_compare(path: str, profile: HardwareProfile = H100) -> str:
    """Baseline against tagged (``--tag``) runs of the same cell."""
    with open(path) as f:
        results = json.load(f)
    by_cell: Dict[str, List] = {}
    for key, rec in results.items():
        if rec.get("status") != "OK":
            continue
        cell, _, tag = key.partition("#")
        by_cell.setdefault(cell, []).append((tag or "baseline", rec))
    out = []
    for cell, entries in sorted(by_cell.items()):
        if len(entries) < 2:
            continue
        out.append(f"\n== {cell} ==")
        entries.sort(key=lambda e: (e[0] != "baseline", e[0]))
        base = None
        for tag, rec in entries:
            r = roofline_row(rec, profile)
            line = (f"  {tag:16s} C={fmt_s(r['compute_s']):>8s} "
                    f"M={fmt_s(r['memory_s']):>8s} X={fmt_s(r['collective_s']):>8s}"
                    f" dom={r['dominant']:10s} step={fmt_s(r['est_step_s']):>8s}"
                    f" mfu={r['mfu_proxy'] * 100:5.1f}%")
            if base is None:
                base = r
            else:
                line += f"  [step x{base['est_step_s'] / r['est_step_s']:.2f}]"
            out.append(line)
    return "\n".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=RESULTS_DEFAULT)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--emit", default="text",
                    choices=["text", "markdown", "json", "perf"])
    ap.add_argument("--hardware", default=H100.name,
                    help="hardware profile whose peaks bound the roofline "
                         "(default: h100)")
    args = ap.parse_args(argv)
    profile = get_profile(args.hardware)

    if args.emit == "perf":
        print(perf_compare(args.results, profile))
        return

    rows, skips = load_rows(args.results, args.mesh, profile)
    if args.emit == "json":
        print(json.dumps(rows, indent=1))
        return
    if args.emit == "markdown":
        print(markdown_table(rows, skips))
        return
    for r in sorted(rows, key=lambda r: r["est_step_s"], reverse=True):
        print(f"{r['arch']:26s} {r['shape']:12s} {r['mesh']:6s} "
              f"C={fmt_s(r['compute_s']):>8s} M={fmt_s(r['memory_s']):>8s} "
              f"X={fmt_s(r['collective_s']):>8s} dom={r['dominant']:10s} "
              f"ratio={r['model_hlo_ratio']:.2f} mfu={r['mfu_proxy'] * 100:5.1f}%")
        print(f"{'':26s} -> {advice(r)}")
    for s in skips:
        print(f"{s['arch']:26s} {s['shape']:12s} SKIP: {s['reason'][:80]}")


if __name__ == "__main__":
    main()
