"""Run one cell of the benchmark once and print its result line.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic and metrics are found by name (see
``harness/catalog.py``).  The run makes the weights and the traffic from
the seed, warms the admission buckets the traffic uses, starts the
clients, measures for ``--seconds`` seconds on the host's clock (with
``--trace 1`` also traces a slice of the window), closes the window, and
judges a sample of the finished requests against the plain reference.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and with a trace
``breakdown``), then ``checks``, each number compared beside its limit,
which the last lines of standard error repeat.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]
# every build and kernel cache of the program inside the checkout, at a
# fixed path (the program's own CUDA build lives under build/ already)
for _var, _dir in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = str(ROOT / "build" / "bench_cache" / _dir)

#: top-level modules that may not be loaded by the end of a run
BANNED = ("jax", "jaxlib", "flax", "repro")


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def card(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def power_limit() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_process: float, control: bool = False) -> dict:
    """One run of ``cell`` on ``device``: the result's keys as printed."""
    import torch

    from harness import catalog, check, measure, weights
    from harness.loop import ClosedLoop, WindowClosed
    from harness.trace import Tracer
    from harness.traffic import Traffic
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.server import Server

    phases = {"imports": time.perf_counter() - t_process}
    mark = time.perf_counter()

    def phase(name):
        nonlocal mark
        now = time.perf_counter()
        phases[name] = now - mark
        mark = now

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t = cell.traffic
    mcfg = cell.config["model"]
    eng = cell.config["engine"]
    model = build_model(ModelConfig(**mcfg))
    params = weights.make(model.template, seed, getattr(torch, mcfg["dtype"]),
                          dev)
    if on_card:
        torch.cuda.synchronize(dev)
    phase("weights")
    engine = Engine(model, params, ServeConfig(
        max_batch=int(t["slots"]), max_len=int(t["max_len"]),
        scheduler=eng["scheduler"], decode_chunk=int(eng["decode_chunk"]),
        prefix_cache=bool(eng["prefix_cache"]), device=device))
    traffic = Traffic(t, mcfg["vocab_size"], seed)
    # the token ids of more requests than a run sends (info.drawn_late
    # counts any beyond them)
    traffic.prepare(4 * int(t["clients"]))

    # warm-up: one full admission at each prompt bucket the traffic can
    # fill, then one decode chunk over every slot
    for b in traffic.buckets():
        engine.generate(traffic.warm_prompts(b, int(t["slots"])),
                        max_new_tokens=int(eng["decode_chunk"]))
        phase(f"warm_{b}")
    engine.clear_prefix_cache()
    tracer = None
    if trace:
        tracer = Tracer(t["trace"]["after_s"], t["trace"]["boundaries"],
                        on_card)
        tracer.warm()
    if on_card:
        torch.cuda.synchronize(dev)

    loop = ClosedLoop(Server, engine, traffic, int(t["slots"]),
                      int(eng["decode_chunk"]),
                      on_boundary=tracer.on_boundary if tracer else None)
    loop.start(int(t["clients"]), min(int(t["clients"]), int(t["slots"])),
               timeout_s=300.0)
    phase("fill")
    # what set-up made stays: the collector's full passes skip it
    gc.freeze()
    t0 = time.perf_counter()
    if tracer:
        tracer.t0 = t0
    t1 = t0 + seconds
    while time.perf_counter() < t1:
        time.sleep(min(0.05, max(t1 - time.perf_counter(), 0.0)))
    if tracer:
        tracer.cut()
    # the pass in flight at the close is waited for: the window's rate
    # ends at the first boundary at or after t1, and that pass has
    # delivered every token once the boundary after it has begun
    deadline = t1 + 120.0
    while sum(x >= t1 for x in loop.boundary_times) < 2 and \
            time.perf_counter() < deadline:
        time.sleep(0.005)
    loop.close()
    gc.unfreeze()
    dev_info = card(torch, dev)

    failed = 0
    for q in loop.recs:
        h = q.handle
        if h is not None and h.done and q.reason is None:
            try:
                h.result(timeout=0)
            except WindowClosed:
                pass
            except Exception as exc:       # noqa: BLE001 - a failed request
                q.error = repr(exc)
                failed += 1
        # a failed handle's exception holds the engine's frames
        q.handle = None

    rec = measure.Record(
        cell=cell.name, cfg=mcfg, traffic=t, seconds=seconds, t0=t0, t1=t1,
        setup_s=t0 - t_process, recs=loop.recs,
        boundary_times=loop.boundary_times,
        decode_chunk=int(eng["decode_chunk"]))
    result = {"correct": False,
              "attempted": sum(q.t_submit < t1 for q in loop.recs),
              "failed": failed}
    if trace:
        path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                            f"bench_trace_{os.getpid()}.json")
        rec.trace = tracer.export(path)
        rec.k_start, rec.k_stop = tracer.k_start, tracer.k_stop
        if os.path.exists(path):
            os.remove(path)
        result["metrics"] = catalog.read_metrics(cell.per_layer, rec)
        dev_info["busy_s"] = rec.trace.busy_s if rec.trace else 0.0
        dev_info["window_s"] = rec.trace.window_s if rec.trace else 0.0
    else:
        result["metrics"] = catalog.read_metrics(cell.end_to_end, rec)
    result["device"] = dev_info
    if trace and rec.trace is not None:
        result["breakdown"] = {"device_ops": rec.trace.top_device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    result["info"] = {
        "admissions_in_window": measure.window_admissions(rec),
        "completed_in_window": sum(q.t_done is not None and t0 <= q.t_done < t1
                                   for q in loop.recs),
        "tokens_in_window": measure.window_tokens(rec),
        "boundaries_in_window": sum(t0 <= x < t1 for x in loop.boundary_times),
        "restarts": sum(q.restarts for q in loop.recs),
        "drawn_late": traffic.drawn_late,
        "traced_boundaries": (None if not trace else
                              [tracer.k_start, tracer.k_stop]),
        "card": power_limit() if on_card else "cpu",
        "setup_phases_s": phases,
    }

    # the program's state goes before the reference runs
    recs = loop.recs
    del loop, engine, rec
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, gap_stats, ctl = check.judge(mcfg, cell.traffic["check"],
                                         weights.flat(params), recs, t0, t1,
                                         seed, failed, control=control)
    result["info"]["logit_gaps"] = gap_stats
    if control:
        result["info"]["control"] = {"correct": check.passed(ctl),
                                     "checks": ctl}
    result["info"]["check_s"] = time.perf_counter() - t_check
    result["correct"] = check.passed(checks)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = _args(argv)
    from harness import catalog
    cell = catalog.find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_PROCESS)
    loaded = banned_modules()
    if loaded:
        print(f"bench: modules loaded that the run may not load: {loaded}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        op = ">=" if c.get("at_least") else "<="
        print(f"check {name}: {c['value']} {op} {c['limit']}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
