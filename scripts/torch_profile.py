#!/usr/bin/env python3
"""Profile the port's serve and train paths: where the device time goes.

    python scripts/torch_profile.py serve [--arch A] [--full] [--out F]
    python scripts/torch_profile.py train [--arch A] [--full] --steps 2
    python scripts/torch_profile.py diff PROFILE_a.json PROFILE_b.json

``serve`` and ``train`` run a workload twice: a warm-up pass (the kernels'
build, the allocator) outside the trace, then the measured pass under
``repro_torch.profiling.trace``.  The capture is rolled up into the
per-op-family breakdown (collective, GEMM, attention, host-transfer
device time, host syncs, the ``serve.*`` / ``train.*`` annotation spans,
each kernel's launching op) and written as a ``PROFILE_<kind>.json`` that
``validate_profile`` accepts, on the reference's schema, then rendered.
``diff`` compares two PROFILE files family by family, the port's or the
reference's (``scripts/profile.py``).

The workload is the reference's: ``--arch`` (default llama3.2-1b) reduced
unless ``--full``, random weights from seed 0, ``--batch`` prompts of
``--plen`` tokens decoding ``--max-new`` (serve) or ``--steps`` steps of
``--batch`` x ``--seq-len`` tokens from the synthetic pipeline (train); a
model with extra inputs (vlm, audio) gets seeded random embeddings.  It
runs on the card (``--device cpu`` runs the plain versions, e.g. in the
tests; its time is then host op time, ``timeline: host``).  ``--mesh
data=N,model=M`` runs it on a mesh of N x M ranks (one process a rank,
under ``torchrun --standalone --nproc_per_node N*M``; a world of one runs
alone), writes the mesh's label (``data1xmodel1``) as the blob's ``mesh``,
and counts the collectives (NCCL kernels on the card, the ``c10d::`` ops
on the CPU) in the ``collective`` family; rank 0 writes and prints.

Beside the breakdown stands the roofline of the step profiled (the
blob's ``roofline``, printed as ``[roofline]``): the same batch, length
and mesh traced once on fake tensors (``launch.dryrun.cell_record``), its
counts over the hardware profile's peaks (``launch.roofline``).  For
``serve`` that step is one decode step over the engine's ``--max-len``
cache, for ``train`` one train step, as the reference's
``scripts/profile.py`` bounds them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
# this directory's profile.py (the reference's CLI) would shadow the
# standard library's profile module, which torch imports
sys.path[:] = [os.path.join(os.path.dirname(HERE), "src")] + [
    p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]


def _fmt_us(us: float) -> str:
    return f"{us / 1e3:.2f}ms" if us >= 1e3 else f"{us:.0f}us"


def render(blob: dict) -> None:
    fams = blob["families"]
    print(f"\n[profile] kind={blob['kind']} hardware={blob['hardware']} "
          f"mesh={blob['mesh'] or 'single'} "
          f"timeline={blob.get('timeline', 'device')}")
    print(f"[profile] op time {_fmt_us(blob['totals']['op_us'])} over "
          f"wall {_fmt_us(blob['totals']['wall_us'])}; "
          f"host syncs: {blob['host_syncs']}")
    print("[profile] family breakdown:")
    for fam, e in fams.items():
        bar = "#" * int(round(e["fraction"] * 40))
        print(f"  {fam:14s} {_fmt_us(e['us']):>10s} {e['fraction']*100:5.1f}% "
              f"(n={e['count']:<5d}) {bar}")
    if blob.get("annotations"):
        print("[profile] annotated spans (wall time):")
        for name, e in blob["annotations"].items():
            print(f"  {name:22s} {_fmt_us(e['us']):>10s} (n={e['count']})")
    top = blob.get("top_ops") or []
    if top:
        ops = ", ".join(f"{o['name']}={_fmt_us(o['us'])}" for o in top[:6])
        print(f"[profile] top ops: {ops}")
    launchers = blob.get("device_us_by_launching_op") or {}
    if launchers:
        ops = ", ".join(f"{o}={_fmt_us(us)}"
                        for o, us in list(launchers.items())[:6])
        print(f"[profile] by launching op: {ops}")
    r = blob.get("roofline")
    if r:
        print(f"[roofline] analytic bounds on {r['hardware']} "
              f"({r['chips']} chip(s)): compute {r['compute_s']*1e6:.1f}us | "
              f"memory {r['memory_s']*1e6:.1f}us | "
              f"collective {r['collective_s']*1e6:.1f}us "
              f"-> dominant: {r['dominant']} (est. step "
              f"{r['est_step_s']*1e6:.1f}us, MFU proxy "
              f"{r['mfu_proxy']*100:.1f}%)")
        terms = {"compute": r["compute_s"], "memory": r["memory_s"],
                 "collective": r["collective_s"]}
        total = sum(terms.values()) or 1.0
        meas_coll = fams["collective"]["fraction"]
        print(f"[compare] collective share: measured {meas_coll*100:.1f}% "
              f"vs roofline {terms['collective']/total*100:.1f}%")


def _roofline(cfg, kind: str, batch: int, seq_len: int, mesh, rules,
              hardware: str):
    """The roofline row of one ``kind`` step of ``batch`` x ``seq_len``
    on ``mesh``, traced on fake tensors; None (with the reason printed)
    where it cannot be had: the roofline is advisory, never fatal."""
    try:
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.core.hardware import get_profile
        from repro_torch.launch.dryrun import cell_record
        from repro_torch.launch.roofline import roofline_row
        rec = cell_record(cfg, ShapeSpec(kind, seq_len, batch, kind), mesh,
                          rules)
        return roofline_row(rec, get_profile(hardware))
    except Exception as e:
        print(f"[roofline] skipped: {type(e).__name__}: {e}")
        return None


def _write(blob: dict, out: str) -> None:
    from repro_torch.launch.mesh import rank
    from repro_torch.profiling import validate_profile
    validate_profile(blob)
    if rank() != 0:
        return
    with open(out, "w") as f:
        json.dump(blob, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"[profile] wrote {out}")


def _setup(args):
    """(config, model, hardware, device, mesh) of the run."""
    from repro_torch.configs.catalog import get_config
    from repro_torch.core import resolve_device
    from repro_torch.core.hardware import resolve_hardware
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models import build_model
    device = resolve_device(args.device)
    hardware = resolve_hardware(args.hardware, device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    return (cfg, build_model(cfg), hardware, device,
            build_mesh(args.mesh, device=device))


def _extras(torch, model, n: int, seed: int, device):
    """Seeded random extra inputs (image or frame embeddings), n rows."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return {k: torch.randn(spec.shape, generator=gen, device=device).to(
        spec.dtype) for k, spec in model.extra_inputs(n).items()}


def cmd_serve(args) -> None:
    import torch

    from repro_torch.profiling import build_profile, trace
    from repro_torch.serve import Engine, ServeConfig

    from repro_torch.distributed.sharding import rules_for_mesh
    from repro_torch.launch.mesh import mesh_axis_label

    cfg, model, hardware, device, mesh = _setup(args)
    rules = mesh and rules_for_mesh(mesh, fsdp=False)
    params = model.init(0, device=device, mesh=mesh, rules=rules)
    prompts = [[(7 * i + j) % cfg.vocab_size for j in range(args.plen)]
               for i in range(args.batch)]
    extra = _extras(torch, model, args.batch, 0, device) or None
    eng = Engine(model, params, ServeConfig(
        max_batch=args.batch, max_len=args.max_len, profile=True,
        hardware=hardware, device=device, mesh=mesh))
    print("[profile] warmup (kernel builds, allocator; outside the trace)...")
    eng.generate(prompts, args.max_new, extra_inputs=extra)
    eng.clear_prefix_cache()        # the traced pass prefills its prompts
    before = eng.stats()
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="torch-trace-serve-")
    print(f"[profile] tracing into {trace_dir} ...")
    with trace(trace_dir):
        eng.generate(prompts, args.max_new, extra_inputs=extra)
    st = eng.stats()
    delta = {k: st[k] - before[k] for k in (
        "tokens_generated", "decode_seconds", "device_transfers", "waves",
        "chunks")}
    roof = _roofline(cfg, "decode", args.batch, args.max_len, mesh, rules,
                     hardware)
    blob = build_profile(
        "serving", trace_dir=trace_dir, hardware=hardware,
        mesh=mesh_axis_label(mesh), roofline=roof,
        extra={"engine": dict(
            delta, scheduler=st["scheduler"],
            decode_tok_s=(delta["tokens_generated"] / delta["decode_seconds"]
                          if delta["decode_seconds"] else 0.0))})
    _write(blob, args.out)
    render(blob)


def cmd_train(args) -> None:
    import torch

    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.optim import AdamW
    from repro_torch.profiling import annotate, build_profile, trace
    from repro_torch.train import Trainer, TrainerConfig, init_train_state

    from repro_torch.distributed.sharding import full
    from repro_torch.launch.mesh import mesh_axis_label

    cfg, model, hardware, device, mesh = _setup(args)
    opt = AdamW(learning_rate=1e-3)
    tokens = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=args.seq_len,
                                      global_batch=args.batch), device=device)

    def pipe(step):
        return dict(tokens(step), **_extras(torch, model, args.batch,
                                            1000 + step, device))
    trainer = Trainer(model, opt, pipe,
                      TrainerConfig(total_steps=args.steps + 1, log_every=10),
                      mesh=mesh)
    state = init_train_state(model, opt, 0, device=device, mesh=mesh,
                             rules=trainer.rules)
    print("[profile] warmup step (kernel builds, allocator; outside the "
          "trace)...")
    # one step at a time, through the loop's own entry: Trainer.run places
    # the state and batch and enters the mesh's activation policy
    trainer.cfg.total_steps = 1
    state, _ = trainer.run(state)
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="torch-trace-train-")
    print(f"[profile] tracing {args.steps} step(s) into {trace_dir} ...")
    trainer.cfg.total_steps = args.steps + 1
    with trace(trace_dir):
        state, _ = trainer.run(state, start_step=1)
        float(full(state.step))
    roof = _roofline(cfg, "train", args.batch, args.seq_len, mesh,
                     trainer.rules, hardware)
    blob = build_profile("training", trace_dir=trace_dir, hardware=hardware,
                         mesh=mesh_axis_label(mesh), roofline=roof,
                         extra={"steps_traced": args.steps})
    _write(blob, args.out)
    render(blob)


def cmd_diff(args) -> None:
    from repro_torch.profiling import FAMILIES, validate_profile
    with open(args.a) as f:
        a = validate_profile(json.load(f))
    with open(args.b) as f:
        b = validate_profile(json.load(f))
    print(f"[diff] A={args.a} (kind={a['kind']}, mesh={a['mesh']}) "
          f"vs B={args.b} (kind={b['kind']}, mesh={b['mesh']})")
    print(f"  {'family':14s} {'A':>10s} {'B':>10s} {'B/A':>7s}")
    for fam in FAMILIES:
        ua, ub = a["families"][fam]["us"], b["families"][fam]["us"]
        ratio = f"{ub / ua:.2f}x" if ua else "-"
        print(f"  {fam:14s} {_fmt_us(ua):>10s} {_fmt_us(ub):>10s} {ratio:>7s}")
    wa, wb = a["totals"]["wall_us"], b["totals"]["wall_us"]
    print(f"  {'wall':14s} {_fmt_us(wa):>10s} {_fmt_us(wb):>10s} "
          f"{(wb / wa if wa else 0):.2f}x")
    print(f"  host syncs: {a['host_syncs']} -> {b['host_syncs']}")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--arch", default="llama3.2-1b")
        p.add_argument("--full", action="store_true",
                       help="full-size config (default: reduced)")
        p.add_argument("--device", default=None,
                       help="torch device (default: cuda; 'cpu' runs the "
                            "plain versions)")
        p.add_argument("--hardware", default=None)
        p.add_argument("--mesh", default=None,
                       help="device mesh spec, e.g. data=1,model=1 "
                            "(default: single-device)")
        p.add_argument("--batch", type=int, default=8)
        p.add_argument("--trace-dir", default=None,
                       help="keep the raw trace here (default: temp dir)")

    ps = sub.add_parser("serve", help="profile a serve-engine generate call")
    common(ps)
    ps.add_argument("--plen", type=int, default=16)
    ps.add_argument("--max-new", type=int, default=16)
    ps.add_argument("--max-len", type=int, default=256)
    ps.add_argument("--out", default="PROFILE_serving.json")

    pt = sub.add_parser("train", help="profile training steps")
    common(pt)
    pt.add_argument("--steps", type=int, default=2)
    pt.add_argument("--seq-len", type=int, default=32)
    pt.add_argument("--out", default="PROFILE_training.json")

    pd = sub.add_parser("diff", help="compare two PROFILE_*.json files")
    pd.add_argument("a")
    pd.add_argument("b")

    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    from repro_torch.launch.common import end_process_group, rank_zero_stdout
    with rank_zero_stdout():
        try:
            {"serve": cmd_serve, "train": cmd_train,
             "diff": cmd_diff}[args.cmd](args)
        finally:
            end_process_group()


if __name__ == "__main__":
    main()
