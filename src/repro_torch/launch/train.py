"""Training launcher.

  python -m repro_torch.launch.train --arch llama3.2-1b --steps 100 \
      --seq-len 512 --batch 8 --ckpt-dir ckpt --stats

Runs on the card by default (the GEMM kernel, built from
``repro_torch/kernels/csrc`` at first use, runs every product of the
forward and the backward); ``--device cpu`` runs the plain versions, e.g.
with ``--reduced``.  Weights are random, drawn from seed 0; the data is the
synthetic pipeline (seed 0).  ``--resume`` restarts from the latest
checkpoint in ``--ckpt-dir``: deterministic data and atomic checkpoints
make the restart replay the interrupted run.  The learning rate follows
``warmup_cosine(--lr, 10, --steps)``.

It first prints the hardware profile the tuning registry is keyed by and
the tuning files it loaded, as ``launch.serve`` does; then the model, one
``step N  loss L`` line every 10 steps, ``done at step N``, and with
``--stats`` the step rate and tokens/s.  ``--trace-dir DIR`` captures a
``torch.profiler`` trace of the run into ``DIR``, one ``train.step`` range
a step.  ``--mesh data=N,model=M`` trains on a mesh of N x M ranks (FSDP
over ``data``, tensor parallel over ``model``), one process a rank, under
``torchrun --standalone --nproc_per_node N*M``, and prints ``[mesh] ...``
(only rank 0 prints); the retired ``--mesh-data`` / ``--mesh-model`` warn
and forward onto ``--mesh``.

The dense, moe, ssm and hybrid families train here.  The vlm and audio
families need image or frame embeddings beside the tokens, which the token
pipeline does not make (nor does the reference's launcher): it refuses
them.  ``make_train_step`` and ``Trainer`` train them on batches that
carry those inputs.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.catalog import get_config
from repro_torch.core import execution_context, resolve_device, tuning_db
from repro_torch.core.hardware import find_profile, resolve_hardware
from repro_torch.core.registry import GLOBAL_REGISTRY
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.distributed.sharding import full, rules_for_mesh
from repro_torch.launch.common import (add_common_args, deprecated_flag,
                                       end_process_group, rank_zero_stdout)
from repro_torch.launch.mesh import build_mesh, describe_mesh
from repro_torch.models import build_model
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.profiling import trace
from repro_torch.train import (Trainer, TrainerConfig, abstract_train_state,
                               init_train_state)


def parse_args(argv=None) -> argparse.Namespace:
    """The launcher's flags, with the retired ``--mesh-data`` /
    ``--mesh-model`` forwarded onto ``--mesh`` (which wins when given)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-topology config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--step-deadline-s", type=float, default=None)
    add_common_args(ap)
    # retired in favour of the one --mesh spec; warn and forward
    deprecated_flag(ap, "--mesh-data", "--mesh", type=int)
    deprecated_flag(ap, "--mesh-model", "--mesh", type=int)
    args = ap.parse_args(argv)
    used = getattr(args, "_deprecated_used", set())
    if {"mesh_data", "mesh_model"} & used and not args.mesh:
        data, model_ax = args.mesh_data or 1, args.mesh_model or 1
        if data * model_ax > 1:
            args.mesh = f"data={data},model={model_ax}"
    return args


def main(argv=None) -> None:
    with rank_zero_stdout():
        try:
            _main(argv)
        finally:
            end_process_group()


def _main(argv=None) -> None:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if cfg.family in ("vlm", "audio"):
        raise SystemExit(
            f"{cfg.name}: the {cfg.family} family needs "
            f"{'image' if cfg.family == 'vlm' else 'frame'} embeddings "
            "beside the tokens, which the token pipeline does not make; "
            "train it through make_train_step or Trainer with a batch that "
            "carries them")

    device = resolve_device(args.device)
    hardware = resolve_hardware(args.hardware, device)
    prof = find_profile(hardware)
    print(f"[hw] profile={hardware} "
          f"platform={prof.platform if prof else 'unknown'} "
          f"({'flag' if args.hardware else 'detected'})")
    mesh = build_mesh(args.mesh, device=device)
    rules = None
    if mesh is not None:
        rules = rules_for_mesh(mesh)
        print(f"[mesh] {describe_mesh(mesh)} rules={rules}")
    GLOBAL_REGISTRY.clear()
    GLOBAL_REGISTRY.mark_autoloaded()
    loaded = tuning_db.load_all(GLOBAL_REGISTRY, args.tuned_dir)
    for path, count in loaded.items():
        print(f"[tuned] {count} configs from {path}")
    if not loaded:
        print("[tuned] no tuning DB found; using the profile's default "
              "schedules")

    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={model.param_count() / 1e6:.1f}M device={device}")

    opt = AdamW(learning_rate=warmup_cosine(args.lr, 10, args.steps))
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=args.seq_len,
                                    global_batch=args.batch), device=device)
    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    tcfg = TrainerConfig(total_steps=args.steps, log_every=10,
                         checkpoint_every=args.ckpt_every,
                         microbatches=args.microbatches,
                         use_compression=args.compress_grads,
                         step_deadline_s=args.step_deadline_s)
    trainer = Trainer(model, opt, pipe, tcfg, checkpointer=ck, mesh=mesh,
                      rules=rules)

    start = 0
    if args.resume and ck is not None and ck.latest_step() is not None:
        start = ck.latest_step()
        state = ck.restore(start, abstract_train_state(
            model, opt, args.compress_grads), device=device,
            shardings=trainer.layouts)
        print(f"resumed from step {start}")
    else:
        state = init_train_state(model, opt, 0, args.compress_grads,
                                 device=device, mesh=mesh, rules=rules)

    from repro_torch import kernels
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with execution_context(hardware=hardware), \
            trace(args.trace_dir, enabled=bool(args.trace_dir)) as session:
        state, history = trainer.run(state, start_step=start)
    wall = time.perf_counter() - t0
    for step, loss in history:
        print(f"step {step:6d}  loss {loss:.4f}")
    print(f"done at step {int(full(state.step))}")
    if session.enabled:
        print(f"[trace] captured {len(session.trace_files())} trace file(s) "
              f"under {args.trace_dir}")
    if args.stats:
        steps_run = max(int(full(state.step)) - start, 1)
        toks = steps_run * args.batch * args.seq_len
        print(f"[stats] hw={hardware}, {steps_run} step(s) in {wall:.1f}s "
              f"({steps_run / wall:.2f} step/s, {toks / wall:.0f} tok/s), "
              f"device={device}")
        print(f"[stats] kernel launches: {kernels.launch_counts()} "
              f"gemm by path {kernels.gemm_launches_by_path()}")


if __name__ == "__main__":
    main()
