"""Fault tolerance on the port: train, 'crash', restart from the
checkpoint, and verify that the resumed run is bit for bit the
uninterrupted one.

20 steps of llama3.2-1b with a checkpoint at step 10; then a restore into
``abstract_train_state`` and a replay of steps 10-20.  The largest
parameter difference must be exactly 0.0 (deterministic data, atomic
checkpoints, and torch's deterministic algorithms on the card, where the
embedding gradient would otherwise accumulate with atomics), or the
script exits 1.

Run (on the card; llama3.2-1b at its published width, 2 layers keep the
checkpoint at ~5 GB)::

    PYTHONPATH=src python examples/torch_train_with_failure_recovery.py --layers 2 [--ckpt-dir D]

or on the CPU::

    PYTHONPATH=src python examples/torch_train_with_failure_recovery.py --device cpu --reduced
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs.catalog import get_config  # noqa: E402
from repro_torch.core import resolve_device  # noqa: E402
from repro_torch.core.device import card_label  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import (abstract_train_state,  # noqa: E402
                               init_train_state, make_train_step)

ARCH = "llama3.2-1b"
STEPS = 20
SAVE_AT = 10


def model_config(reduced: bool = False, layers: int = None):
    """llama3.2-1b at its published width in bf16 (``reduced``: the tiny
    f32 variant); ``layers`` cuts depth only."""
    cfg = get_config(ARCH)
    cfg = cfg.reduced() if reduced else dataclasses.replace(
        cfg, dtype="bfloat16")
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


@contextlib.contextmanager
def deterministic():
    """torch's deterministic algorithms for the block, restored after."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def run(model, device, ckpt_dir: str, steps: int = STEPS,
        save_at: int = SAVE_AT, batch: int = 8, seq: int = 32):
    """Train ``steps`` steps with a checkpoint at ``save_at``, restore it
    into ``abstract_train_state`` and replay the steps after it.  Returns
    (latest checkpoint step, the largest parameter difference between the
    two runs, the replayed losses)."""
    opt = AdamW(learning_rate=1e-3)
    pipe = TokenPipeline(DataConfig(vocab_size=model.cfg.vocab_size,
                                    seq_len=seq, global_batch=batch),
                         device=device)
    step = make_train_step(model, opt)
    ck = Checkpointer(ckpt_dir)
    with deterministic():
        # reference run: uninterrupted
        state = init_train_state(model, opt, seed=0, device=device)
        for i in range(steps):
            state, _ = step(state, pipe(i))
            if i + 1 == save_at:
                ck.save(save_at, state)
        ref = state
        # 'crash' after the checkpoint -> restart from it -> replay
        state = ck.restore(save_at, abstract_train_state(model, opt),
                           device=device)
        losses = []
        for i in range(save_at, steps):
            state, metrics = step(state, pipe(i))
            losses.append(metrics["loss"])
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(ref.params),
                               tree_leaves(state.params)))
    return ck.latest_step(), diff, [float(x) for x in losses]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny f32 config of the CPU tests")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (width unchanged)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one, "
                         "removed after)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"[recovery] {e}", file=sys.stderr)
        return 2
    cfg = model_config(args.reduced, args.layers)
    model = build_model(cfg)
    print(f"[recovery] {cfg.name}: {cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.dtype} on {card_label(device)}")
    with contextlib.ExitStack() as stack:
        ckpt_dir = args.ckpt_dir or stack.enter_context(
            tempfile.TemporaryDirectory())
        latest, diff, losses = run(model, device, ckpt_dir)
    print(f"[recovery] latest checkpoint: step {latest}; replayed losses "
          f"{losses[0]:.4f} .. {losses[-1]:.4f}")
    print(f"[recovery] max param diff after resumed run: {diff:.2e}")
    if diff != 0.0:
        print("[recovery] FAIL: the resumed run is not bitwise identical",
              file=sys.stderr)
        return 1
    print("[recovery] OK: restart is bitwise identical (deterministic data "
          "+ atomic checkpoints)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
