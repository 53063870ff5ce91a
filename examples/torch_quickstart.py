"""Quickstart on the PyTorch/CUDA port: the paper's workflow in three steps.

1. tune the single-source GEMM kernel for the card (a measured sweep of
   the 4096^3 bf16 product; the registry then serves its winner ``exact``),
2. train llama3.2-1b 30 steps at 8 x 32 tokens through ``make_train_step``
   (every product, forward and backward, on the tuned kernel),
3. generate from it with the serving ``Engine``.

Run (on the card; llama3.2-1b at its published width and depth)::

    PYTHONPATH=src python examples/torch_quickstart.py [--layers N]

or on the CPU, where the kernels' plain versions run and the sweep ranks
schedules with the cost model instead of timing them::

    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --reduced
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402

from repro_torch.configs.catalog import get_config  # noqa: E402
from repro_torch.core import GLOBAL_REGISTRY, resolve_device  # noqa: E402
from repro_torch.core.device import card_label  # noqa: E402
from repro_torch.core.hardware import resolve_hardware  # noqa: E402
from repro_torch.core.tile_config import OP_GEMM  # noqa: E402
from repro_torch.core.tuner import sweep_gemm  # noqa: E402
from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.serve import Engine, ServeConfig  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402

ARCH = "llama3.2-1b"
PROMPTS = ([3, 1, 4, 1, 5], [2, 7, 1, 8])


def model_config(reduced: bool = False, layers: int = None):
    """llama3.2-1b at its published width in bf16 (``reduced``: the tiny
    f32 variant of the CPU tests); ``layers`` cuts depth only."""
    cfg = get_config(ARCH)
    cfg = cfg.reduced() if reduced else dataclasses.replace(
        cfg, dtype="bfloat16")
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def tune(device, n: int = 4096):
    """One sweep of the (n, n, n) bf16 GEMM for this device's profile:
    measured on the card, the cost model's ranking on the CPU.  Returns
    (result, the registry's lookup of that shape afterwards)."""
    hardware = resolve_hardware(None, device)
    mode = "measure" if device.type == "cuda" else "model"
    res = sweep_gemm(n, n, n, dtype=torch.bfloat16, hardware=hardware,
                     mode=mode)
    lookup = GLOBAL_REGISTRY.lookup_op(OP_GEMM, hardware, torch.bfloat16,
                                       (n, n, n))
    return res, lookup


def train(model, device, steps: int = 30, batch: int = 8, seq: int = 32,
          lr: float = 3e-4):
    """``steps`` steps of ``make_train_step`` on the synthetic pipeline from
    a seeded state.  Returns (state, [loss per step])."""
    opt = AdamW(learning_rate=lr)
    state = init_train_state(model, opt, seed=0, device=device)
    step = make_train_step(model, opt)
    pipe = TokenPipeline(DataConfig(vocab_size=model.cfg.vocab_size,
                                    seq_len=seq, global_batch=batch),
                         device=device)
    losses = []
    for i in range(steps):
        state, metrics = step(state, pipe(i))
        losses.append(metrics["loss"])
    return state, [float(x) for x in torch.stack(losses).cpu()]


def serve(model, params, device, max_new: int = 8):
    """Greedy tokens of ``PROMPTS`` from the serving engine."""
    eng = Engine(model, params, ServeConfig(max_batch=2, max_len=64,
                                            device=str(device)))
    return eng.generate([list(p) for p in PROMPTS], max_new_tokens=max_new)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny f32 config of the CPU tests")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (width unchanged)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"[quickstart] {e}", file=sys.stderr)
        return 2
    cfg = model_config(args.reduced, args.layers)
    print(f"[quickstart] {cfg.name}: {cfg.num_layers} layers, d "
          f"{cfg.d_model}, {cfg.dtype} on {card_label(device)}")

    res, lookup = tune(device)
    unit = "measured" if res.best.source.startswith("measure") else "model"
    print(f"[tune] 4096^3 bf16 on {res.hardware}: winner "
          f"{res.best.config.schedule} at {res.best.gflops / 1000:.1f} "
          f"TFLOP/s ({unit}; {res.evaluated} of {res.candidates_total} "
          f"candidates)")
    print(f"[tune] the registry now resolves 4096^3: "
          f"{lookup.config.schedule} ({lookup.source})")

    model = build_model(cfg)
    state, losses = train(model, device)
    for i in range(0, len(losses), 10):
        print(f"[train] step {i:3d} loss {losses[i]:.3f}")
    print(f"[train] final loss {losses[-1]:.3f}")
    if not all(math.isfinite(x) for x in losses):
        print("[train] FAIL: a loss is not finite", file=sys.stderr)
        return 1

    outs = serve(model, state.params, device)
    print(f"[serve] generated: {outs}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
