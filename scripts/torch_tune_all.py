#!/usr/bin/env python3
"""Regenerate the port's production tuning table (the paper's Tab. 4) for
every GEMM the catalog's full-size models issue, forward and backward, and
every flash-attention problem over the zoo's head dims.

    python3 scripts/torch_tune_all.py                 # on the card: all ten
    python3 scripts/torch_tune_all.py --arch yi-9b --arch mamba2-130m
    python3 scripts/torch_tune_all.py --mode model --db-dir build/tune_all

The port's counterpart of ``scripts/tune_all.py``.  Each architecture of
``configs/catalog.py`` (or each ``--arch``) is built at full width in bf16
and run on fake tensors (``FakeTensorMode``: no storage, no card) at
b = 4, s = 4096, with its extra inputs:

* its forward, under ``torch.no_grad()`` and
  ``core.capture_gemm_shapes(calls=True)``: every product K1 runs, with
  B's layout and the output dtype.  Its (m, k, n) set is the reference's
  capture;
* the backward of ``train.loss.lm_loss`` over the whole sequence (one
  unembed pass, ``logit_chunk=0``): the dX and dW products K1 runs in
  training, which the reference leaves to XLA, each as
  ``core/gemm_api.py::_gemm_op_backward`` lays it out (dX reads the weight
  K-major, dW the copied x.T, a bf16 dW pads its K to a multiple of 8) and
  in its output's dtype: bf16, or f32 for the unembed's f32 cotangent.

Each distinct problem is swept once (``core.tuner.sweep_gemm``, its
operands in their dtype and laid out as the model lays them out), then the
flash problems ``(s, s, d)`` for every head dim of the selected
architectures and s in 128..4096, at ``torch_tune.py``'s
``FLASH_LAYOUT``.  ``--mode measure`` (the default; the card only) times
the cost model's top ``--top-k`` candidates on the device (``--mode
model`` ranks them on the cost model alone, anywhere); one JSON line per
problem, as ``torch_tune.py sweep`` prints.
After each architecture the winners are merged into ``tuned/h100.json``
(``--db-dir`` writes another directory): every entry there stays unless a
measurement of its problem beats it, and ``measured_on`` is the card's
``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# this directory's profile.py (the reference's CLI) would shadow the
# standard library's profile module, which torch imports
sys.path[:] = [os.path.join(os.path.dirname(HERE), "src")] + [
    p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]

import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.configs.catalog import ARCHITECTURES  # noqa: E402
from repro_torch.core import tuning_db  # noqa: E402
from repro_torch.core.gemm_api import (capture_gemm_shapes,  # noqa: E402
                                       execution_context)
from repro_torch.core.hardware import H100, detect_hardware  # noqa: E402
from repro_torch.core.tile_config import (OP_FLASH_ATTENTION,  # noqa: E402
                                          OP_GEMM)
from repro_torch.core.tuner import DEFAULT_TOP_K, SEARCH_GUIDED  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.params import map_tree  # noqa: E402
from repro_torch.train.loss import lm_loss  # noqa: E402

# the CLI's sweep and report helpers, loaded by path (see above)
_spec = importlib.util.spec_from_file_location(
    "torch_tune", os.path.join(HERE, "torch_tune.py"))
torch_tune = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(torch_tune)

#: the table this script regenerates
HW = H100.name
#: a per-device-scale slice of train_4k, as the reference captures
BATCH, SEQ = 4, 4096
#: the serve engine's power-of-two prefill buckets, and train_4k
FLASH_LENGTHS = (128, 512, 1024, 2048, 4096)


def capture(cfg, batch: int = BATCH, seq: int = SEQ, *,
            backward: bool = True):
    """(forward, backward) K1 calls of ``cfg``'s model in bf16 on fake
    tensors, each ``(m, k, n, b_kmajor, out_dtype)`` (see the module
    doc); ``backward=False`` skips the backward (an empty list)."""
    model = build_model(dataclasses.replace(cfg, dtype="bfloat16"))
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = model.init(0, device="cpu")
        inputs = {"tokens": torch.zeros((batch, seq), dtype=torch.int32)}
        for name, spec in model.extra_inputs(batch).items():
            inputs[name] = torch.zeros(spec.shape, dtype=spec.dtype)
        with torch.no_grad(), capture_gemm_shapes(calls=True) as forward:
            model.forward(params, inputs)
        if not backward:
            return list(forward), []
        params = map_tree(lambda _p, t: t.requires_grad_(
            t.is_floating_point()), params)
        inputs["labels"] = torch.zeros((batch, seq), dtype=torch.int32)
        # the backward's products are recorded in the list the forward ran
        # under (``_gemm_op_setup``): split it where the backward starts
        records: list = []
        with execution_context(capture=records):
            loss, _ = lm_loss(model, params, inputs, logit_chunk=0)
            start = len(records)
            loss.backward()
    return list(forward), records[start:]


def gemm_problems(forward, backward):
    """The distinct problems of captured calls, each ``(dtype, (m, k, n,
    b_kmajor, out_dtype))``: a forward product's operands are the model's
    bf16, a backward product's are in its output dtype (both are cast to
    it in ``_gemm_op_backward``)."""
    probs = {(torch.bfloat16, tuple(c)) for c in forward}
    probs |= {(c[4], tuple(c)) for c in backward}
    return sorted(probs, key=lambda p: (str(p[0]), p[1][:4], str(p[1][4])))


def flash_problems(cfgs):
    """Every head dim of ``cfgs`` with heads x :data:`FLASH_LENGTHS`, as
    the reference's ``(s, s, d)``."""
    dims = sorted({c.resolved_head_dim for c in cfgs if c.num_heads})
    return sorted({(s, s, d) for d in dims for s in FLASH_LENGTHS})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", action="append", default=None,
                    choices=sorted(ARCHITECTURES),
                    help="tune this architecture only (repeatable; "
                         "default: the whole catalog)")
    ap.add_argument("--mode", choices=["model", "measure"],
                    default="measure")
    ap.add_argument("--top-k", type=int, default=DEFAULT_TOP_K)
    ap.add_argument("--repeats", type=int, default=10)
    ap.add_argument("--db-dir", default=None,
                    help="tuned-DB directory (default: "
                         "$REPRO_TORCH_TUNED_DIR or the package's tuned/)")
    # the guided search (top-k) always: the sweep helpers read args.search
    ap.set_defaults(search=SEARCH_GUIDED)
    args = ap.parse_args(argv)
    measured_on = None
    if args.mode == "measure":
        if not torch.cuda.is_available():
            raise SystemExit("error: --mode measure needs the card (no CUDA "
                             "device); use --mode model")
        if detect_hardware() != HW:
            raise SystemExit(f"error: this card resolves to profile "
                             f"{detect_hardware()!r}; the table is {HW}'s")
        measured_on = torch_tune.smi()
    names = args.arch or list(ARCHITECTURES)
    path = tuning_db.db_path(HW, args.db_dir)
    db = tuning_db.TuningDB(HW)
    if os.path.exists(path):
        db.merge(tuning_db.TuningDB.from_file(path))
    start_entries, t_start = len(db), time.perf_counter()
    done = set()

    def sweep(op, dtype, problem):
        res = torch_tune._sweep_one(op, problem, HW, dtype, args)
        torch_tune._report(op, problem, res, dtype, args)
        return res

    def save(results):
        db.merge(tuning_db.db_from_sweeps(HW, results, measured_on))
        db.save(path)

    for name in names:
        t0 = time.perf_counter()
        forward, backward = capture(ARCHITECTURES[name])
        print(f"{name:26s} {len(forward):3d} GEMMs, "
              f"{len({c[:3] for c in forward}):2d} unique shapes; backward "
              f"{len(backward):4d} GEMMs, "
              f"{len({c[:3] for c in backward}):2d} unique shapes", flush=True)
        todo = [p for p in gemm_problems(forward, backward) if p not in done]
        done.update(todo)
        save([sweep(OP_GEMM, dtype, problem) for dtype, problem in todo])
        print(f"[tune_all] {name}: {len(todo)} problems swept in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    flash = flash_problems([ARCHITECTURES[n] for n in names])
    print(f"tuning {len(flash)} flash-attention problems (head dims "
          f"{sorted({p[2] for p in flash})})...", flush=True)
    save([sweep(OP_FLASH_ATTENTION, torch.bfloat16, p) for p in flash])
    print(f"[tune_all] wrote {path} with {len(db)} entries "
          f"({len(db) - start_entries} new) in "
          f"{time.perf_counter() - t_start:.1f} s"
          + (f" (measured on {measured_on})" if measured_on else ""),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
