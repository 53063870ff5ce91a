"""Dry run: trace every (architecture x input-shape) cell on the reference's
production meshes with fake tensors, and record each device's work.

    PYTHONPATH=src python -m repro_torch.launch.dryrun           # all cells, both meshes
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list

The port's counterpart of the reference's ``launch/dryrun.py``, which
lowers and compiles each cell through XLA on 512 host devices.  Here the
cell's step runs once, eagerly, under ``FakeTensorMode`` (no storage: a
full-width step costs seconds of host time and no memory) as rank 0 of a
fake process group (``launch.mesh.make_production_mesh``): the model and
state are made on the mesh by the port's sharding rules, the step runs
under the activation policy, and ``launch.step_stats`` counts the rank's
products, bytes, collectives and peak memory.  The steps are the
trainer's: ``make_train_step`` over a state made as ``init_train_state``
makes it, ``make_prefill_step`` and ``make_decode_step``.  Kernels run as
their plain versions on the fake CPU tensors; K1, the einsums and K2 are
each counted as one launch (``step_stats``).

``--mesh single`` is one pod (16 x 16), ``multi`` two (2 x 16 x 16),
``both`` the two, ``device`` one device with no mesh.  Every record lands
incrementally in ``results/torch_dryrun.json``; SKIP rows are emitted for
long_500k on pure full-attention archs.  ``python -m
repro_torch.launch.roofline`` reads the records.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import time
import traceback
from typing import Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec
from repro_torch.configs.catalog import ARCHITECTURES, get_config
from repro_torch.core.gemm_api import execution_context
from repro_torch.distributed import ctx as dctx
from repro_torch.distributed import sharding as sh
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import (end_fake_world, make_production_mesh,
                                     mesh_axis_label)
from repro_torch.launch.step_stats import COLLECTIVE_OPS, count_step
from repro_torch.models.model import active_param_count, build_model
from repro_torch.models.params import map_tree
from repro_torch.optim.adamw import AdamW
from repro_torch.train import trainer as tr

RESULTS_DEFAULT = "results/torch_dryrun.json"
MESHES = ("single", "multi", "device")


def _fake(tree):
    """A meta-tensor tree as zeroed tensors on the (fake) CPU, same
    strides."""
    return map_tree(lambda _p, t: torch.zeros_like(t, device="cpu"), tree)


def model_flops_of(model, shape: ShapeSpec, kind: str) -> dict:
    """The cell's model-flop metadata: MODEL_FLOPS = 6 N D (train) or
    2 N D (prefill; decode's D is the batch), N the active parameters."""
    n_active = active_param_count(model)
    if kind == "train":
        model_flops = 6 * n_active * shape.tokens
    elif kind == "prefill":
        model_flops = 2 * n_active * shape.tokens
    else:
        model_flops = 2 * n_active * shape.global_batch
    return {"kind": kind, "params_total": model.param_count(),
            "params_active": n_active, "model_flops": model_flops}


def lower_cell(cfg: ModelConfig, shape: ShapeSpec, mesh=None,
               rules: Optional[sh.ShardingRules] = None,
               logit_chunk: Optional[int] = None,
               attn_p_dtype: Optional[str] = None,
               remat_policy: Optional[str] = None,
               kv_quant: bool = False, sites: bool = False,
               fake: bool = True, bf16_partials: bool = False,
               program: bool = False):
    """Trace the cell's step once on fake tensors, on ``mesh`` (None: one
    device) under ``rules`` (default ``rules_for_mesh(mesh)``); ``fake=
    False`` runs it on real CPU tensors instead (small cells).
    ``bf16_partials`` runs it under ``execution_context(bf16_partials=
    True)``; ``program`` keeps the IR checks' record (``count_step``).
    Returns (``StepStats`` of this rank, meta: the step kind, parameter
    counts, model flops and the ``memory`` record)."""
    if logit_chunk is not None:
        cfg = dataclasses.replace(cfg, logit_chunk=logit_chunk)
    if attn_p_dtype is not None:
        cfg = dataclasses.replace(cfg, attn_p_dtype=attn_p_dtype)
    if remat_policy is not None:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    if kv_quant:
        cfg = dataclasses.replace(cfg, kv_quant=True)
    model = build_model(cfg)
    if mesh is not None:
        rules = rules or sh.rules_for_mesh(mesh)
    kind, specs = specs_mod.input_specs(cfg, shape)

    def placed(tree, layouts):
        return tree if mesh is None else sh.distribute_tree(
            tree, layouts(mesh, rules, tree))

    policy = dctx.on_mesh(mesh, rules)
    # real tensors the model keeps (none today) would meet fake ones here
    mode = (FakeTensorMode(allow_non_fake_inputs=True) if fake
            else contextlib.nullcontext())
    with mode:
        if kind == "train":
            optimizer = AdamW(learning_rate=1e-4)
            state = tr.init_train_state(model, optimizer, 0, device="cpu",
                                        mesh=mesh, rules=rules)
            batch = placed(_fake(specs["batch"]), sh.batch_shardings)
            args = (state, batch)
            step = tr.make_train_step(model, optimizer)
        else:
            params = model.init(0, device="cpu", mesh=mesh, rules=rules)
            cache = placed(_fake(specs["cache"]), sh.cache_shardings)
            if kind == "prefill":
                batch = placed(_fake(specs["batch"]), sh.batch_shardings)
                args = (params, batch, cache)
                step = tr.make_prefill_step(model)
            else:
                tokens = placed({"t": _fake(specs["tokens"])},
                                sh.batch_shardings)["t"]
                args = (params, tokens, cache, shape.seq_len - 1)
                step = tr.make_decode_step(model)
        with policy, execution_context(bf16_partials=bf16_partials), \
                count_step(args, sites=sites, program=program) as stats:
            out = step(*args)
            del out
    meta = model_flops_of(model, shape, kind)
    meta["memory"] = {"argument_bytes": stats.argument_bytes,
                      "peak_bytes": stats.peak_bytes}
    return stats, meta


def _mesh_for(mesh_name: str):
    if mesh_name == "device":
        return None
    return make_production_mesh(multi_pod=mesh_name == "multi")


def cell_record(cfg: ModelConfig, shape: ShapeSpec, mesh=None,
                rules: Optional[sh.ShardingRules] = None, *,
                arch: Optional[str] = None,
                mesh_name: Optional[str] = None, **opts) -> dict:
    """:func:`lower_cell` as the reference's dry-run record (``status``
    OK), the counts under ``step_stats`` in place of ``hlo_stats``:
    what ``launch.roofline.roofline_row`` reads.  ``opts`` go to
    :func:`lower_cell`."""
    t0 = time.time()
    stats, meta = lower_cell(cfg, shape, mesh, rules, **opts)
    coll = {op: stats.collective_result_bytes[op] for op in COLLECTIVE_OPS}
    coll["total"] = sum(coll.values())
    coll["count"] = stats.collective_count
    step_stats = stats.record()
    hist = step_stats.pop("op_histogram")
    label = mesh_axis_label(mesh)
    return {
        "arch": arch or cfg.name, "shape": shape.name,
        "mesh": mesh_name or label or "device", "mesh_axes": label,
        "status": "OK", "chips": 1 if mesh is None else mesh.size(),
        "seconds_trace": round(time.time() - t0, 1),
        "memory": meta.pop("memory"),
        "cost": {"flops": stats.flops,
                 "bytes_accessed": stats.traffic_bytes},
        "collectives": coll, "op_histogram": hist,
        "step_stats": step_stats,
        **meta,
    }


def run_cell(arch: str, shape_name: str, mesh_name: str,
             logit_chunk: Optional[int] = None, fsdp: bool = True,
             sequence_parallel: bool = False,
             attn_p_dtype: Optional[str] = None,
             remat_policy: Optional[str] = None,
             kv_quant: bool = False, reduced: bool = False,
             bf16_partials: bool = False) -> dict:
    """One cell's record (:func:`cell_record`; SKIP for long_500k on a
    pure full-attention arch).  ``reduced`` traces the arch's ``reduced()``
    config (a quick check of the sharding path)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]

    if shape_name == "long_500k" and not cfg.supports_long_context:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "SKIP",
                "reason": "pure full-attention arch: 524k dense-attention "
                          "decode is out of operating envelope"}

    mesh = _mesh_for(mesh_name)
    rules = None if mesh is None else sh.rules_for_mesh(
        mesh, fsdp=fsdp, sequence_parallel=sequence_parallel)
    rec = cell_record(cfg.reduced() if reduced else cfg, shape, mesh, rules,
                      arch=arch, mesh_name=mesh_name,
                      logit_chunk=logit_chunk, attn_p_dtype=attn_p_dtype,
                      remat_policy=remat_policy, kv_quant=kv_quant,
                      bf16_partials=bf16_partials)
    rec["reduced"] = reduced
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", default="both", choices=MESHES + ("both",),
                    help="single: 16 x 16; multi: 2 x 16 x 16; both; "
                         "device: one device, no mesh")
    ap.add_argument("--out", default=RESULTS_DEFAULT)
    ap.add_argument("--logit-chunk", type=int, default=None)
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--attn-p-dtype", default=None,
                    help="e.g. bfloat16 (halves the attention P buffer)")
    ap.add_argument("--bf16-partials", action="store_true",
                    help="bf16 cross-shard matmul reductions")
    ap.add_argument("--remat-policy", default=None, choices=["full", "dots"])
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache (decode memory-term optimization)")
    ap.add_argument("--tag", default=None,
                    help="suffix results key with #<tag> (perf iterations)")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--reduced", action="store_true",
                    help="trace each arch's reduced config (a quick check; "
                         "the record carries reduced: true)")
    ap.add_argument("--force", action="store_true", help="recompute existing")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list(ARCHITECTURES)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    if args.list:
        for a in archs:
            for s in shapes:
                print(f"{a} x {s}")
        return

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    t_all = time.time()
    try:
        for a in archs:
            for s in shapes:
                for m in meshes:
                    key = f"{a}/{s}/{m}"
                    if args.tag:
                        key += f"#{args.tag}"
                    if key in results and results[key].get("status") in (
                            "OK", "SKIP") and not args.force:
                        print(f"[cached] {key}")
                        continue
                    print(f"[run] {key} ...", flush=True)
                    try:
                        rec = run_cell(a, s, m, logit_chunk=args.logit_chunk,
                                       fsdp=not args.no_fsdp,
                                       sequence_parallel=args.seq_parallel,
                                       attn_p_dtype=args.attn_p_dtype,
                                       remat_policy=args.remat_policy,
                                       kv_quant=args.kv_quant,
                                       reduced=args.reduced,
                                       bf16_partials=args.bf16_partials)
                        if args.tag:
                            rec["tag"] = args.tag
                    except Exception as e:
                        rec = {"arch": a, "shape": s, "mesh": m,
                               "status": "FAIL",
                               "error": f"{type(e).__name__}: {e}",
                               "traceback": traceback.format_exc()[-2000:]}
                    results[key] = rec
                    gc.collect()
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1)
                    extra = ""
                    if rec["status"] == "OK":
                        extra = (f" flops/dev={rec['cost']['flops']:.3g}"
                                 f" coll={rec['collectives']['total']:.3g}B"
                                 f" peak={rec['memory']['peak_bytes']:.3g}B"
                                 f" trace={rec['seconds_trace']}s")
                    elif rec["status"] == "FAIL":
                        extra = f" {rec['error'][:200]}"
                    print(f"[{rec['status']}] {key}{extra}", flush=True)
    finally:
        end_fake_world()

    ok = sum(1 for r in results.values() if r["status"] == "OK")
    skip = sum(1 for r in results.values() if r["status"] == "SKIP")
    fail = sum(1 for r in results.values() if r["status"] == "FAIL")
    print(f"\nTotal: {ok} OK, {skip} SKIP, {fail} FAIL / {len(results)} "
          f"({time.time() - t_all:.0f} s)")


if __name__ == "__main__":
    main()
