#!/usr/bin/env python3
"""Probe a multi-rank mesh on fewer cards than ranks.

    torchrun --standalone --nproc_per_node 2 scripts/torch_mesh_probe.py

Every rank runs on ``cuda:(LOCAL_RANK % device_count)``: with one card,
every rank shares it.  Two attempts, each reported by rank 0 as one JSON
line, whatever it raises:

* ``nccl``: the port's ``build_mesh("data=N")`` over NCCL, one all-reduce
  and one column-split ``core.matmul`` on the mesh;
* ``gloo_cuda``: a gloo process group of the same ranks and one
  all-reduce of a CUDA tensor (what a gloo mesh over the card would run).
"""
from __future__ import annotations

import json
import os
import sys
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [os.path.join(os.path.dirname(HERE), "src")] + [
    p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]


def _attempt(name, fn):
    try:
        return {"attempt": name, "ok": True, **fn()}
    except Exception as exc:       # the probe reports what the stack says
        return {"attempt": name, "ok": False,
                "error": f"{type(exc).__name__}: {exc}"[:1500],
                "where": traceback.format_exc(limit=3)[-800:]}


def main() -> int:
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    n = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    card = int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count()
    os.environ["LOCAL_RANK"] = str(card)
    results = []

    def nccl():
        from repro_torch.core import matmul
        from repro_torch.launch.mesh import build_mesh
        mesh = build_mesh(f"data={n}", device="cuda")
        x = torch.ones(4, device="cuda") * (rank + 1)
        dist.all_reduce(x)
        w = torch.randn(64, 32, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(0))
        a = torch.randn(16, 64, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(1))
        wd = distribute_tensor(w, mesh, [Shard(1)])
        ad = distribute_tensor(a, mesh, [Replicate()])
        got = matmul(ad, wd).full_tensor()
        torch.cuda.synchronize()
        out = {"backend": dist.get_backend(), "all_reduce": x.tolist(),
               "matmul_max_abs_err": (got - a @ w).abs().max().item()}
        dist.destroy_process_group()
        return out

    def gloo_cuda():
        dist.init_process_group("gloo")
        x = torch.ones(4, device="cuda") * (rank + 1)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out = {"backend": dist.get_backend(), "all_reduce": x.tolist()}
        dist.destroy_process_group()
        return out

    torch.cuda.set_device(card)
    for name, fn in (("nccl", nccl), ("gloo_cuda", gloo_cuda)):
        results.append(_attempt(name, fn))
        if dist.is_initialized():
            dist.destroy_process_group()
    if rank == 0:
        print(json.dumps({"ranks": n, "cards": torch.cuda.device_count(),
                          "card": torch.cuda.get_device_name(card),
                          "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
