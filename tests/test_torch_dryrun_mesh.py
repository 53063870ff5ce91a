"""The port's dry run on fake meshes (``repro_torch.launch.mesh``'s
``make_host_mesh`` / ``make_production_mesh`` over a fake process group).

The fake process group is process-wide, so the meshed traces run in three
subprocesses, started together by a module fixture; the one-device counts
they are held against are traced here meanwhile.

* On a fake ``data=4,model=2`` mesh, for the reference's
  ``test_mini_dryrun_compiles_on_8dev_mesh`` pairs (reduced, f32, 8 x
  16), the sum over the 8 ranks of each model function's product flops
  equals its one-device count, exactly, except for the products the
  port's rules replicate over ``model``, listed by name in
  ``REPLICATED``.  Every rank counts the same (traced rank by rank for two
  pairs); a train cell counts collectives.
* Both production meshes (16 x 16, 2 x 16 x 16) trace a reduced cell to
  OK; projections whose heads do not divide the ``model`` axis are
  gathered before they are split into heads (``distributed.ops.unflatten``).
* The fake meshes refuse to start where a real process group is live.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.configs.catalog import get_config  # noqa: E402
from repro_torch.launch.dryrun import lower_cell  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PAIRS = [("llama3.2-1b", "train"), ("olmoe-1b-7b", "train"),
         ("mamba2-130m", "decode"), ("zamba2-2.7b", "prefill"),
         ("whisper-large-v3", "decode"), ("llama-3.2-vision-11b", "train")]
#: the pairs traced on every rank, one by one
EVERY_RANK = [("llama3.2-1b", "train"), ("mamba2-130m", "decode")]
DATA, MODEL = 4, 2
#: model functions (``flops_by_site`` names) whose products the port's
#: rules replicate over ``model``: per-row code under ``batch_local``,
#: split over the batch axes only (the SSD's chunk contractions, the
#: decode step's state update)
REPLICATED = {("mamba2-130m", "decode"): {"ssm._step"},
              ("zamba2-2.7b", "prefill"): {"ssm._ssd"}}


def _olmoe_router_flops(cfg, tokens):
    """olmoe's router product x @ w_router (T x D x E), forward, dX and dW,
    every layer: its weight is (embed, None), gathered over ``data`` and
    whole on each ``model`` rank, so each of them computes it."""
    return 3 * 2 * tokens * cfg.d_model * cfg.num_experts * cfg.num_layers


_COMMON = """
import dataclasses, json, logging, sys
logging.disable(logging.WARNING)
P = json.loads(sys.argv[1])
DATA, MODEL = P["data"], P["model"]
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.catalog import get_config
from repro_torch.launch.dryrun import lower_cell, run_cell
from repro_torch.launch.mesh import end_fake_world, make_host_mesh

def cfg_of(arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")

def trace(arch, kind, mesh, sites=False):
    st, _ = lower_cell(cfg_of(arch), ShapeSpec("t", 16, 8, kind), mesh,
                       sites=sites)
    return {"flops": st.flops, "sites": st.flops_by_site,
            "collectives": st.collective_count,
            "link_bytes": st.collective_link_bytes}
"""

_PAIRS_SCRIPT = _COMMON + """
out = {f"{a}/{k}": trace(a, k, make_host_mesh(DATA, MODEL), sites=True)
       for a, k in P["pairs"]}
end_fake_world()
print("RESULT " + json.dumps(out))
"""

_RANKS_SCRIPT = _COMMON + """
out = {"ranks": {}}
for a, k in P["every"]:
    out["ranks"][f"{a}/{k}"] = [
        trace(a, k, make_host_mesh(DATA, MODEL, rank=r))["flops"]
        for r in range(DATA * MODEL)]
end_fake_world()
print("RESULT " + json.dumps(out))
"""

_MESHES_SCRIPT = _COMMON + """
import torch.distributed as dist
out = {"production": {}}
for m in ("single", "multi"):
    rec = run_cell("llama3.2-1b", "train_4k", m, reduced=True)
    out["production"][m] = {k: rec[k] for k in (
        "status", "chips", "mesh_axes", "step_stats", "memory")}
# 4 heads and 2 KV heads on an 8-way model axis: gathered, then split
out["uneven"] = trace("llama3.2-1b", "train", make_host_mesh(1, 8))
end_fake_world()
dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                        world_size=1)
try:
    make_host_mesh(2, 2)
    out["refused"] = None
except RuntimeError as e:
    out["refused"] = str(e)
dist.destroy_process_group()
print("RESULT " + json.dumps(out))
"""


def _start(script, params):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(script), json.dumps(params)],
        env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)


def _result(proc):
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, err[-3000:]
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _one_device(arch, kind):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    st, _ = lower_cell(cfg, ShapeSpec("t", 16, 8, kind), sites=True)
    return cfg, st


@pytest.fixture(scope="module")
def traced():
    params = dict(data=DATA, model=MODEL, pairs=PAIRS, every=EVERY_RANK)
    procs = [_start(script, params) for script in (
        _PAIRS_SCRIPT, _RANKS_SCRIPT, _MESHES_SCRIPT)]
    try:
        one = {f"{a}/{k}": _one_device(a, k) for a, k in PAIRS}
        pairs, ranks, meshes = (_result(p) for p in procs)
    finally:
        for p in procs:
            p.kill()
    return one, pairs, dict(ranks, **meshes)


@pytest.mark.parametrize("arch,kind", PAIRS)
def test_ranks_split_each_functions_products(traced, arch, kind):
    one, pairs, _ = traced
    cfg, st1 = one[f"{arch}/{kind}"]
    rank0 = pairs[f"{arch}/{kind}"]
    n = DATA * MODEL
    replicated = REPLICATED.get((arch, kind), set())
    sites = set(st1.flops_by_site) | set(rank0["sites"])
    assert "?" not in sites                 # every product has its function
    excess = 0.0
    for site in sorted(sites):
        alone = st1.flops_by_site.get(site, 0.0)
        summed = n * rank0["sites"].get(site, 0.0)
        if site in replicated:
            assert summed == MODEL * alone, site
        elif (arch, site) == ("olmoe-1b-7b", "moe.moe_layer"):
            router = _olmoe_router_flops(cfg, 8 * 16)
            assert summed == alone + (MODEL - 1) * router, site
        else:
            assert summed == alone, site
        excess += summed - alone
    assert n * rank0["flops"] == st1.flops + excess
    if kind == "train":
        assert rank0["collectives"] > 0 and rank0["link_bytes"] > 0


@pytest.mark.parametrize("arch,kind", EVERY_RANK)
def test_every_rank_counts_alike(traced, arch, kind):
    """The sum over ranks, traced rank by rank, is 8 x rank 0's."""
    one, pairs, ranks = traced
    per_rank = ranks["ranks"][f"{arch}/{kind}"]
    assert len(per_rank) == DATA * MODEL
    assert set(per_rank) == {pairs[f"{arch}/{kind}"]["flops"]}
    if not REPLICATED.get((arch, kind)):
        assert sum(per_rank) == one[f"{arch}/{kind}"][1].flops


@pytest.mark.parametrize("mesh,chips,axes", [
    ("single", 256, "data16xmodel16"), ("multi", 512, "pod2xdata16xmodel16")])
def test_production_meshes_trace_a_reduced_cell(traced, mesh, chips, axes):
    rec = traced[2]["production"][mesh]
    assert rec["status"] == "OK" and rec["chips"] == chips
    assert rec["mesh_axes"] == axes
    ss = rec["step_stats"]
    assert ss["flops"] > 0 and ss["collective_count"] > 0
    assert ss["collective_link_bytes"] > 0 and ss["traffic_bytes"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    # the multi-pod mesh splits the batch twice as far
    other = traced[2]["production"]["single"]["step_stats"]["flops"]
    assert ss["flops"] == other * 256 // chips


def test_heads_that_do_not_divide_the_model_axis_are_gathered(traced):
    """Reduced llama (4 heads, 2 KV heads) on model=8 traces: before
    ``distributed.ops.unflatten`` the split of a projection into heads
    raised in DTensor ("Cannot unflatten unevenly sharded tensor")."""
    rec = traced[2]["uneven"]
    assert rec["flops"] > 0 and rec["collectives"] > 0


def test_fake_meshes_refuse_a_live_real_process_group(traced):
    msg = traced[2]["refused"]
    assert msg is not None and "real gloo process group is live" in msg
    assert "build_mesh" in msg
