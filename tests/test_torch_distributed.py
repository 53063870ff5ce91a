"""The port's distribution layer (``repro_torch.distributed``,
``repro_torch.launch.mesh``) against the JAX package's, on the CPU.

In one process: the sharding rules, leaf for leaf (every architecture, at
full and reduced width, on 4 x 2, 2 x 2 and 1 x 8 stub meshes, with and
without FSDP), the batch, cache and activation specs, the mesh parser,
``build_mesh``, ``constrain`` and the ambient ``use_mesh``.  The reference's spec
functions read only a mesh's axis names and sizes, so a stub stands in for
a mesh there.

Across processes: the reference serves and trains on its data=4,model=2
host mesh (one process, ``XLA_FLAGS`` forcing 8 CPU devices, as
``tests/test_engine_mesh.py`` runs it) while the port does the same on 8
gloo ranks (``torchrun --standalone``) from the reference's weights; both
write their results, which the tests below compare.  Greedy tokens are
held exactly; losses and gradients within ``test_torch_train.py``'s
float32 tolerances (a row-split product sums its partials in another
order).  A checkpoint the port saves on 4 x 2 is restored on 2 x 2 (4 gloo
ranks) and with no mesh.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.catalog import ARCHITECTURES as JARCHS  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.distributed.ctx import ActivationPolicy as JPolicy  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs.catalog import ARCHITECTURES  # noqa: E402
from repro_torch.distributed import ctx as dctx  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.params import tree_paths  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"

#: float32 tolerances of tests/test_torch_train.py
METRIC_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)

STUBS = {"4x2": {"data": 4, "model": 2}, "2x2": {"data": 2, "model": 2},
         "1x8": {"data": 1, "model": 8}}


def _stub(name):
    sizes = STUBS[name]
    return SimpleNamespace(shape=dict(sizes), axis_names=tuple(sizes))


def _cfgs(arch, width):
    j, t = JARCHS[arch], ARCHITECTURES[arch]
    return (j.reduced(), t.reduced()) if width == "reduced" else (j, t)


def _jax_paths(tree, prefix=""):
    """``{path: leaf}`` of a reference tree, named as the port's
    ``map_tree`` names paths (dict keys and sequence indices by ``/``)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_jax_paths(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, (tuple, list)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_jax_paths(v, f"{prefix}/{i}" if prefix else str(i)))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# The rules, leaf for leaf, on stub meshes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("stub", sorted(STUBS))
@pytest.mark.parametrize("width", ["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_param_specs_summary_and_gemm_divisors_match_the_reference(
        arch, width, stub, fsdp):
    jcfg, tcfg = _cfgs(arch, width)
    mesh = _stub(stub)
    jrules = jsh.rules_for_mesh(mesh, fsdp=fsdp)
    rules = sh.rules_for_mesh(mesh, fsdp=fsdp)
    assert dataclasses.asdict(rules) == dataclasses.asdict(jrules)
    jtpl, ttpl = jbuild(jcfg).template, build_model(tcfg).template
    want = {p: tuple(jsh.spec_for_param(mesh, jrules, s))
            for p, s in _jax_paths(jtpl).items()}
    assert sh.param_specs(mesh, rules, ttpl) == want
    assert sh.sharding_summary(mesh, rules, ttpl) == \
        jsh.sharding_summary(mesh, jrules, jtpl)
    assert sh.local_gemm_divisors(mesh, rules, ttpl) == \
        jsh.local_gemm_divisors(mesh, jrules, jtpl)


@pytest.mark.parametrize("stub", sorted(STUBS))
@pytest.mark.parametrize("width", ["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_cache_specs_match_the_reference(arch, width, stub, monkeypatch):
    """Every leaf of each family's ``init_cache`` (B 8 and 1, the latter
    splitting the sequence instead; the dense family also with an int8
    cache): the reference's ``cache_shardings`` walk, its NamedSharding
    stubbed to the bare spec, against the port's ``cache_specs``."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda _mesh, spec: spec)
    mesh = _stub(stub)
    jcfg, tcfg = _cfgs(arch, width)
    variants = [(jcfg, tcfg)]
    if jcfg.family == "dense":
        variants.append((dataclasses.replace(jcfg, kv_quant=True),
                         dataclasses.replace(tcfg, kv_quant=True)))
    for fsdp in (True, False):
        jrules = jsh.rules_for_mesh(mesh, fsdp=fsdp)
        rules = sh.rules_for_mesh(mesh, fsdp=fsdp)
        for jc, tc in variants:
            for b in (8, 1):
                jcache = jax.eval_shape(lambda: jbuild(jc).init_cache(b, 64))
                tcache = build_model(tc).init_cache(b, 64, device="meta")
                want = {p: tuple(s) for p, s in _jax_paths(
                    jsh.cache_shardings(mesh, jrules, jcache)).items()}
                assert sh.cache_specs(mesh, rules, tcache) == want, (b, fsdp)
                for p, leaf in tree_paths(tcache).items():
                    assert tuple(leaf.shape) == tuple(
                        _jax_paths(jcache)[p].shape), p


@pytest.mark.parametrize("sequence_parallel", [False, True])
@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("stub", sorted(STUBS))
def test_batch_and_activation_specs_match_the_reference(stub, fsdp,
                                                        sequence_parallel):
    mesh = _stub(stub)
    jrules = jsh.rules_for_mesh(mesh, fsdp=fsdp,
                                sequence_parallel=sequence_parallel)
    rules = sh.rules_for_mesh(mesh, fsdp=fsdp,
                              sequence_parallel=sequence_parallel)
    jpol, pol = JPolicy(mesh, jrules), dctx.ActivationPolicy(mesh, rules)
    for b in (8, 3, 1):
        for rank in (2, 3, 4):
            assert sh.batch_spec(mesh, rules, b, rank) == tuple(
                jsh.batch_spec(mesh, jrules, b, rank)), (b, rank)
            for kind in ("hidden", "tokens", "logits", "batch_only",
                         "moe_dispatch", "unknown"):
                want = jpol.spec_for(kind, rank, b)
                got = pol.spec_for(kind, rank, b)
                assert got == (None if want is None else tuple(want)), (
                    kind, b, rank)


def test_pool_spec_follows_the_references_pool_rule():
    """The flat paged pool (no batch dim): KV heads on the tensor axis
    where they divide it (the reference's ``serve/engine.py`` pool rule)."""
    for stub, want in (("4x2", (None, None, "model", None)),
                       ("1x8", (None, None, None, None))):
        mesh = _stub(stub)
        rules = sh.rules_for_mesh(mesh, fsdp=False)
        assert sh.pool_spec(mesh, rules, (2, 1024, 2, 16)) == want


# ---------------------------------------------------------------------------
# launch/mesh.py, as tests/test_engine_mesh.py holds the reference's
# ---------------------------------------------------------------------------

@pytest.fixture
def one_rank():
    """A process group of one (gloo, in-memory store), torn down after."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_parse_mesh_spec():
    assert tmesh.parse_mesh_spec("data=4,model=2") == {"data": 4, "model": 2}
    assert list(tmesh.parse_mesh_spec("model=2,data=4")) == ["model", "data"]
    assert tmesh.parse_mesh_spec("pod=2, data=2 , model=1") == {
        "pod": 2, "data": 2, "model": 1}


@pytest.mark.parametrize("bad", [
    "", "data", "data=4,data=2", "ring=4", "data=x", "data=0", "data=-1",
])
def test_parse_mesh_spec_rejects(bad):
    with pytest.raises(ValueError, match="mesh spec"):
        tmesh.parse_mesh_spec(bad)


def test_build_mesh_none_and_a_world_of_one(one_rank):
    assert tmesh.build_mesh(None) is None
    assert tmesh.build_mesh("") is None
    mesh = tmesh.build_mesh("data=1,model=1", device="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tmesh.describe_mesh(mesh) == {"devices": 1,
                                         "axes": {"data": 1, "model": 1},
                                         "label": "data1xmodel1"}
    assert tmesh.describe_mesh(None) == {"devices": 1, "axes": None,
                                         "label": None}
    import torch.distributed as dist
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 1


def test_build_mesh_auto_puts_every_rank_on_data(one_rank):
    mesh = tmesh.build_mesh("auto", device="cpu")
    assert mesh.mesh_dim_names == ("data",)
    assert mesh.size() == tmesh.world_size() == 1


def test_build_mesh_too_many_ranks_is_actionable():
    import torch.distributed as dist
    with pytest.raises(ValueError,
                       match="torchrun --standalone --nproc_per_node 2"):
        tmesh.build_mesh("data=2", device="cpu")
    assert not dist.is_initialized()


def test_mesh_axes_vocabulary_matches_rules():
    rules = sh.ShardingRules()
    known = {rules.tensor_axis, rules.fsdp_axis, *rules.batch_axes, "pod"}
    assert set(tmesh.MESH_AXES) <= known
    assert tmesh.MESH_AXES == __import__(
        "repro.launch.mesh", fromlist=["MESH_AXES"]).MESH_AXES


def test_constrain_pins_a_dtensor_and_passes_anything_else(one_rank):
    """No policy, a plain tensor, a DTensor already laid out, or a kind
    with no spec: ``x`` itself (the redistribution a split mesh needs is
    held by the 8-rank runs below)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = tmesh.build_mesh("data=1,model=1", device="cpu")
    rules = sh.rules_for_mesh(mesh, fsdp=False)
    x = torch.randn(4, 3, 8)
    xd = DTensor.from_local(x, mesh, [Replicate(), Replicate()])
    assert dctx.constrain(x, "hidden") is x          # no policy
    assert dctx.constrain(xd, "hidden") is xd
    with dctx.activation_policy(mesh, rules):
        assert dctx.constrain(x, "hidden") is x       # a plain tensor
        y = DTensor.from_local(x, mesh, sh.placements_for(
            mesh, dctx.get_policy().spec_for("hidden", 3, 4)))
        assert dctx.constrain(y, "hidden") is y       # already there
        # a mesh dim of one rank splits nothing: no redistribution
        assert dctx.constrain(xd, "hidden") is xd
        assert dctx.constrain(xd, "unknown") is xd    # no spec
    assert dctx.get_policy() is None


def test_use_mesh_none_clears_the_ambient_topology(one_rank):
    mesh = tmesh.build_mesh("data=1,model=1", device="cpu")
    with dctx.use_mesh(mesh) as rules:
        assert rules == sh.rules_for_mesh(mesh)
        assert dctx.current_mesh() is mesh and dctx.current_rules() is rules
        assert dctx.get_policy().mesh is mesh
        with dctx.use_mesh(None):
            assert dctx.current_mesh() is None
            assert dctx.get_policy() is None
        assert dctx.current_mesh() is mesh
    assert dctx.current_mesh() is None and dctx.get_policy() is None


def test_ambient_mesh_is_picked_up_by_the_engine_and_init(one_rank):
    """``use_mesh`` installs the topology for engines and ``Model.init``
    that are not handed one; their tokens equal the no-mesh engine's."""
    from torch.distributed.tensor import DTensor

    from repro_torch.serve import Engine, ServeConfig
    model = build_model(ARCHITECTURES["llama3.2-1b"].reduced())
    params = model.init(1, device="cpu")
    prompts = [[5, 9, 2, 7], [1, 3, 3], [2, 4, 6, 8, 1, 5, 3]]
    want = Engine(model, params, ServeConfig(
        max_batch=4, max_len=64, device="cpu")).generate(prompts, 4)
    mesh = tmesh.build_mesh("data=1,model=1", device="cpu")
    with dctx.use_mesh(mesh):
        placed = model.init(1, device="cpu")
        assert all(isinstance(t, DTensor) for t in tree_paths(placed).values())
        for p, t in tree_paths(placed).items():
            assert torch.equal(t.full_tensor(), tree_paths(params)[p]), p
        eng = Engine(model, params, ServeConfig(max_batch=4, max_len=64,
                                                device="cpu"))
        assert eng.mesh is mesh
        got = eng.generate(prompts, 4)
    assert got == want
    st = eng.stats()
    assert st["mesh"] == {"devices": 1, "axes": {"data": 1, "model": 1},
                          "label": "data1xmodel1"}
    assert sum(st["sharding"]["params"].values()) == len(
        tree_paths(model.template))
    assert all(v["local_shape"] == k for k, v in
               st["decode_tile_lookups"].items())


# ---------------------------------------------------------------------------
# Across processes: the reference's data=4,model=2 mesh and 8 gloo ranks
# ---------------------------------------------------------------------------

FAMILIES = ["llama3.2-1b", "mamba2-130m", "olmoe-1b-7b",
            "llama-3.2-vision-11b", "whisper-large-v3", "zamba2-2.7b"]
TRAIN_ARCHS = ["llama3.2-1b", "olmoe-1b-7b"]
PROMPTS = [[5, 9, 2, 7], [1, 3, 3], [2, 4, 6, 8, 1, 5, 3], [9, 9, 1],
           [4, 4], [7, 1, 2, 3, 4], [8, 8, 8], [1, 2]]
SEQ, BATCH = 16, 8

_REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs.catalog import ARCHITECTURES
    from repro.data import DataConfig, TokenPipeline
    from repro.distributed import sharding as jsh
    from repro.distributed.ctx import activation_policy
    from repro.launch.mesh import build_mesh
    from repro.models import build_model
    from repro.optim import AdamW
    from repro.serve import Engine, PerTokenSyncEngine, ServeConfig
    from repro.train import init_train_state, lm_loss, make_train_step
    from repro.train.trainer import state_shardings

    out = sys.argv[1]
    FAMILIES, TRAIN_ARCHS, PROMPTS = {families!r}, {train!r}, {prompts!r}
    mesh = build_mesh("data=4,model=2")
    res = {{}}
    for arch in FAMILIES:
        cfg = ARCHITECTURES[arch].reduced()
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(1))
        extra = {{k: jnp.zeros((len(PROMPTS),) + s.shape[1:], s.dtype)
                  for k, s in model.extra_inputs(len(PROMPTS)).items()}}
        eng = Engine(model, params, ServeConfig(max_batch=8, max_len=64,
                                                mesh=mesh))
        r = {{"tokens": eng.generate(PROMPTS, 5, extra_inputs=extra or None)}}
        st = eng.stats()
        if arch == "llama3.2-1b":
            r["mesh"], r["sharding"] = st["mesh"], st["sharding"]
            r["lookups"] = {{k: v["local_shape"]
                             for k, v in st["decode_tile_lookups"].items()}}
            r["warm"] = eng.generate(PROMPTS, 5)
            r["hits_full"] = eng.stats()["prefix_cache"]["hits_full"]
            wave = Engine(model, params, ServeConfig(
                max_batch=8, max_len=64, mesh=mesh, scheduler="wave"))
            r["wave"] = wave.generate(PROMPTS, 5)
            # the per-token-sync baseline, plain and on the mesh (uniform
            # lengths: test_engine_mesh.py's sync traffic)
            sync = [[(5 * i + j) % cfg.vocab_size for j in range(8)]
                    for i in range(8)]
            r["sync"] = PerTokenSyncEngine(model, params,
                                           max_len=64).generate(sync, 5)
            r["sync_mesh"] = PerTokenSyncEngine(
                model, params, max_len=64, mesh=mesh).generate(sync, 5)
        res[arch] = r
    for arch in TRAIN_ARCHS:
        jm = build_model(ARCHITECTURES[arch].reduced())
        opt = AdamW()
        rules = jsh.rules_for_mesh(mesh)
        shard = state_shardings(mesh, rules, jm)
        js = jax.device_put(init_train_state(jm, opt, jax.random.PRNGKey(0)),
                            shard)
        pipe = TokenPipeline(DataConfig(vocab_size=256, seq_len={seq},
                                        global_batch={batch}))
        step = make_train_step(jm, opt)

        def pstep(s, b):
            with activation_policy(mesh, rules):
                return step(s, b)

        def grads(p, b):
            with activation_policy(mesh, rules):
                return jax.grad(lambda q: lm_loss(jm, q, b)[0])(p)
        jstep = jax.jit(pstep, in_shardings=(shard, None),
                        out_shardings=(shard, None))
        g0 = jax.jit(grads)(js.params, pipe(0))
        s1, m1 = jstep(js, pipe(0))
        s2, m2 = jstep(s1, pipe(1))
        res[arch + ":train"] = {{"losses": [float(m1["loss"]),
                                            float(m2["loss"])],
                                 "grad_norm": float(m1["grad_norm"])}}
        flat = {{}}

        def walk(t, p):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, p + "/" + k if p else k)
            else:
                flat[p] = np.asarray(t)
        walk(g0, "")
        np.savez(os.path.join(out, arch + "-grads.npz"), **flat)
    with open(os.path.join(out, "reference.json"), "w") as f:
        json.dump(res, f)
""")

_PORT = textwrap.dedent("""
    import json, os, sys
    from types import SimpleNamespace
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.catalog import ARCHITECTURES
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.distributed import ctx as dctx
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models import build_model, params_from_numpy
    from repro_torch.models.params import train_state_from_numpy, tree_paths
    from repro_torch.optim import AdamW
    from repro_torch.serve import (Engine, PerTokenSyncEngine, Request,
                                   ServeConfig, Server)
    from repro_torch.serve.server import follow
    from torch.distributed.tensor import DTensor
    from repro_torch.train.trainer import (_value_and_grad, make_train_step,
                                           place_state, state_shardings)

    ref, out = sys.argv[1], sys.argv[2]
    FAMILIES, TRAIN_ARCHS, PROMPTS = {families!r}, {train!r}, {prompts!r}

    def nested(npz):
        tree = {{}}
        for path in npz.files:
            node = tree
            *parts, last = path.split("/")
            for p in parts:
                node = node.setdefault(p, {{}})
            node[last] = npz[path]
        return tree

    mesh = build_mesh("data=4,model=2", device="cpu")
    rank = dist.get_rank()
    res, mine = {{}}, {{}}
    for arch in FAMILIES:
        model = build_model(ARCHITECTURES[arch].reduced())
        params = params_from_numpy(nested(np.load(os.path.join(
            ref, arch + ".npz"))), device="cpu", template=model.template)
        extra = {{k: torch.zeros((len(PROMPTS),) + s.shape[1:], dtype=s.dtype)
                  for k, s in model.extra_inputs(len(PROMPTS)).items()}}
        eng = Engine(model, params, ServeConfig(max_batch=8, max_len=64,
                                                device="cpu", mesh=mesh))
        r = {{"tokens": eng.generate(PROMPTS, 5, extra_inputs=extra or None)}}
        st = eng.stats()
        mine[arch] = {{k: st[k] for k in ("device_transfers", "chunks",
                                           "waves")}}
        if arch == "llama3.2-1b":
            r["mesh"], r["sharding"] = st["mesh"], st["sharding"]
            r["lookups"] = {{k: v["local_shape"]
                             for k, v in st["decode_tile_lookups"].items()}}
            r["warm"] = eng.generate(PROMPTS, 5)
            r["hits_full"] = eng.stats()["prefix_cache"]["hits_full"]
            wave = Engine(model, params, ServeConfig(
                max_batch=8, max_len=64, device="cpu", mesh=mesh,
                scheduler="wave"))
            r["wave"] = wave.generate(PROMPTS, 5)
            sync = [[(5 * i + j) % model.cfg.vocab_size for j in range(8)]
                    for i in range(8)]
            r["sync"] = PerTokenSyncEngine(model, params,
                                           max_len=64).generate(sync, 5)
            meshed = PerTokenSyncEngine(model, params, max_len=64, mesh=mesh)
            r["sync_mesh"] = meshed.generate(sync, 5)
            r["sync_sharded"] = any(
                isinstance(t, DTensor) and not all(
                    pl.is_replicate() for pl in t.placements)
                for t in tree_paths(meshed.params).values())
            st = wave.stats()
            mine[arch + ":wave"] = {{k: st[k] for k in (
                "device_transfers", "chunks", "waves")}}
            # the Server on rank 0, the other ranks following it
            srv_eng = Engine(model, params, ServeConfig(
                max_batch=8, max_len=64, device="cpu", mesh=mesh))
            if rank == 0:
                events = [[] for _ in PROMPTS]
                with Server(srv_eng) as srv:
                    handles = [srv.submit(Request(
                        prompt=p, max_new_tokens=5, stream=events[i].append))
                        for i, p in enumerate(PROMPTS)]
                    r["server"] = [h.result(timeout=120).tokens
                                   for h in handles]
                r["streamed"] = [[e.token for e in ev if not e.finished]
                                 for ev in events]
            else:
                follow(srv_eng)
            st = srv_eng.stats()
            mine[arch + ":server"] = {{k: st[k] for k in (
                "device_transfers", "chunks", "waves", "requests")}}
        res[arch] = r
    for arch in TRAIN_ARCHS:
        model = build_model(ARCHITECTURES[arch].reduced())
        opt = AdamW()
        tree = nested(np.load(os.path.join(ref, arch + "-state.npz")))
        state = train_state_from_numpy(SimpleNamespace(
            step=tree["step"], params=tree["params"],
            opt=SimpleNamespace(**tree["opt"]), compression=None),
            device="cpu", template=model.template)
        pipe = TokenPipeline(DataConfig(vocab_size=256, seq_len={seq},
                                        global_batch={batch}), device="cpu")
        b0, b1 = pipe(0), pipe(1)
        step = make_train_step(model, opt)
        rules = sh.rules_for_mesh(mesh)
        placed = place_state(state, state_shardings(mesh, rules, model))
        with dctx.activation_policy(mesh, rules):
            bs = [sh.distribute_tree(b, sh.batch_shardings(mesh, rules, b))
                  for b in (b0, b1)]
            _, _, g = _value_and_grad(model, placed.params, bs[0])
            s1, m1 = step(placed, bs[0])
            s2, m2 = step(s1, bs[1])
        grads = {{p: sh.full(t).numpy() for p, t in tree_paths(g).items()}}
        _, _, g1 = _value_and_grad(model, state.params, b0)
        plain = {{p: t.numpy() for p, t in tree_paths(g1).items()}}
        res[arch + ":train"] = {{
            "losses": [float(sh.full(m1["loss"])), float(sh.full(m2["loss"]))],
            "grad_norm": float(sh.full(m1["grad_norm"]))}}
        ck = Checkpointer(os.path.join(out, arch + "-ckpt"))
        ck.save(2, s2)
        whole = {{p: sh.full(t).float().numpy()
                  for p, t in tree_paths(s2.params).items()}}
        if rank == 0:
            np.savez(os.path.join(out, arch + "-grads.npz"), **grads)
            np.savez(os.path.join(out, arch + "-plain-grads.npz"), **plain)
            np.savez(os.path.join(out, arch + "-params2.npz"), **whole)
    with open(os.path.join(out, f"rank{{rank}}.json"), "w") as f:
        json.dump(mine, f)
    if rank == 0:
        with open(os.path.join(out, "port.json"), "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()
""")

_RESTORE = textwrap.dedent("""
    import os, sys
    import numpy as np
    import torch.distributed as dist
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.catalog import ARCHITECTURES
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_paths
    from repro_torch.optim import AdamW
    from repro_torch.train.trainer import (abstract_train_state,
                                           state_shardings)

    out = sys.argv[1]
    mesh = build_mesh("data=2,model=2", device="cpu")
    for arch in {train!r}:
        model = build_model(ARCHITECTURES[arch].reduced())
        opt = AdamW()
        lay = state_shardings(mesh, sh.rules_for_mesh(mesh), model)
        st = Checkpointer(os.path.join(out, arch + "-ckpt")).restore(
            2, abstract_train_state(model, opt), device="cpu",
            shardings=lay)
        ok = all(tuple(t.placements) == tuple(
            tree_paths(lay.params)[p].placements)
            for p, t in tree_paths(st.params).items())
        whole = {{p: sh.full(t).float().numpy()
                  for p, t in tree_paths(st.params).items()}}
        if dist.get_rank() == 0:
            whole["__placed__"] = np.array(ok)
            np.savez(os.path.join(out, arch + "-restored-2x2.npz"), **whole)
    dist.destroy_process_group()
""")


def _env():
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _start(cmd):
    """A process in a session of its own, so that a hung run is killed
    with every rank it started."""
    return subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def _finish(proc, timeout):
    """(returncode, stdout + stderr) of ``proc``; killed, with its
    session, past ``timeout`` seconds (which then fails the caller)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, err = proc.communicate()
        return -9, f"timed out after {timeout} s\n{out}{err}"
    return proc.returncode, out + err


def _torchrun(n, script, *args):
    return _start([sys.executable, "-m", "torch.distributed.run",
                   "--standalone", "--nproc_per_node", str(n), str(script),
                   *map(str, args)])


def _export(out: Path) -> None:
    """The reference's weights (seed 1, as test_engine_mesh draws them) and
    train states (seed 0), as numpy, for the port's ranks to load."""
    from repro.optim import AdamW as JAdamW
    from repro.train import init_train_state as jinit

    def save(path, tree):
        np.savez(path, **{p: np.asarray(v)
                          for p, v in _jax_paths(tree).items()})
    for arch in FAMILIES:
        model = jbuild(JARCHS[arch].reduced())
        save(out / f"{arch}.npz", model.init(jax.random.PRNGKey(1)))
    for arch in TRAIN_ARCHS:
        st = jinit(jbuild(JARCHS[arch].reduced()), JAdamW(),
                   jax.random.PRNGKey(0))
        save(out / f"{arch}-state.npz", {
            "step": st.step, "params": st.params,
            "opt": {"count": st.opt.count, "m": st.opt.m, "v": st.opt.v,
                    "master": st.opt.master}})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' results: the reference's one process and the port's 8
    gloo ranks run at once; then the port's 2 x 2 restore."""
    d = tmp_path_factory.mktemp("mesh")
    ref, port = d / "ref", d / "port"
    ref.mkdir()
    port.mkdir()
    _export(ref)
    fmt = dict(families=FAMILIES, train=TRAIN_ARCHS, prompts=PROMPTS,
               seq=SEQ, batch=BATCH)
    (d / "reference.py").write_text(_REFERENCE.format(**fmt))
    (d / "port.py").write_text(_PORT.format(**fmt))
    (d / "restore.py").write_text(_RESTORE.format(**fmt))
    ref_proc = _start([sys.executable, str(d / "reference.py"), str(ref)])
    port_proc = _torchrun(8, d / "port.py", ref, port)
    port_rc, port_log = _finish(port_proc, 300)
    ref_rc, ref_log = _finish(ref_proc, 400)
    assert ref_rc == 0, ref_log[-3000:]
    assert port_rc == 0, port_log[-4000:]
    rc, log = _finish(_torchrun(4, d / "restore.py", port), 200)
    assert rc == 0, log[-4000:]
    with open(ref / "reference.json") as f:
        want = json.load(f)
    with open(port / "port.json") as f:
        got = json.load(f)
    ranks = []
    for r in range(8):
        with open(port / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    return SimpleNamespace(ref=want, port=got, ranks=ranks, ref_dir=ref,
                           port_dir=port)


@pytest.mark.parametrize("arch", FAMILIES)
def test_mesh_serve_tokens_equal_the_references_mesh(runs, arch):
    assert runs.port[arch]["tokens"] == runs.ref[arch]["tokens"], arch


def test_mesh_continuous_equals_wave_and_the_reference(runs):
    r, p = runs.ref["llama3.2-1b"], runs.port["llama3.2-1b"]
    assert p["wave"] == p["tokens"] == r["wave"]


def test_per_token_sync_on_the_mesh_equals_plain_and_the_reference(runs):
    """The sync baseline on data=4,model=2 shards its params and stays pure
    layout: the same tokens on and off the mesh, in both packages
    (``tests/test_engine_mesh.py:261-285``)."""
    r, p = runs.ref["llama3.2-1b"], runs.port["llama3.2-1b"]
    assert p["sync_mesh"] == p["sync"] == r["sync_mesh"] == r["sync"]
    assert p["sync_sharded"]


def test_server_on_rank_zero_with_followers_serves_the_same_tokens(runs):
    """A ``Server`` on rank 0 of the 4 x 2 mesh, every other rank in
    ``serve.server.follow``: the streamed and returned tokens are the
    batch's, and every rank ran the same requests in the same chunks."""
    p = runs.port["llama3.2-1b"]
    assert p["server"] == p["streamed"] == p["tokens"]
    for mine in runs.ranks:
        assert mine["llama3.2-1b:server"] == runs.ranks[0][
            "llama3.2-1b:server"]
        assert mine["llama3.2-1b:server"]["requests"] == len(PROMPTS)


def test_mesh_warm_prefix_cache_serves_the_same_tokens(runs):
    r, p = runs.ref["llama3.2-1b"], runs.port["llama3.2-1b"]
    assert p["warm"] == p["tokens"] == r["warm"]
    assert p["hits_full"] >= len(PROMPTS)


@pytest.mark.parametrize("rank", range(8))
def test_one_host_transfer_per_chunk_or_wave_on_every_rank(runs, rank):
    mine = runs.ranks[rank]
    for key, st in mine.items():
        assert st["device_transfers"] == st["chunks"] + st["waves"] >= 1, key
    assert mine == runs.ranks[0]      # the same schedule on every rank


def test_mesh_stats_equal_the_references(runs):
    r, p = runs.ref["llama3.2-1b"], runs.port["llama3.2-1b"]
    assert p["mesh"] == r["mesh"] == {"devices": 8,
                                      "axes": {"data": 4, "model": 2},
                                      "label": "data4xmodel2"}
    assert p["sharding"] == r["sharding"]
    assert p["sharding"]["rules"]["fsdp_axis"] is None


def test_decode_lookups_are_keyed_on_the_references_local_shapes(runs):
    """The same keys (global shapes; ``global->local`` where weights split
    one (K, N) two ways) with the same local shapes, but for llama's tied
    head: the reference derives local shapes from the template's
    divisors, which key the embedding (V, D), not its transpose, so it
    reports the head unsplit; the port records the product it runs, split
    over ``model`` (ROADMAP, queue 3)."""
    r, p = runs.ref["llama3.2-1b"], runs.port["llama3.2-1b"]
    assert set(p["lookups"]) == set(r["lookups"])
    head = "8x64x256"
    assert r["lookups"][head] == "2x64x256"
    assert p["lookups"][head] == "2x64x128"
    for key, local in r["lookups"].items():
        if key != head:
            assert p["lookups"][key] == local, key
    assert sum("->" in k for k in p["lookups"]) == 2


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_mesh_train_losses_match_the_references_mesh(runs, arch):
    r, p = runs.ref[arch + ":train"], runs.port[arch + ":train"]
    np.testing.assert_allclose(p["losses"], r["losses"], **METRIC_TOL)
    np.testing.assert_allclose(p["grad_norm"], r["grad_norm"], **METRIC_TOL)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_mesh_gradients_match_the_references_mesh(runs, arch):
    want = np.load(runs.ref_dir / f"{arch}-grads.npz")
    got = np.load(runs.port_dir / f"{arch}-grads.npz")
    assert set(got.files) == set(want.files)
    for p in want.files:
        np.testing.assert_allclose(got[p], want[p], err_msg=p, **GRAD_TOL)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_mesh_gradients_match_the_ports_single_device(runs, arch):
    got = np.load(runs.port_dir / f"{arch}-grads.npz")
    plain = np.load(runs.port_dir / f"{arch}-plain-grads.npz")
    for p in plain.files:
        np.testing.assert_allclose(got[p], plain[p], err_msg=p, **GRAD_TOL)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_checkpoint_from_4x2_restores_on_2x2_and_without_a_mesh(runs, arch):
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.optim import AdamW
    from repro_torch.train.trainer import abstract_train_state
    want = np.load(runs.port_dir / f"{arch}-params2.npz")
    on_2x2 = np.load(runs.port_dir / f"{arch}-restored-2x2.npz")
    assert bool(on_2x2["__placed__"])
    model = build_model(ARCHITECTURES[arch].reduced())
    plain = Checkpointer(str(runs.port_dir / f"{arch}-ckpt")).restore(
        2, abstract_train_state(model, AdamW()), device="cpu")
    for p, t in tree_paths(plain.params).items():
        np.testing.assert_array_equal(t.float().numpy(), want[p], err_msg=p)
        np.testing.assert_array_equal(on_2x2[p], want[p], err_msg=p)
