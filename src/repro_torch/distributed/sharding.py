"""Logical-axis -> mesh-axis sharding rules (DP/FSDP/TP/EP/SP) on
``torch.distributed`` ``DeviceMesh`` / DTensor.

Parameters carry logical axis names in their ``ParamSpec``
(``models/params.py``); this module maps them to a *spec*: a tuple with one
entry per dim, each a mesh-axis name, a tuple of names, or None, the
counterpart of the reference's ``PartitionSpec`` (an entry of one name is
the name itself, as JAX normalises it, so ``str(spec)`` is the reference's
``str(tuple(P))``).  The spec functions read only the mesh's axis names and
sizes, so they take a ``DeviceMesh`` or any object with ``axis_names`` and
a ``shape`` mapping of names to sizes.

Rules of thumb, as the reference's:
  * "vocab" / "ff" / "expert"  -> "model"  (tensor / expert parallel)
  * "embed" (d_model dims)     -> "data"   (FSDP) when enabled
  * 1-D params (norm scales, biases) are replicated
  * a mesh axis is used at most once per spec (first dim wins)
  * dims not divisible by the axis size fall back to replicated

:func:`placements_for` turns a spec into DTensor placements (``Shard(d)``
on the mesh dims a tensor dim names, ``Replicate()`` elsewhere); the tree
functions place a param, batch or cache tree by the rules.  Placing a
plain tensor takes the local block of a tensor every rank holds whole
(every rank seeds and reads identically), so it moves no data between
ranks; a DTensor is redistributed (the elastic re-shard).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.ops import same_layout
from repro_torch.models.params import ParamSpec, map_tree, tree_paths

Spec = Tuple[object, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """The tuning knobs of the distribution layer."""
    tensor_axis: Optional[str] = "model"     # TP/EP target axis
    fsdp_axis: Optional[str] = "data"        # weight-shard axis (None = pure DP)
    batch_axes: Tuple[str, ...] = ("data",)  # activation batch axes
    sequence_axis: Optional[str] = None      # SP: shard activation seq dim

    def logical_map(self):
        return {
            "vocab": self.tensor_axis,
            "ff": self.tensor_axis,
            "expert": self.tensor_axis,
            "embed": self.fsdp_axis,
            "layer": None,
            None: None,
        }

    def describe(self) -> Dict[str, object]:
        """JSON-friendly form (``Engine.stats()["sharding"]["rules"]``)."""
        return {"tensor_axis": self.tensor_axis,
                "fsdp_axis": self.fsdp_axis,
                "batch_axes": list(self.batch_axes),
                "sequence_axis": self.sequence_axis}


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, in mesh-dim order."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a stub whose ``shape``
    maps names to sizes."""
    if isinstance(mesh.shape, dict):
        return {a: int(mesh.shape[a]) for a in axis_names(mesh)}
    return dict(zip(axis_names(mesh), (int(s) for s in mesh.shape)))


def rules_for_mesh(mesh, *, fsdp: bool = True,
                   sequence_parallel: bool = False) -> ShardingRules:
    axes = axis_names(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in axes) or (axes[0],)
    return ShardingRules(
        tensor_axis="model" if "model" in axes else None,
        fsdp_axis="data" if (fsdp and "data" in axes) else None,
        batch_axes=batch_axes,
        sequence_axis="model" if (sequence_parallel and "model" in axes)
        else None,
    )


def axis_size(mesh, axis) -> int:
    """Size of a mesh axis, a tuple of axes (their product), or None (1)."""
    if axis is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(axis, tuple):
        return math.prod(sizes[a] for a in axis)
    return sizes[axis]


def _entry(axes) -> object:
    """A spec entry as JAX normalises it: one axis is its name."""
    if isinstance(axes, tuple) and len(axes) == 1:
        return axes[0]
    return axes


def spec_for_param(mesh, rules: ShardingRules, spec: ParamSpec) -> Spec:
    if len(spec.shape) <= 1:
        return ()
    mapping = rules.logical_map()
    used = set()
    out = []
    for dim, axis_name in zip(spec.shape, spec.axes):
        mesh_axis = mapping.get(axis_name)
        if (mesh_axis is None or mesh_axis in used
                or dim % axis_size(mesh, mesh_axis) != 0):
            out.append(None)
        else:
            out.append(mesh_axis)
            used.add(mesh_axis)
    return tuple(out)


def param_specs(mesh, rules: ShardingRules, template) -> Dict[str, Spec]:
    """``{path: spec}`` of every param leaf (paths as ``map_tree`` names
    them)."""
    out: Dict[str, Spec] = {}
    map_tree(lambda p, s: out.__setitem__(p, spec_for_param(mesh, rules, s)),
             template)
    return out


def _spec_leaves(template):
    out = []
    map_tree(lambda _p, s: out.append(s), template)
    return out


def sharding_summary(mesh, rules: ShardingRules, template) -> dict:
    """How many param leaves each spec got, keyed as the reference keys
    them: ``{"('data', 'model')": 9, "()": 14}``."""
    counts: dict = {}
    for spec in _spec_leaves(template):
        key = str(spec_for_param(mesh, rules, spec))
        counts[key] = counts.get(key, 0) + 1
    return counts


def local_gemm_divisors(mesh, rules: ShardingRules, template):
    """``{(k, n): ((div_k, div_n), ...)}`` over the template's matmul
    weights: the last two dims of each >= 2-D param are the (K, N) the
    matmul sees, and a dim's divisor is the size of the mesh axes its spec
    shards it over.  Every distinct pair is kept (a square ``wq`` and
    ``wo`` shard one global (K, N) both ways), sorted."""
    out: dict = {}
    for spec in _spec_leaves(template):
        if len(spec.shape) < 2:
            continue
        sp = spec_for_param(mesh, rules, spec)
        k, n = spec.shape[-2], spec.shape[-1]
        dk = axis_size(mesh, sp[-2])
        dn = axis_size(mesh, sp[-1])
        out.setdefault((k, n), set()).add((dk, dn))
    return {key: tuple(sorted(vals)) for key, vals in out.items()}


# ---------------------------------------------------------------------------
# Activation / batch / cache specs
# ---------------------------------------------------------------------------

def batch_spec(mesh, rules: ShardingRules, batch_size: int, rank: int) -> Spec:
    """Spec for a (B, ...) activation-like tensor."""
    ba = rules.batch_axes
    if batch_size % axis_size(mesh, ba) == 0:
        return (_entry(ba),) + (None,) * (rank - 1)
    # fewer axes (e.g. B=1 long-context: replicate the batch dim)
    sub = ba[:1]
    if batch_size % axis_size(mesh, sub) == 0:
        return (_entry(sub),) + (None,) * (rank - 1)
    return (None,) * rank


def cache_spec(mesh, rules: ShardingRules, shape: Tuple[int, ...],
               batch_dim: int, seq_dim: Optional[int] = None,
               head_dim: Optional[int] = None) -> Spec:
    """Spec for KV caches / recurrent states with leading layer dims: batch
    over the data axes, else (long-context B=1) the sequence; heads on the
    tensor axis when they divide it, else (GQA with fewer KV heads than
    the axis) the sequence."""
    out: list = [None] * len(shape)
    ba = rules.batch_axes
    if shape[batch_dim] % axis_size(mesh, ba) == 0:
        out[batch_dim] = _entry(ba)
    elif seq_dim is not None and shape[seq_dim] % axis_size(mesh, ba) == 0:
        out[seq_dim] = _entry(ba)
    ta = rules.tensor_axis
    if ta:
        if (head_dim is not None
                and shape[head_dim] % axis_size(mesh, ta) == 0):
            out[head_dim] = ta
        elif (seq_dim is not None and out[seq_dim] is None
                and shape[seq_dim] % axis_size(mesh, ta) == 0):
            out[seq_dim] = ta
    return tuple(out)


#: cache-tree key -> leaf kind (the reference's ``cache_shardings`` walk)
_CACHE_KINDS = {"self": "kv", "cross": "kv", "ssm": "ssm", "conv": "conv",
                "s": "kv_scale"}


def cache_specs(mesh, rules: ShardingRules, cache) -> Dict[str, Spec]:
    """``{path: spec}`` of every leaf of a cache tree, by the key it hangs
    under: KV ``(L..., B, S, KV, hd)``, an int8 cache's scales ``(L..., B,
    S, KV)`` (``"s"``; its ``"q"`` is KV), SSM state ``(L..., B, H, N,
    P)``, conv state ``(L..., B, K-1, C)``."""
    out: Dict[str, Spec] = {}

    def walk(tree, path, kind=None):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}" if path else str(k),
                     kind if k == "q" else _CACHE_KINDS.get(k, kind))
            return
        if isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                walk(v, f"{path}/{i}" if path else str(i), kind)
            return
        n = len(tree.shape)
        if kind == "kv_scale":
            sp = cache_spec(mesh, rules, tree.shape, n - 3, seq_dim=n - 2,
                            head_dim=n - 1)
        elif kind == "kv":
            sp = cache_spec(mesh, rules, tree.shape, n - 4, seq_dim=n - 3,
                            head_dim=n - 2)
        elif kind == "conv":
            sp = cache_spec(mesh, rules, tree.shape, n - 3, head_dim=n - 1)
        else:
            sp = cache_spec(mesh, rules, tree.shape, n - 4, head_dim=n - 3)
        out[path] = sp
    walk(cache, "")
    return out


def pool_spec(mesh, rules: ShardingRules, shape: Tuple[int, ...]) -> Spec:
    """A flat paged-KV pool ``(L..., P*S, KV, hd)`` has no batch dim: its KV
    heads go on the tensor axis when they divide it, else it is
    replicated (the reference's ``serve/engine.py`` pool rule)."""
    out: list = [None] * len(shape)
    ta = rules.tensor_axis
    if ta and shape[-2] % axis_size(mesh, ta) == 0:
        out[len(shape) - 2] = ta
    return tuple(out)


# ---------------------------------------------------------------------------
# Specs -> DTensor placements, and placing trees
# ---------------------------------------------------------------------------

def placements_for(mesh, spec: Spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` where tensor dim d names that axis, else ``Replicate()``."""
    out = []
    for name in axis_names(mesh):
        dim = next((d for d, e in enumerate(spec)
                    if e == name or (isinstance(e, tuple) and name in e)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where one tensor lives: a mesh and its DTensor placements (the
    counterpart of the reference's ``NamedSharding``; a tree leaf)."""
    mesh: object
    placements: tuple

    @classmethod
    def of(cls, mesh, spec: Spec) -> "Layout":
        return cls(mesh, placements_for(mesh, spec))


def param_placements(mesh, rules: ShardingRules, template):
    """The :class:`Layout` of every param leaf, in the template's tree."""
    return map_tree(lambda _p, s: Layout.of(
        mesh, spec_for_param(mesh, rules, s)), template)


def local_block(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``t`` (whole on every rank) under
    ``placements``: a view when nothing is split; a split block is copied
    in ``t``'s layout (a K-major leaf stays K-major)."""
    coord = mesh.get_coordinate()
    local = t
    for mdim, p in enumerate(placements):
        if isinstance(p, Shard) and mesh.size(mdim) > 1:
            n = mesh.size(mdim)
            size = local.shape[p.dim] // n
            local = local.narrow(p.dim, coord[mdim] * size, size)
    if local is t:
        return t
    if t.dim() == 2 and t.stride(0) == 1 and t.stride(1) != 1:
        return local.t().contiguous().t()
    return local.contiguous()


def distribute(t: torch.Tensor, mesh, placements) -> DTensor:
    """``t`` as a DTensor with ``placements``: a plain tensor (the same on
    every rank) keeps this rank's block; a DTensor is redistributed."""
    if isinstance(t, DTensor):
        if same_layout(mesh, t.placements, placements):
            return t
        return t.redistribute(mesh, placements)
    return DTensor.from_local(local_block(t, mesh, placements), mesh,
                              placements, run_check=False, shape=t.shape,
                              stride=t.stride())


def distribute_tree(tree, layouts):
    """:func:`distribute` over a tree, leaf by leaf (one whole leaf and its
    block live at a time), each leaf to the :class:`Layout` at its path in
    ``layouts``."""
    at = tree_paths(layouts)
    return map_tree(lambda p, x: distribute(x, at[p].mesh, at[p].placements),
                    tree)


def shard_params(params, mesh, rules: ShardingRules, template):
    """Place a param tree by the rules: same values, sharded layout."""
    return distribute_tree(params, param_placements(mesh, rules, template))


def batch_shardings(mesh, rules: ShardingRules, batch):
    """The :class:`Layout` of every (B, ...) leaf of a batch tree."""
    return map_tree(lambda _p, x: Layout.of(
        mesh, batch_spec(mesh, rules, x.shape[0], x.dim())), batch)


def cache_shardings(mesh, rules: ShardingRules, cache):
    """The :class:`Layout` of every leaf of a cache tree
    (:func:`cache_specs`)."""
    specs = cache_specs(mesh, rules, cache)
    return map_tree(lambda p, _x: Layout.of(mesh, specs[p]), cache)


def full(t):
    """A DTensor's whole value on every rank (a plain tensor as it is)."""
    return t.full_tensor() if isinstance(t, DTensor) else t
