"""Parameter templates, seeded init, and the JAX -> torch weight bridge.

A model module builds a nested dict of ``ParamSpec`` (shape + logical axes +
init rule), the same tree the JAX package builds.  ``init_params`` turns it
into tensors drawn from a seeded ``torch.Generator`` on the target device,
at the reference's scales (``1/sqrt(fan_in)``, per-spec overrides, ones /
zeros); the values differ from ``jax.random``'s, so parity tests copy the
JAX params over with ``params_from_numpy`` instead.  A ``kmajor`` leaf
(2-D) is the transpose of a contiguous buffer of the reversed shape; both
paths lay it out so.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]      # logical axis name per dim (or None)
    init: str = "normal"                 # normal | zeros | ones
    scale: Optional[float] = None        # stddev; None -> 1/sqrt(fan_in)
    dtype: Optional[str] = None          # override model dtype
    kmajor: bool = False                 # 2-D: stored as buffer.t(), buffer
                                         # contiguous (shape[1], shape[0])

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def map_tree(fn, tree, path: str = ""):
    """Apply ``fn(path, leaf)`` over a nested dict/tuple/list tree."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves(tree):
    out = []
    map_tree(lambda _p, leaf: out.append(leaf), tree)
    return out


def tree_paths(tree) -> dict:
    """``{path: leaf}`` of a tree, in ``map_tree``'s order."""
    out = {}
    map_tree(lambda p, leaf: out.__setitem__(p, leaf), tree)
    return out


def map_trees(fn, tree, *others):
    """``fn(leaf, *others' leaves at the same path)`` over ``tree``, where
    ``fn`` returns a tuple: one tree per element of it comes back.  The
    trees are matched by path, not by order, so trees of one template whose
    dicts were built in different key orders line up."""
    cols = [tree_paths(o) for o in others]
    res = {p: fn(x, *(c[p] for c in cols)) for p, x in tree_paths(tree).items()}
    n = len(next(iter(res.values())))
    return tuple(map_tree(lambda p, _x: res[p][j], tree) for j in range(n))


def in_layout_of(like: torch.Tensor, t: torch.Tensor, dtype=None,
                 device=None) -> torch.Tensor:
    """``t`` (``like``'s shape) with ``like``'s strides, in ``dtype`` and on
    ``device`` (default: ``t``'s): ``t`` cast and moved when the strides
    already agree, else a copy into ``torch.empty_like(like)``.  Keeps a
    K-major leaf K-major through what would lay it out row-major."""
    dtype = dtype or t.dtype
    device = device or t.device
    if t.stride() == like.stride():
        return t.to(device=device, dtype=dtype)
    return torch.empty_like(like, dtype=dtype, device=device).copy_(t)


def _leaf_seed(seed: int, path: str) -> int:
    digest = int.from_bytes(hashlib.sha256(path.encode()).digest()[:4], "big")
    return (int(seed) * 0x9E3779B1 + digest) % (2 ** 63)


def init_params(template, seed: int = 0, default_dtype: str = "float32",
                device: DeviceLike = None, place=None):
    """Random parameters from a template, drawn on ``device`` (default: the
    card).  Each leaf has its own generator, seeded from ``seed`` and the
    leaf's path, so values do not depend on the order of the walk (nor on
    the rank: every rank of a mesh draws the same).  ``place(path, leaf)``
    is applied to each leaf as it is drawn (a mesh's placement), so one
    whole leaf at a time is live beside the placed tree."""
    dev = resolve_device(device)

    def init_leaf(path: str, spec: ParamSpec) -> torch.Tensor:
        leaf = draw_leaf(path, spec)
        return leaf if place is None else place(path, leaf)

    def draw_leaf(path: str, spec: ParamSpec) -> torch.Tensor:
        dtype = getattr(torch, spec.dtype or default_dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
        scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
        gen = torch.Generator(device=dev)
        gen.manual_seed(_leaf_seed(seed, path))
        shape = spec.shape[::-1] if spec.kmajor else spec.shape
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        # scaled in place: one f32 staging copy of this leaf, not two
        x = x.mul_(scale).to(dtype)
        return x.t() if spec.kmajor else x

    return map_tree(init_leaf, template)


def param_count(template) -> int:
    return sum(math.prod(spec.shape) for spec in tree_leaves(template))


def params_from_numpy(tree, device: DeviceLike = None, template=None):
    """Copy a tree of numpy arrays (e.g. JAX params through ``np.asarray``)
    into torch tensors on ``device``, bit for bit.

    A bfloat16 leaf may arrive as ml_dtypes' ``bfloat16`` or as its
    ``uint16`` view; either becomes ``torch.bfloat16`` by reinterpretation,
    never by a float round trip.  With the model's ``template``, its
    ``kmajor`` leaves are laid out K-major (same shape and values).
    """
    dev = resolve_device(device)
    kmajor = set()
    if template is not None:
        map_tree(lambda p, spec: kmajor.add(p) if spec.kmajor else None,
                 template)

    def leaf(path, arr):
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16" or arr.dtype == np.uint16:
            bits = np.ascontiguousarray(arr).view(np.int16).copy()
            t = torch.from_numpy(bits).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        if path in kmajor:
            return t.t().contiguous().to(dev).t()
        return t.to(dev)

    return map_tree(leaf, tree)


def train_state_from_numpy(state, device: DeviceLike = None, template=None):
    """A reference train state whose leaves are numpy arrays (``step``,
    ``params``, ``opt`` with ``count`` / ``m`` / ``v`` / ``master``, and
    ``compression`` with ``residual``, or None) as the port's
    ``TrainState``, bit for bit, every tree through
    :func:`params_from_numpy` (``template`` lays out the K-major leaves of
    the params and of every tree shaped like them)."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.compression import CompressionState
    from repro_torch.train.trainer import TrainState

    conv = lambda tree: params_from_numpy(tree, device, template)  # noqa: E731
    opt = state.opt
    comp = state.compression
    return TrainState(
        step=params_from_numpy(state.step, device),
        params=conv(state.params),
        opt=AdamWState(params_from_numpy(opt.count, device), conv(opt.m),
                       conv(opt.v), conv(opt.master)),
        compression=None if comp is None
        else CompressionState(residual=conv(comp.residual)))
