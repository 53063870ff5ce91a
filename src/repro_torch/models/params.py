"""Parameter templates, seeded init, and the JAX -> torch weight bridge.

A model module builds a nested dict of ``ParamSpec`` (shape + logical axes +
init rule), the same tree the JAX package builds.  ``init_params`` turns it
into tensors drawn from a seeded ``torch.Generator`` on the target device,
at the reference's scales (``1/sqrt(fan_in)``, per-spec overrides, ones /
zeros); the values differ from ``jax.random``'s, so parity tests copy the
JAX params over with ``params_from_numpy`` instead.
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


def _leaf_seed(seed: int, path: str) -> int:
    digest = int.from_bytes(hashlib.sha256(path.encode()).digest()[:4], "big")
    return (int(seed) * 0x9E3779B1 + digest) % (2 ** 63)


def init_params(template, seed: int = 0, default_dtype: str = "float32",
                device: DeviceLike = None):
    """Random parameters from a template, drawn on ``device`` (default: the
    card).  Each leaf has its own generator, seeded from ``seed`` and the
    leaf's path, so values do not depend on the order of the walk."""
    dev = resolve_device(device)

    def init_leaf(path: str, spec: ParamSpec) -> torch.Tensor:
        dtype = getattr(torch, spec.dtype or default_dtype)
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else max(spec.shape[-1], 1)
        scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(fan_in)
        gen = torch.Generator(device=dev)
        gen.manual_seed(_leaf_seed(seed, path))
        x = torch.randn(spec.shape, generator=gen, device=dev,
                        dtype=torch.float32)
        return (x * scale).to(dtype)

    return map_tree(init_leaf, template)


def param_count(template) -> int:
    return sum(math.prod(spec.shape) for spec in tree_leaves(template))


def params_from_numpy(tree, device: DeviceLike = None):
    """Copy a tree of numpy arrays (e.g. JAX params through ``np.asarray``)
    into torch tensors on ``device``, bit for bit.

    A bfloat16 leaf may arrive as ml_dtypes' ``bfloat16`` or as its
    ``uint16`` view; either becomes ``torch.bfloat16`` by reinterpretation,
    never by a float round trip.
    """
    dev = resolve_device(device)

    def leaf(_path, arr):
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16" or arr.dtype == np.uint16:
            bits = np.ascontiguousarray(arr).view(np.int16).copy()
            t = torch.from_numpy(bits).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr, copy=True))
        return t.to(dev)

    return map_tree(leaf, tree)
