"""The model's weights, made by the benchmark from the seed, on the device.

Both sides take these same tensors: the program as its parameter tree,
the reference by the same paths.  Each leaf is one draw of a generator on
the device, seeded from (seed, path), in the served type.  Matrices are
normal with the leaf's stated scale, else 1 / sqrt(fan in); a norm's
scale is 1 + 0.05 n and its bias 0.05 n, so the norms' parameters take
part in the comparison.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch


def leaf_seed(seed: int, path: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{path}".encode()).digest()
    return int.from_bytes(digest[:8], "big") >> 1


def walk(tree, path: str = ""):
    """(path, leaf) of a nested dict / tuple tree, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from walk(v, f"{path}/{k}" if path else str(k))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from walk(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def rebuild(tree, fn, path: str = ""):
    if isinstance(tree, dict):
        return {k: rebuild(v, fn, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(rebuild(v, fn, f"{path}/{i}" if path else str(i))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def make(template, seed: int, dtype: torch.dtype, device) -> dict:
    """The parameter tree of ``template`` (the program's layout: each leaf
    has ``shape``, ``init``, ``scale`` and ``kmajor``), drawn from
    ``seed``."""
    def leaf(path, spec):
        gen = torch.Generator(device=device)
        gen.manual_seed(leaf_seed(seed, path))
        shape = tuple(spec.shape)
        store = shape[::-1] if spec.kmajor else shape
        x = torch.randn(store, generator=gen, device=device, dtype=dtype)
        if spec.init == "ones":
            x.mul_(0.05).add_(1.0)
        elif spec.init == "zeros":
            x.mul_(0.05)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else max(shape[-1], 1)
            x.mul_(spec.scale if spec.scale is not None
                   else 1.0 / math.sqrt(fan_in))
        return x.t() if spec.kmajor else x
    return rebuild(template, leaf)


def flat(params) -> Dict[str, torch.Tensor]:
    return dict(walk(params))
