"""Int8 gradient compression with error feedback.

Each gradient leaf plus the carried residual is quantized to int8 with one
f32 scale per leaf (what would cross the network in a data-parallel
reduction) and dequantized for the optimizer; the quantization error is
carried into the next step's gradient (error feedback keeps the scheme
unbiased in the long run).  The same arithmetic as the reference, leaf for
leaf: round half to even, scale ``max|x| / 127`` floored at 1e-12.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.params import in_layout_of, map_tree, map_trees


class CompressionState(NamedTuple):
    residual: Any     # per-leaf error-feedback carry (f32)


def init_state(params) -> CompressionState:
    return CompressionState(residual=map_tree(
        lambda _p, p: torch.zeros_like(p, dtype=torch.float32), params))


def abstract_state(abstract_params) -> CompressionState:
    """Shapes, strides and dtypes only (``meta`` tensors): a restore
    template."""
    return CompressionState(residual=map_tree(
        lambda _p, p: torch.empty_like(p, dtype=torch.float32,
                                       device="meta"), abstract_params))


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads, state: CompressionState):
    """-> (dequantized grads for the optimizer, new state)."""
    def leaf(g, r):
        gf = g.float() + r
        q, scale = _quantize(gf)
        deq = q.float() * scale
        return deq, in_layout_of(r, gf - deq)   # the residual's layout

    deq, res = map_trees(leaf, grads, state.residual)
    return deq, CompressionState(residual=res)
