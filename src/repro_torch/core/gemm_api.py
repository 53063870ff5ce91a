"""The single public matmul entry point: every model matmul goes here.

The algorithm (``kernels/csrc/gemm.cu``) is written once; which tiles it
runs with comes from the H100 tile table (``core.tile_config``), and which
path runs follows the tensors' device: the CUDA kernel on the card, the
plain version on the CPU.  Model code never mentions tiles.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import List, Optional, Tuple

import torch

from repro_torch.core.tile_config import gemm_tiles
from repro_torch.kernels import ops


@dataclasses.dataclass
class ExecutionContext:
    capture: Optional[List[Tuple[int, int, int]]] = None  # GEMM shape trace


_TLS = threading.local()


def _ctx() -> ExecutionContext:
    ctx = getattr(_TLS, "ctx", None)
    if ctx is None:
        ctx = ExecutionContext()
        _TLS.ctx = ctx
    return ctx


@contextlib.contextmanager
def execution_context(**overrides):
    """Scoped override of the ambient :class:`ExecutionContext`."""
    old = _ctx()
    _TLS.ctx = dataclasses.replace(old, **overrides)
    try:
        yield _TLS.ctx
    finally:
        _TLS.ctx = old


@contextlib.contextmanager
def capture_gemm_shapes():
    """Collect every (m, k, n) issued under this scope."""
    shapes: List[Tuple[int, int, int]] = []
    with execution_context(capture=shapes):
        yield shapes


def matmul(x: torch.Tensor, w: torch.Tensor, *,
           bias: Optional[torch.Tensor] = None,
           activation: Optional[str] = None,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``x @ w`` with f32 accumulation and a fused epilogue.

    x: (..., K); w: (K, N), read through its strides (a transposed weight
    such as ``embedding.t()`` is not copied).  Leading dims of ``x`` are
    flattened into the GEMM's M.  ``bias`` (N,) is added in f32 before the
    ``activation`` (relu | gelu | silu | tanh); ``out_dtype`` defaults to the
    operands' promoted type.
    """
    ctx = _ctx()
    k = x.shape[-1]
    if w.shape[0] != k:
        raise ValueError(f"matmul mismatch: {tuple(x.shape)} @ {tuple(w.shape)}")
    n = w.shape[1]
    lead = tuple(x.shape[:-1])
    m = math.prod(lead)
    x2 = x.reshape(m, k)
    if ctx.capture is not None:
        ctx.capture.append((m, k, n))
    config = gemm_tiles(x.dtype, m, k, n) if x.is_cuda else None
    out = ops.gemm(x2, w, config=config, bias=bias, activation=activation,
                   out_dtype=out_dtype)
    return out.reshape(*lead, n)


def einsum(subscripts: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with f32 accumulation and an f32 result.

    The counterpart of the reference's ``preferred_element_type=float32``:
    the operands are upcast, so the contraction sums in f32.  A plain
    product outside any kernel of this package, like the reference's XLA dot.
    """
    return torch.einsum(subscripts, *(o.float() for o in operands))
