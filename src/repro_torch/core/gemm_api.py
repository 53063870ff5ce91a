"""The single public matmul entry point: every model matmul goes here.

The algorithm (``kernels/csrc/gemm.cu``) is written once; which schedule
it runs with comes from the tuning registry (``core.registry``: a tuned
entry of the ambient hardware profile's table, else its default tier, the
H100 hand table), and which path runs follows the tensors' device: the
CUDA kernel on the card, the plain version on the CPU.  Model code never
mentions tiles.

The hardware profile a lookup is keyed by is the ambient
:class:`ExecutionContext`'s ``hardware`` (``execution_context(hardware=
...)``; the serve engine pins its own for a drain), else the detected one
(``core.hardware.detect_hardware``; read once a process on the launch
path, ``core.hardware.launch_hardware``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Optional

import torch

from repro_torch.core.hardware import detect_hardware, launch_hardware
from repro_torch.core.registry import GLOBAL_REGISTRY
from repro_torch.core.tile_config import OP_GEMM
from repro_torch.kernels import ops


@dataclasses.dataclass
class ExecutionContext:
    #: every GEMM issued, as (m, k, n, B K-major, out dtype)
    #: (``capture_gemm_shapes``)
    capture: Optional[list] = None
    #: hardware profile name the registry is keyed by; None: detected
    hardware: Optional[str] = None


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


def current_hardware(device=None) -> str:
    """The hardware profile name of the ambient execution context: its
    explicit ``hardware``, else ``$REPRO_TORCH_HARDWARE``, else detected
    from ``device`` (None: the current card, or the CPU without one)."""
    return _ctx().hardware or detect_hardware(device)


@contextlib.contextmanager
def capture_gemm_shapes(*, calls: bool = False):
    """Collect every (m, k, n) issued under this scope; with ``calls``,
    every ``(m, k, n, b_kmajor, out_dtype)``: what a measured sweep needs
    to lay its operands out as the model does.  The list is filled when
    the scope closes."""
    records: list = []
    out: list = []
    try:
        with execution_context(capture=records):
            yield out
    finally:
        out.extend(records if calls else [r[:3] for r in records])


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
        ctx.capture.append((m, k, n, w.stride(1) != 1 and w.stride(0) == 1,
                            out_dtype or torch.promote_types(x.dtype,
                                                             w.dtype)))
    config = None
    if x.is_cuda:
        config = GLOBAL_REGISTRY.lookup_op(
            OP_GEMM, ctx.hardware or launch_hardware(x.get_device()),
            x.dtype, (m, k, n)).config
    out = ops.gemm(x2, w, config=config, bias=bias, activation=activation,
                   out_dtype=out_dtype)
    return out.reshape(*lead, n)


def einsum(subscripts: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with f32 accumulation and an f32 result.

    The counterpart of the reference's ``preferred_element_type=float32``.
    Two bf16 operands on the card contract as one batched product with an
    f32 result (``torch.bmm(..., out_dtype=torch.float32)``), read where
    they lie: an expert weight stack is not copied to f32 for it.  Other
    operands are upcast, so the contraction sums in f32.  A plain product
    outside any kernel of this package, like the reference's XLA dot.
    """
    if (len(operands) == 2 and operands[0].is_cuda
            and all(o.dtype == torch.bfloat16 for o in operands)):
        return contract_f32(subscripts, *operands,
                            bmm=functools.partial(torch.bmm,
                                                  out_dtype=torch.float32))
    return torch.einsum(subscripts, *(o.float() for o in operands))


def contract_f32(subscripts: str, a: torch.Tensor, b: torch.Tensor, *,
                 bmm) -> torch.Tensor:
    """A two-operand einsum as one ``bmm(a3, b3)`` over (batch, free, sum)
    views.  Every index must appear in the output or in both operands, each
    once per operand.  ``a`` and ``b`` are only permuted and reshaped: an
    operand whose batch / free / summed indices already lie in that order
    (a stacked (E, D, F) weight under ``"ebcd,edf->ebcf"``) is not copied."""
    lhs, out = subscripts.replace(" ", "").split("->")
    sa, sb = lhs.split(",")
    batch = [c for c in sa if c in sb and c in out]
    summed = [c for c in sa if c in sb and c not in out]
    free_a = [c for c in sa if c not in sb]
    free_b = [c for c in sb if c not in sa]
    order = batch + free_a + free_b
    if (len(set(sa)) != len(sa) or len(set(sb)) != len(sb)
            or sorted(order) != sorted(out)):
        raise ValueError(f"contract_f32 does not take {subscripts!r}")
    size = dict(zip(sa, a.shape))
    size.update(zip(sb, b.shape))
    n = lambda idx: math.prod(size[c] for c in idx)  # noqa: E731
    a3 = a.permute([sa.index(c) for c in batch + free_a + summed]).reshape(
        n(batch), n(free_a), n(summed))
    b3 = b.permute([sb.index(c) for c in batch + summed + free_b]).reshape(
        n(batch), n(summed), n(free_b))
    res = bmm(a3, b3).view([size[c] for c in order])
    return res.permute([order.index(c) for c in out])
