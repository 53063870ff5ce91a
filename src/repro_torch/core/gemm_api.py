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
from torch.distributed.tensor import DTensor
from torch.profiler import record_function
from torch.utils.checkpoint import (CheckpointPolicy,
                                     create_selective_checkpoint_contexts)

from repro_torch.core.hardware import detect_hardware, launch_hardware
from repro_torch.core.registry import GLOBAL_REGISTRY
from repro_torch.core.tile_config import OP_GEMM
from repro_torch.kernels import ops
from repro_torch.kernels.ref import apply_epilogue


@dataclasses.dataclass
class ExecutionContext:
    #: every GEMM issued, as (m, k, n, B K-major, out dtype)
    #: (``capture_gemm_shapes``)
    capture: Optional[list] = None
    #: hardware profile name the registry is keyed by; None: detected
    hardware: Optional[str] = None
    #: every product on sharded operands, as ((m, k, n) global, (m, k, n)
    #: of this rank's local product) (the serve engine's tile provenance)
    sharded: Optional[list] = None
    #: the dry run's op counter (``launch.step_stats.count_step``): each K1
    #: product, two-operand einsum and K2 call is counted as one unit
    counter: Optional[object] = None
    #: 16-bit products whose partial sums cross shards return them in bf16,
    #: so the cross-shard all-reduce runs in bf16 instead of f32 (each
    #: shard still accumulates in f32): a K-split ``matmul`` of bf16
    #: operands with no bias or activation (``distributed.ops.matmul``) and
    #: an ``einsum`` of 16-bit operands
    bf16_partials: bool = False


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
    """Collect every (m, k, n) issued under this scope (a backward run
    inside it adds its products); with ``calls``,
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


def _grad_needed(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether a product of ``tensors`` must carry a gradient: grad mode is
    on and one of them requires one."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _product(a: torch.Tensor, b: torch.Tensor, *, hardware: Optional[str],
             capture: Optional[list], bias: Optional[torch.Tensor] = None,
             activation: Optional[str] = None,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """One 2-D product through ``ops.gemm``: recorded in ``capture``, its
    schedule resolved for ``hardware`` (None: the device's) on the card."""
    m, k = a.shape
    n = b.shape[1]
    if capture is not None:
        capture.append((m, k, n, b.stride(1) != 1 and b.stride(0) == 1,
                        out_dtype or torch.promote_types(a.dtype, b.dtype)))
    config = None
    if a.is_cuda:
        config = GLOBAL_REGISTRY.lookup_op(
            OP_GEMM, hardware or launch_hardware(a.get_device()),
            a.dtype, (m, k, n)).config
    counter = _ctx().counter
    if counter is not None:
        return counter.unit(
            lambda: ops.gemm(a, b, config=config, bias=bias,
                             activation=activation, out_dtype=out_dtype),
            "repro_torch.gemm", torch.promote_types(a.dtype, b.dtype),
            (a, b, bias))
    return ops.gemm(a, b, config=config, bias=bias, activation=activation,
                    out_dtype=out_dtype)


@torch.library.custom_op("repro_torch::gemm", mutates_args=())
def gemm_op(a: torch.Tensor, b: torch.Tensor, bias: Optional[torch.Tensor],
            out_dtype: torch.dtype, hardware: Optional[str],
            grad_dtype: torch.dtype) -> torch.Tensor:
    """K1's 2-D product ``a @ b + bias`` in ``out_dtype`` as an operator
    autograd and selective checkpointing can name (``"dots"`` saves its
    output, :func:`dots_policy`).  ``grad_dtype`` is the dtype its backward
    products run in.  The product goes through ``ops.gemm``, looked up at
    call time, and is recorded in the ambient ``capture``."""
    return _product(a, b, hardware=hardware, capture=_ctx().capture,
                    bias=bias, out_dtype=out_dtype)


@gemm_op.register_fake
def _gemm_op_fake(a, b, bias, out_dtype, hardware, grad_dtype):
    return a.new_empty((a.shape[0], b.shape[1]), dtype=out_dtype)


def _gemm_op_setup(ctx, inputs, output):
    a, b, bias, _out_dtype, hardware, grad_dtype = inputs
    ctx.save_for_backward(a, b)
    # the backward may run on autograd's device thread: the ambient
    # capture list is read here, on the caller's
    ctx.meta = (hardware, _ctx().capture, grad_dtype,
                 None if bias is None else bias.dtype)


def _gemm_op_backward(ctx, dz):
    """dX = dZ @ w.T reads ``w`` K-major, no copy; dW = x.T @ dZ copies
    x.T, since the kernel reads its left operand with unit stride over K.
    Both products return their operands' dtype, cast to the input's or
    the weight's after, as the reference's transposed dots do: an f32
    product (the unembed's f32 cotangent) never returns bf16.
    A bf16 dW whose M (its K) is not a multiple of 8 (vlm's cross K/V over
    4 x 1601 image tokens) pads x.T and dZ with zero rows to one: the bf16
    kernels read rows in 16-byte chunks, so the product stays on them
    instead of WMMA, and the zeros add nothing to it."""
    x2, w = ctx.saved_tensors
    hardware, capture, pdt, bias_dtype = ctx.meta
    prod = functools.partial(_product, hardware=hardware, capture=capture)
    dz_p = dz.to(pdt)
    dx = dw = db = None
    if ctx.needs_input_grad[0]:
        with record_function("matmul.dX"):
            dx = prod(dz_p, w.to(pdt).t(), out_dtype=pdt).to(x2.dtype)
    if ctx.needs_input_grad[1]:
        with record_function("matmul.dW"):
            xt = x2.to(pdt).t()
            pad = -x2.shape[0] % 8 if pdt == torch.bfloat16 else 0
            if pad:
                xt = torch.nn.functional.pad(xt, (0, pad))
                dz_p = torch.nn.functional.pad(dz_p, (0, 0, 0, pad))
            dw = prod(xt.contiguous(), dz_p, out_dtype=pdt).to(w.dtype)
    if ctx.needs_input_grad[2]:
        db = dz.float().sum(0).to(bias_dtype)
    return dx, dw, db, None, None, None


gemm_op.register_autograd(_gemm_op_backward, setup_context=_gemm_op_setup)


def _differentiable(x2, w, bias, activation, out_dtype, hardware):
    """``matmul`` under autograd: every product, forward and backward,
    through ``ops.gemm`` (the GEMM kernel on the card, ``gemm_ref`` on the
    CPU), the forward one as :func:`gemm_op`.

    With an activation the op returns the f32 pre-activation ``z = x @ w +
    bias`` and the plain epilogue is applied to it under autograd, the
    reference's order (f32 accumulate, bias, activation, cast): ``"dots"``
    keeps ``z`` and recomputes the activation, as the reference's policy
    keeps the dot's output and not what follows it.  The backward products
    run in the operands' dtype promoted with the output's: bf16 for a bf16
    projection, f32 for the unembed's f32 cotangent (both operands upcast
    for it).  Each product runs inside a profiler range,
    ``matmul.forward``, ``matmul.dX`` or ``matmul.dW``, so a trace splits
    the GEMM's time by role (the dW range also holds the x.T copy).
    """
    out_dtype = out_dtype or torch.promote_types(x2.dtype, w.dtype)
    pdt = torch.promote_types(torch.promote_types(x2.dtype, w.dtype),
                              out_dtype)
    with record_function("matmul.forward"):
        if activation is None:
            return gemm_op(x2, w, bias, out_dtype, hardware, pdt)
        z = gemm_op(x2, w, bias, torch.float32, hardware, pdt)
        return apply_epilogue(z, activation=activation).to(out_dtype)


def dots_policy(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``remat_policy="dots"``, the
    reference's ``dots_with_no_batch_dims_saveable``: K1's forward output
    (every ``core.matmul`` is a dot with no batch dims) is saved, every
    other op is recomputed in the backward (the batched attention, SSD and
    expert einsums among them)."""
    if op is torch.ops.repro_torch.gemm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def dots_checkpoint_contexts():
    """``context_fn`` of ``torch.utils.checkpoint.checkpoint`` for
    :func:`dots_policy`."""
    return create_selective_checkpoint_contexts(dots_policy)


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

    Differentiable: when grad mode is on and ``x``, ``w`` or ``bias``
    requires grad, the product runs as the ``repro_torch::gemm`` operator
    (:func:`gemm_op`), whose backward products go through the same kernel
    (and are recorded by ``capture_gemm_shapes`` when the backward runs
    inside its scope).

    Sharded: with a DTensor weight (a model placed on a mesh) the product
    runs as this function on each rank's local shards
    (``distributed.ops.matmul``), and returns a DTensor.
    """
    if isinstance(w, DTensor):
        from repro_torch.distributed import ops as dops
        return dops.matmul(x, w, bias=bias, activation=activation,
                           out_dtype=out_dtype, local_matmul=matmul)
    ctx = _ctx()
    k = x.shape[-1]
    if w.shape[0] != k:
        raise ValueError(f"matmul mismatch: {tuple(x.shape)} @ {tuple(w.shape)}")
    n = w.shape[1]
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(math.prod(lead), k)
    if _grad_needed(x, w, bias):
        out = _differentiable(x2, w, bias, activation, out_dtype,
                              ctx.hardware)
    else:
        out = _product(x2, w, hardware=ctx.hardware, capture=ctx.capture,
                       bias=bias, activation=activation, out_dtype=out_dtype)
    return out.reshape(*lead, n)


def einsum(subscripts: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with f32 accumulation and an f32 result.

    The counterpart of the reference's ``preferred_element_type=float32``.
    Two bf16 operands on the card contract as one batched product with an
    f32 result (``torch.bmm(..., out_dtype=torch.float32)``), read where
    they lie: an expert weight stack is not copied to f32 for it.  Other
    operands are upcast, so the contraction sums in f32.  A plain product
    outside any kernel of this package, like the reference's XLA dot.
    Two operands of which one is a DTensor contract on each rank's local
    shards (``distributed.ops.einsum``).  Under ``bf16_partials`` 16-bit
    operands give a bf16 result (the reference's
    ``preferred_element_type=bfloat16``).
    """
    if len(operands) == 2 and any(isinstance(o, DTensor) for o in operands):
        from repro_torch.distributed import ops as dops
        return dops.einsum(subscripts, *operands, local_einsum=einsum)
    ctx = _ctx()
    bf16 = ctx.bf16_partials and all(o.element_size() <= 2 for o in operands)

    def run():
        out = _einsum(subscripts, *operands)
        return out.to(torch.bfloat16) if bf16 else out

    if ctx.counter is not None:
        return ctx.counter.unit(run, "repro_torch.einsum", functools.reduce(
            torch.promote_types, [o.dtype for o in operands]), operands)
    return run()


def _einsum(subscripts: str, *operands: torch.Tensor) -> torch.Tensor:
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
