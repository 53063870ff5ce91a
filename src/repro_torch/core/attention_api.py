"""The single public flash-attention entry point: models route here.

Mirror of :mod:`repro_torch.core.gemm_api` for the attention kernel: for
CUDA operands the schedule comes from the tuning registry's
``flash_attention`` entry for ``(S, S_kv, d)`` on the ambient hardware
profile (exact, nearest, generic, then the profile's default tier, the
H100 hand table); a caller may override its (bq, bk) blocks.  CPU
operands run the plain version, which has no schedule.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.gemm_api import _ctx
from repro_torch.core.hardware import launch_hardware
from repro_torch.core.registry import GLOBAL_REGISTRY, LookupResult
from repro_torch.core.tile_config import OP_FLASH_ATTENTION
from repro_torch.kernels import flash_attention as fa_kernel


def flash_tile_lookup(hardware: str, dtype, sq: int, skv: int,
                      d: int) -> LookupResult:
    """Resolve the flash-attention schedule of one ``(sq, skv, d)``
    problem: the lookup the model path makes, named so that telemetry
    (``Engine.stats()``) shares it."""
    return GLOBAL_REGISTRY.lookup_op(OP_FLASH_ATTENTION, hardware, dtype,
                                     (sq, skv, d))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    kv_start: Optional[torch.Tensor] = None,
                    bq: Optional[int] = None,
                    bk: Optional[int] = None) -> torch.Tensor:
    """Flash attention over GQA-layout operands.

    q: (B, S, H, d); k, v: (B, S_kv, KV, d) with KV dividing H.  ``causal``
    aligns queries to the end of the KV sequence when S != S_kv.
    ``kv_start`` (B,) int32 masks each row's columns before it (left-padded
    ragged batches).  Returns (B, S, H, d) in ``q.dtype``.  Raises under
    grad mode when q, k or v requires grad: the kernel has no backward (nor
    has the reference's), and a forward autograd cannot see would leave
    the projections before it without a gradient.

    On DTensors (a model placed on a mesh) the kernel runs on each rank's
    local batch rows and heads (``distributed.ops.flash_attention``).
    """
    if isinstance(q, DTensor):
        from repro_torch.distributed import ops as dops
        return dops.flash_attention(
            q, k, v, kv_start,
            lambda ql, kl, vl, ks: flash_attention(
                ql, kl, vl, causal=causal, kv_start=ks, bq=bq, bk=bk))
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash kernel has no gradient, as in the reference; train "
            "with attention_impl='chunked'")
    cfg = None
    if q.is_cuda:
        cfg = flash_tile_lookup(
            _ctx().hardware or launch_hardware(q.get_device()), q.dtype,
            q.shape[1], k.shape[1], q.shape[3]).config
        if bq is not None or bk is not None:
            cfg = dataclasses.replace(cfg, bq=bq or cfg.bq, bk=bk or cfg.bk)
    counter = _ctx().counter
    if counter is not None:
        return counter.unit(
            lambda: fa_kernel.flash_attention(q, k, v, config=cfg,
                                              causal=causal,
                                              kv_start=kv_start),
            "repro_torch.flash_attention", q.dtype, (q, k, v, kv_start),
            flash=(q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                   q.shape[3], causal))
    return fa_kernel.flash_attention(q, k, v, config=cfg, causal=causal,
                                     kv_start=kv_start)
