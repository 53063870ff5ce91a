"""The single public flash-attention entry point: models route here.

Mirror of :mod:`repro_torch.core.gemm_api` for the attention kernel: the
schedule comes from the H100 tile table for the operands' dtype; a caller
may override its (bq, bk) blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.tile_config import flash_tiles
from repro_torch.kernels import flash_attention as fa_kernel


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    kv_start: Optional[torch.Tensor] = None,
                    bq: Optional[int] = None,
                    bk: Optional[int] = None) -> torch.Tensor:
    """Flash attention over GQA-layout operands.

    q: (B, S, H, d); k, v: (B, S_kv, KV, d) with KV dividing H.  ``causal``
    aligns queries to the end of the KV sequence when S != S_kv.
    ``kv_start`` (B,) int32 masks each row's columns before it (left-padded
    ragged batches).  Returns (B, S, H, d) in ``q.dtype``.
    """
    cfg = flash_tiles(q.dtype, q.shape[1], k.shape[1], q.shape[3])
    if bq is not None or bk is not None:
        cfg = dataclasses.replace(cfg, bq=bq or cfg.bq, bk=bk or cfg.bk)
    return fa_kernel.flash_attention(q, k, v, config=cfg, causal=causal,
                                     kv_start=kv_start)
