"""Paged KV-cache gather/scatter: plain torch ops on the flat token axis.

The pool stores each "self"-attention KV leaf with its (page, slot) dims
collapsed into one flat token axis of ``num_pages * page_size`` entries.  A
decode chunk gathers a dense right-aligned ``(B, W)`` view of every live
row's KV (``paged_gather``) and scatters the chunk's new columns back
(``paged_scatter``).  Index arrays come from the host block tables
(``repro_torch.serve.kv_pages``).  ``paged_copy`` copies one page into
another: the prefix cache's copy-on-write.

Out-of-range indices follow the JAX reference, where torch would raise:
both wrap indices in [-n, 0); beyond that a gather (``jnp.take``'s default
mode) reads NaN and a scatter (``.at[].set``) drops the entry.  The serve
engine never issues either (NULL / TRASH pages absorb what has no home),
but both are masked here.  Host (CPU) index arrays are masked on the host
for free; a device index array costs one host sync to drop out-of-range
scatter entries.
"""
from __future__ import annotations

import torch


def flatten_pool(leaf: torch.Tensor) -> torch.Tensor:
    """(..., P, S, kvh, hd) -> (..., P*S, kvh, hd)."""
    shape = tuple(leaf.shape)
    return leaf.reshape(shape[:-4] + (shape[-4] * shape[-3],) + shape[-2:])


def paged_gather(pool_flat: torch.Tensor, idx) -> torch.Tensor:
    """Dense ``(..., B, W, kvh, hd)`` view of the flat pool at ``idx`` (B, W)."""
    n = pool_flat.shape[-3]
    idx = torch.as_tensor(idx).to(device=pool_flat.device, dtype=torch.long)
    flat_idx = idx.reshape(-1)
    flat_idx = torch.where(flat_idx < 0, flat_idx + n, flat_idx)
    valid = (flat_idx >= 0) & (flat_idx < n)
    flat = pool_flat.index_select(pool_flat.ndim - 3, flat_idx.clamp(0, n - 1))
    flat = torch.where(valid[:, None, None], flat, float("nan"))
    lead = tuple(pool_flat.shape[:-3])
    return flat.reshape(lead + tuple(idx.shape) + tuple(pool_flat.shape[-2:]))


def paged_copy(pool_flat: torch.Tensor, src_page: int, dst_page: int,
               page_size: int) -> torch.Tensor:
    """Copy one page's ``page_size`` token rows to another page, in place
    (the prefix cache's copy-on-write of the page that straddles a full
    hit's divergence point).  A plain copy on the token axis: the copied KV
    has the bits prefill scattered into the source page.  Page ids past the
    pool clamp, as ``jax.lax.dynamic_slice`` clamps its start."""
    axis = pool_flat.ndim - 3
    n = pool_flat.shape[axis]
    src0 = min(max(int(src_page) * page_size, 0), n - page_size)
    dst0 = min(max(int(dst_page) * page_size, 0), n - page_size)
    src = pool_flat.narrow(axis, src0, page_size).clone()
    pool_flat.narrow(axis, dst0, page_size).copy_(src)
    return pool_flat


def paged_scatter(pool_flat: torch.Tensor, idx, cols: torch.Tensor) -> torch.Tensor:
    """Write ``cols`` (..., B, C, kvh, hd) to the flat pool at ``idx`` (B, C).

    Updates ``pool_flat`` in place (the pool is the engine's one copy of the
    KV; a functional copy would double its memory) and returns it.
    """
    n = pool_flat.shape[-3]
    axis = pool_flat.ndim - 3
    lead = tuple(pool_flat.shape[:-3])
    flat_cols = cols.reshape(lead + (-1,) + tuple(cols.shape[-2:]))
    flat_idx = torch.as_tensor(idx).reshape(-1).to(torch.long)
    flat_idx = torch.where(flat_idx < 0, flat_idx + n, flat_idx)
    keep = (flat_idx >= 0) & (flat_idx < n)
    # host (CPU) indices, as the engine's, are tested on the host: no sync
    # analysis: allow(TP002, TP003)
    if not bool(keep.all()):
        pos = keep.nonzero().squeeze(1)  # analysis: allow(TP001)
        flat_idx = flat_idx[pos]
        flat_cols = flat_cols.index_select(axis, pos.to(flat_cols.device))
    pool_flat.index_copy_(axis, flat_idx.to(pool_flat.device), flat_cols)
    return pool_flat
