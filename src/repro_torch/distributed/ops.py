"""K1, the einsums and K2 on sharded operands.

Each function takes DTensor operands (a plain operand counts as
replicated), decides per mesh dim where the product's work splits, moves
the operands there (a local block, or a collective where the layouts
disagree), runs the plain single-device function on the local shards, and
wraps the local result as a DTensor of the product's placement.  Partial
sums (a contraction over a split index) are reduced to replicated.  The
local call is the one the single-device path makes, so on the card every
product still runs on K1 (and every eligible prefill attention on K2), on
the local shape, and under autograd the local product is still the
``repro_torch::gemm`` op.

``to_local`` / ``from_local`` are differentiable; where a rank's local
gradient is a partial sum (an operand replicated over a mesh dim whose
other operand is split there), the operand's gradient placement says so,
and DTensor's backward reduces it (an FSDP weight gathered over ``data``
gets its gradient reduce-scattered).
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def same_layout(mesh, a, b) -> bool:
    """Whether placements ``a`` and ``b`` lay a tensor out alike: equal on
    every mesh dim of more than one rank (a dim of one splits nothing)."""
    return all(pa == pb for i, (pa, pb) in enumerate(zip(a, b))
               if mesh.size(i) > 1)


def mesh_of(*tensors):
    """The device mesh of the first DTensor among ``tensors``."""
    return next(t.device_mesh for t in tensors if isinstance(t, DTensor))


def as_dtensor(t: torch.Tensor, mesh) -> DTensor:
    """A DTensor on ``mesh``: a plain tensor (the same on every rank) as
    replicated."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _shard_dim(p, ndim: int) -> Optional[int]:
    return p.dim % ndim if isinstance(p, Shard) else None


def _moved(t: DTensor, placements: List) -> DTensor:
    """``t`` redistributed to ``placements`` (as it is where they agree on
    every mesh dim of more than one rank)."""
    if same_layout(t.device_mesh, t.placements, placements):
        return t
    return t.redistribute(t.device_mesh, placements)


def _wrap(local: torch.Tensor, mesh, placements: List, shape) -> DTensor:
    """``local`` as a DTensor of global ``shape``; partial sums reduced."""
    local, stride = _laid_out(local, shape)
    out = DTensor.from_local(local, mesh, placements, run_check=False,
                             shape=torch.Size(shape), stride=stride)
    if any(p.is_partial() for p in placements):
        out = out.redistribute(mesh, [Replicate() if p.is_partial() else p
                                      for p in placements])
    return out


def _laid_out(local: torch.Tensor, shape):
    """(``local``, the global strides of its layout): a local block laid
    out as a permutation of its dims (an einsum's permuted result) keeps
    that layout, the global tensor described in the same order; any other
    layout is made contiguous."""
    if local.is_contiguous():
        return local, _contiguous_strides(shape)
    perm = sorted(range(local.dim()), key=lambda d: -local.stride(d))
    if not local.permute(perm).is_contiguous():
        return local.contiguous(), _contiguous_strides(shape)
    inner = _contiguous_strides([shape[d] for d in perm])
    stride = [0] * local.dim()
    for d, st in zip(perm, inner):
        stride[d] = st
    return local, tuple(stride)


def _contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for s in reversed(tuple(shape)):
        strides.append(acc)
        acc *= s
    return tuple(reversed(strides))


def _reduced(placements) -> List:
    return [Replicate() if p.is_partial() else p for p in placements]


def unflatten(t, dim: int, sizes) -> torch.Tensor:
    """``t.unflatten(dim, sizes)``.  DTensor keeps a split of ``dim`` only
    on the leading factor ``sizes[0]``, and only when the mesh dims that
    split ``dim`` divide it evenly: a projection's heads (8 KV heads on a
    16-way ``model`` axis) are gathered over those mesh dims first, as the
    reference's compiler reshards them."""
    if isinstance(t, DTensor):
        d = dim % t.dim()
        mesh = t.device_mesh
        on_d = [i for i, p in enumerate(t.placements)
                if isinstance(p, Shard) and p.dim % t.dim() == d
                and mesh.size(i) > 1]
        if sizes[0] % math.prod(mesh.size(i) for i in on_d):
            t = _moved(t, [Replicate() if i in on_d else p
                           for i, p in enumerate(t.placements)])
    return t.unflatten(dim, sizes)


def matmul(x, w, *, bias, activation, out_dtype,
           local_matmul: Callable) -> DTensor:
    """``x @ w`` (+ ``bias``, ``activation``) with ``x`` (..., K) and ``w``
    (K, N), either or both DTensors.  Per mesh dim:

    * ``x`` split on a leading (batch) dim: the output is too; a weight
      split there (FSDP) is gathered first;
    * ``w`` split on N (column): the output is split on its last dim;
    * ``w`` split on K (row): ``x`` is split on K to match (a local block
      of a replicated ``x``), and the partial products are summed across
      the dim (the bias and the activation follow the sum), in f32, or in
      bf16 under ``execution_context(bf16_partials=True)`` where both
      operands are bf16 and there is no bias or activation.
    """
    mesh = mesh_of(x, w)
    x, w = as_dtensor(x, mesh), as_dtensor(w, mesh)
    xd = x.dim()
    xp, wp = _reduced(x.placements), _reduced(w.placements)
    outp, xg, wg = [], [], []
    for i in range(mesh.ndim):
        xs, ws = _shard_dim(xp[i], xd), _shard_dim(wp[i], 2)
        if mesh.size(i) == 1:                      # nothing is split
            outp.append(Replicate())
            xg.append(xp[i])
            wg.append(wp[i])
        elif xs is not None and xs != xd - 1:      # batch-split activations
            wp[i] = Replicate()
            outp.append(Shard(xs))
            xg.append(xp[i])
            wg.append(Partial())
        elif xs == xd - 1 or ws == 0:              # split over K
            xp[i], wp[i] = Shard(xd - 1), Shard(0)
            outp.append(Partial())
            xg.append(xp[i])
            wg.append(wp[i])
        elif ws == 1:                              # split over N
            outp.append(Shard(xd - 1))
            xg.append(Partial())
            wg.append(wp[i])
        else:
            outp.append(Replicate())
            xg.append(xp[i])
            wg.append(wp[i])
    x, w = _moved(x, xp), _moved(w, wp)
    partial = any(p.is_partial() for p in outp)
    shape = tuple(x.shape[:-1]) + (w.shape[1],)
    xl = x.to_local(grad_placements=xg)
    wl = w.to_local(grad_placements=wg)
    if partial:
        # bf16_partials: a bf16 product with nothing after the sum returns
        # its partial sums in bf16, and the all-reduce moves half the bytes
        from repro_torch.core.gemm_api import _ctx
        pdt = (torch.bfloat16 if _ctx().bf16_partials and bias is None
               and activation is None and xl.dtype == torch.bfloat16
               and wl.dtype == torch.bfloat16 else torch.float32)
        z = _wrap(local_matmul(xl, wl, bias=None, activation=None,
                               out_dtype=pdt), mesh, outp, shape)
        _record(x, w, xl, wl)
        if bias is not None:
            z = z + as_dtensor(bias, mesh).float()
        if activation is not None:
            from repro_torch.kernels.ref import apply_epilogue
            z = apply_epilogue(z, activation=activation)
        dt = out_dtype or torch.promote_types(x.dtype, w.dtype)
        return z.to(dt)
    bl = None
    if bias is not None:
        bp = [Shard(0) if isinstance(p, Shard) and p.dim == xd - 1
              else Replicate() for p in outp]
        bl = _moved(as_dtensor(bias, mesh), bp).to_local()
    out = local_matmul(xl, wl, bias=bl, activation=activation,
                       out_dtype=out_dtype)
    _record(x, w, xl, wl)
    return _wrap(out, mesh, outp, shape)


def _record(x, w, xl, wl) -> None:
    """Note the product's global and local (m, k, n) where the ambient
    execution context collects them."""
    from repro_torch.core.gemm_api import _ctx
    sharded = _ctx().sharded
    if sharded is not None:
        sharded.append(((math.prod(x.shape[:-1]),) + tuple(w.shape),
                        (math.prod(xl.shape[:-1]),) + tuple(wl.shape)))


def embedding(table, tokens, lookup: Callable) -> DTensor:
    """``lookup(table, tokens)`` rows on a mesh: over the mesh dims that
    split the tokens' batch each rank looks its own rows up in the table
    (gathered there, as an FSDP weight is); over the dims that split the
    vocab each rank looks up the ids it holds, zeros elsewhere, and the
    ranks' rows are summed."""
    mesh = mesh_of(table, tokens)
    table, tokens = as_dtensor(table, mesh), as_dtensor(tokens, mesh)
    tp, kp, outp, tg = [], [], [], []
    lo, vl = 0, table.shape[0]
    for i in range(mesh.ndim):
        ks = _shard_dim(tokens.placements[i], tokens.dim())
        if mesh.size(i) == 1:
            tp.append(table.placements[i])
            kp.append(tokens.placements[i])
            outp.append(Replicate())
            tg.append(table.placements[i])
        elif ks is not None:
            tp.append(Replicate())
            kp.append(Shard(ks))
            outp.append(Shard(ks))
            tg.append(Partial())
        elif _shard_dim(table.placements[i], 2) == 0:
            tp.append(Shard(0))
            kp.append(Replicate())
            outp.append(Partial())
            tg.append(Shard(0))
            vl //= mesh.size(i)
            lo += mesh.get_local_rank(i) * vl
        else:
            tp.append(Replicate())
            kp.append(Replicate())
            outp.append(Replicate())
            tg.append(Replicate())
    table, tokens = _moved(table, tp), _moved(tokens, kp)
    ids = tokens.to_local()
    tl = table.to_local(grad_placements=tg)
    if vl == table.shape[0]:
        rows = lookup(tl, ids)
    else:
        ids = ids - lo
        valid = (ids >= 0) & (ids < vl)
        rows = torch.where(valid[..., None], lookup(tl, ids.clamp(0, vl - 1)),
                           0)
    return _wrap(rows, mesh, outp, tuple(tokens.shape) + (table.shape[1],))


def einsum(subscripts: str, a, b, local_einsum: Callable) -> DTensor:
    """A two-operand einsum over DTensors.  Per mesh dim the split index
    is the one ``a`` splits (else ``b``'s); the other operand is split on
    it too where it carries it, else replicated; the output is split on
    it, or summed across the dim when the index is contracted."""
    mesh = mesh_of(a, b)
    a, b = as_dtensor(a, mesh), as_dtensor(b, mesh)
    lhs, out = subscripts.replace(" ", "").split("->")
    sa, sb = lhs.split(",")
    ap, bp = _reduced(a.placements), _reduced(b.placements)
    outp, ag, bg = [], [], []
    for i in range(mesh.ndim):
        da, db = _shard_dim(ap[i], a.dim()), _shard_dim(bp[i], b.dim())
        letter = sa[da] if da is not None else (
            sb[db] if db is not None else None)
        if letter is None or mesh.size(i) == 1:
            outp.append(Replicate())
            ag.append(ap[i])
            bg.append(bp[i])
            continue
        ap[i] = Shard(sa.index(letter)) if letter in sa else Replicate()
        bp[i] = Shard(sb.index(letter)) if letter in sb else Replicate()
        outp.append(Shard(out.index(letter)) if letter in out else Partial())
        ag.append(ap[i] if letter in sa else Partial())
        bg.append(bp[i] if letter in sb else Partial())
    a, b = _moved(a, ap), _moved(b, bp)
    size = dict(zip(sa, a.shape))
    size.update(zip(sb, b.shape))
    local = local_einsum(subscripts, a.to_local(grad_placements=ag),
                         b.to_local(grad_placements=bg))
    return _wrap(local, mesh, outp, [size[c] for c in out])


def flash_attention(q, k, v, kv_start, local_flash: Callable) -> DTensor:
    """K2 over (B, S, H, d) / (B, S_kv, KV, d) DTensors: batch split where
    ``q``'s batch is, heads split where ``q``'s heads are (each rank's
    contiguous block of q heads with the KV heads they read; KV heads that
    do not divide the axis, as a sequence-split cache holds them, are
    gathered and the block's own picked), everything else gathered."""
    mesh = mesh_of(q, k, v)
    q, k, v = (as_dtensor(t, mesh) for t in (q, k, v))
    h, kvh = q.shape[2], k.shape[2]
    qp, kp = [], []
    kv_gathered = None          # the mesh dim whose KV heads are gathered
    for i in range(mesh.ndim):
        d = _shard_dim(q.placements[i], 4)
        if mesh.size(i) == 1:
            qp.append(q.placements[i])
            kp.append(k.placements[i])
        elif d == 0:
            qp.append(Shard(0))
            kp.append(Shard(0))
        elif d == 2 and h % mesh.size(i) == 0:
            qp.append(Shard(2))
            if kvh % mesh.size(i) == 0:
                kp.append(Shard(2))
            else:
                kp.append(Replicate())
                kv_gathered = i
        else:
            qp.append(Replicate())
            kp.append(Replicate())
    q, k, v = _moved(q, qp), _moved(k, kp), _moved(v, kp)
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    if kv_gathered is not None:
        hl = ql.shape[2]
        h0 = mesh.get_local_rank(kv_gathered) * hl
        idx = torch.tensor([(h0 + j) // (h // kvh) for j in range(hl)],
                           device=kl.device)
        kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
    ksl = None
    if kv_start is not None:
        ks = as_dtensor(kv_start, mesh)
        ksp = [ks.placements[i] if mesh.size(i) == 1 else
               Shard(0) if p == Shard(0) else Replicate()
               for i, p in enumerate(qp)]
        ksl = _moved(ks, ksp).to_local()
    outp = [p if mesh.size(i) > 1 else Replicate() for i, p in enumerate(qp)]
    return _wrap(local_flash(ql, kl, vl, ksl), mesh, outp, tuple(q.shape))


# ---------------------------------------------------------------------------
# Rows of a batch-split tensor (the serve engine's slot writes)
# ---------------------------------------------------------------------------

def batch_local(fn: Callable, args: Sequence, batch_dims: Sequence,
                out_batch_dims):
    """Run ``fn`` on each rank's batch block: the counterpart of the
    reference's per-row code under a batch-sharded spec, for the parts of
    a model DTensor has no split for (a concatenated projection sliced
    apart, the SSD's chunk loop, the MoE routing).

    ``args[j]`` (a tensor, or anything else passed as is) is split on dim
    ``batch_dims[j]`` over the mesh dims that split the batch of the first
    batch-dimmed DTensor argument, and replicated over every other mesh
    dim (a tensor with ``batch_dims[j]`` None is replicated whole).  A
    replicated argument's gradient is a partial sum over the batch-split
    dims, and is marked so.  ``out_batch_dims`` mirrors ``fn``'s output
    (a tensor, or a tuple / list / dict of them; None for a non-tensor)."""
    mesh = mesh_of(*[a for a in args if isinstance(a, torch.Tensor)])
    lead = next(a for a, d in zip(args, batch_dims)
                if isinstance(a, DTensor) and d is not None)
    bd0 = batch_dims[list(args).index(lead)]
    split = {i for i, p in enumerate(lead.placements)
             if isinstance(p, Shard) and p.dim % lead.dim() == bd0
             and mesh.size(i) > 1}
    factor = 1
    for i in split:
        factor *= mesh.size(i)
    local_args = []
    for a, bd in zip(args, batch_dims):
        if not isinstance(a, torch.Tensor):
            local_args.append(a)
            continue
        a = as_dtensor(a, mesh)
        # a mesh dim of size 1 splits nothing: left as it is
        target = [a.placements[i] if mesh.size(i) == 1 else
                  Shard(bd) if bd is not None and i in split else Replicate()
                  for i in range(mesh.ndim)]
        grads = [Partial() if bd is None and i in split else target[i]
                 for i in range(mesh.ndim)]
        local_args.append(_moved(a, target).to_local(grad_placements=grads))
    out = fn(*local_args)

    def wrap(o, bd):
        if isinstance(o, dict):
            return {k: wrap(v, bd[k]) for k, v in o.items()}
        if isinstance(o, (tuple, list)):
            return type(o)(wrap(v, d) for v, d in zip(o, bd))
        if not isinstance(o, torch.Tensor) or bd is None:
            return o
        shape = list(o.shape)
        shape[bd] *= factor
        placements = [Shard(bd) if i in split else Replicate()
                      for i in range(mesh.ndim)]
        return DTensor.from_local(o, mesh, placements, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=_contiguous_strides(shape))
    return wrap(out, out_batch_dims)


# ---------------------------------------------------------------------------
# The serve engine's paged pool and slot rows on a mesh
# ---------------------------------------------------------------------------

def paged_gather(pool: DTensor, idx: torch.Tensor, placements,
                 plain_gather: Callable) -> DTensor:
    """The dense ``(..., B, W, KV, hd)`` view of a pool (no batch dim;
    KV heads split like ``placements``' or replicated) at the host index
    ``idx`` (B, W), as a DTensor of ``placements``: each rank gathers its
    own batch rows from its pool block."""
    mesh = pool.device_mesh
    nd = pool.dim() + 1
    bd = nd - 4
    rows, _ = local_rows_of(mesh, placements, bd, idx.shape[0], nd)
    local = plain_gather(pool.to_local(), idx[rows])
    have = [Shard(bd) if isinstance(p, Shard) and p.dim % nd == bd
            else Shard(nd - 2) if isinstance(pp, Shard) else Replicate()
            for p, pp in zip(placements, pool.placements)]
    shape = tuple(pool.shape[:-3]) + tuple(idx.shape) + tuple(pool.shape[-2:])
    out = DTensor.from_local(local, mesh, have, run_check=False,
                             shape=torch.Size(shape),
                             stride=_contiguous_strides(shape))
    return _moved(out, list(placements))


def paged_scatter(pool: DTensor, idx: torch.Tensor, cols,
                  plain_scatter: Callable) -> DTensor:
    """Write ``cols`` (..., B, C, KV, hd) to the pool at the host index
    ``idx`` (B, C): every rank writes every row into its pool block (the
    pool is replicated over the batch axes)."""
    nd = cols.dim()
    want = [Shard(nd - 2) if isinstance(p, Shard) else Replicate()
            for p in pool.placements]
    plain_scatter(pool.to_local(),
                  idx, _moved(as_dtensor(cols, pool.device_mesh),
                              want).to_local())
    return pool


def local_rows_of(mesh, placements, dim: int, n: int, ndim: int):
    """:func:`local_rows` for a tensor of ``ndim`` dims whose dim ``dim``
    has ``n`` rows, split by ``placements``: (local positions, global)."""
    lo = 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim % ndim == dim:
            n //= mesh.size(i)
            lo += mesh.get_local_rank(i) * n
    return list(range(lo, lo + n)), lo


def local_rows(t: DTensor, dim: int, rows: Sequence[int]):
    """``(positions in the local tensor, positions in rows)`` of the global
    ``rows`` of ``t``'s dim ``dim`` that this rank holds (an even split)."""
    held, lo = local_rows_of(t.device_mesh, t.placements, dim, t.shape[dim],
                             t.dim())
    mine = [(r - lo, j) for j, r in enumerate(rows) if r in held]
    return [m for m, _ in mine], [j for _, j in mine]


def write_slice(dst: DTensor, dim: int, start: int, src) -> None:
    """``dst[start:start + n]`` along ``dim`` = ``src`` (n along ``dim``),
    in place, each rank writing the part of the slice its block holds (a
    cache whose sequence is split over an axis, where a slice of the
    DTensor would be a gathered copy)."""
    nd = dst.dim()
    want = [Replicate() if isinstance(p, Shard) and p.dim % nd == dim else p
            for p in dst.placements]
    srcl = _moved(as_dtensor(src, dst.device_mesh), want).to_local()
    held, lo = local_rows_of(dst.device_mesh, dst.placements, dim,
                             dst.shape[dim], nd)
    a, b = max(start, lo), min(start + srcl.shape[dim], lo + len(held))
    if a < b:
        dst.to_local().narrow(dim, a - lo, b - a).copy_(
            srcl.narrow(dim, a - start, b - a))


def copy_rows(dst: DTensor, src, dim: int, rows: Sequence[int]) -> None:
    """``dst[rows] = src[rows]`` along ``dim``, in place, each rank on the
    rows it holds."""
    src = _moved(as_dtensor(src, dst.device_mesh), list(dst.placements))
    mine, _ = local_rows(dst, dim, rows)
    if mine:
        at = torch.tensor(mine, device=dst.device)
        dst.to_local().index_copy_(dim, at, src.to_local().index_select(
            dim, at))


def local_row(t: DTensor, dim: int, row: int) -> Optional[torch.Tensor]:
    """A view of this rank's part of global row ``row`` (None: another
    rank holds it)."""
    mine, _ = local_rows(t, dim, [row])
    return t.to_local().select(dim, mine[0]) if mine else None
