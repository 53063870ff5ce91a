"""Token-choice top-k Mixture-of-Experts layer (OLMoE style).

Capacity-based dispatch, as in the reference: each batch row is one routing
group; each token's k chosen experts each give it the next free slot of
that expert's ``capacity(S, ...)`` slots in its group, in (token, choice)
order, and a choice past the capacity is dropped (the token keeps only the
residual for it).  The reference vmaps over the groups; here every group is
routed in one batched computation, with no loop over rows and no host sync.

The dispatch buffer is expert-major, (E, B, C, D): the same B x E x C slots
as the reference's (B, E, C, D), laid out so that each expert's slots of
every group form one (B*C, D) operand of the batched product with the
(E, D, F) weight stack, and neither is copied for it.

Each layer is traced in four spans (``model.moe.route``, ``.dispatch``,
``.experts``, ``.combine``), and counts on the host, from shapes, the
routed choices and the expert buffer rows it computes
(:func:`moe_counts`).
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.core import einsum, matmul
from repro_torch.distributed import ops as dops
from repro_torch.distributed.ctx import constrain
from repro_torch.models.params import ParamSpec
from repro_torch.profiling import annotate

#: process-wide, from shapes: the (token, choice) pairs routed and the
#: rows of the expert buffers they were routed into, padding included
_COUNTS = {"routed": 0, "expert_rows": 0}


def moe_template(d_model: int, d_ff: int, num_experts: int):
    e = num_experts
    return {
        "router": ParamSpec((d_model, e), ("embed", None), scale=0.02),
        "w_gate": ParamSpec((e, d_model, d_ff), ("expert", "embed", "ff")),
        "w_up": ParamSpec((e, d_model, d_ff), ("expert", "embed", "ff")),
        "w_down": ParamSpec((e, d_ff, d_model), ("expert", "ff", "embed")),
    }


def moe_counts() -> dict:
    """The MoE layers' counts so far (process-wide, like
    ``kernels.launch_counts()``): ``routed`` choices (B*S*K a layer call)
    and ``expert_rows`` (E*B*C): their ratio is the buffers' fill."""
    return dict(_COUNTS)


def capacity(seq_len: int, num_experts: int, top_k: int, cf: float) -> int:
    """Slots per expert and group: ``ceil(k * S * cf / E)`` rounded up to a
    multiple of 8, at least 8."""
    c = math.ceil(top_k * seq_len * cf / num_experts)
    return max(8, -(-c // 8) * 8)


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """f32 softmax in the reference's form, ``exp(x - max) / sum``: on the
    CPU its bits are jax.nn.softmax's where ``torch.softmax``'s are not."""
    z = logits.float()
    e = torch.exp(z - z.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _group_rows(b: int, device) -> torch.Tensor:
    return torch.arange(b, device=device)[:, None]


def _route_group(x: torch.Tensor, logits: torch.Tensor, *, top_k: int,
                 num_experts: int, cap: int):
    """Route every group.  x: (B, S, D), logits: (B, S, E).

    Returns the dispatch buffer (E, B, C, D) and the route ``(slot_exp,
    slot_pos, keep, gate)``, each (B, S*K): a slot's expert, its position in
    that expert's buffer (uncapped), whether it fits, and its renormalised
    top-k probability (f32)."""
    b, s, d = x.shape
    with annotate("model.moe.route"):
        probs = _softmax(logits)
        # lax.top_k's order: larger first, the lower expert among equal
        # values (bf16 logits tie often).  torch.topk does not promise it.
        gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate, idx = gate[..., :top_k], idx[..., :top_k]
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

        # position within the expert's buffer: running count over (token,
        # choice)
        flat = F.one_hot(idx, num_experts).to(torch.int32).reshape(
            b, s * top_k, num_experts)
        pos = torch.cumsum(flat, dim=1, dtype=torch.int32) * flat - flat
        slot_pos = pos.sum(-1, dtype=torch.int32)
        slot_exp = idx.reshape(b, s * top_k)
        keep = slot_pos < cap

        # Slot (e, g, p) is row (e * B + g) * C + p of the flat buffer; a
        # dropped choice goes to one extra last row, which is cut off (the
        # reference's scatter with mode="drop").
        rows = (slot_exp * b + _group_rows(b, x.device)) * cap + slot_pos
        rows = torch.where(keep, rows, num_experts * b * cap)
    with annotate("model.moe.dispatch"):
        buf = x.new_zeros((num_experts * b * cap + 1, d))
        buf.index_add_(0, rows.reshape(-1),
                       x.repeat_interleave(top_k, dim=1).reshape(-1, d))
    route = (slot_exp, slot_pos, keep, gate.reshape(b, s * top_k))
    return buf[:-1].view(num_experts, b, cap, d), route


def _dispatch(buf):
    """``constrain(., "moe_dispatch")`` of an expert-major (E, B, C, D)
    buffer, through its (B, E, C, D) view."""
    return constrain(buf.transpose(0, 1), "moe_dispatch").transpose(0, 1)


def _combine_group(expert_out: torch.Tensor, slot_exp, slot_pos, keep, gate,
                   *, s: int, top_k: int, cap: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """Gather each slot's expert output (E, B, C, D) back to its token and
    sum the k choices weighted by their gates -> (B, S, D) in ``dtype``.

    As in the reference: the source slot is clipped into the group's buffer
    (a dropped choice reads some slot, at weight 0), the weight is rounded
    to ``dtype`` before the product with the f32 output, and the sum over k
    runs in f32."""
    e, b, c, d = expert_out.shape
    src = (slot_exp * cap + slot_pos).clamp(0, e * c - 1)
    rows = ((src // cap) * b + _group_rows(b, src.device)) * cap + src % cap
    gathered = expert_out.reshape(e * b * c, d).index_select(
        0, rows.reshape(-1)).view(b, s * top_k, d)
    w = (gate * keep).to(dtype)[..., None]
    out = (gathered * w).view(b, s, top_k, d).sum(2)
    return out.to(dtype)


def moe_layer(params, x: torch.Tensor, *, top_k: int, num_experts: int,
              capacity_factor: float = 1.25, with_aux: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x: (B, S, D) -> (out (B, S, D), aux_loss).  Each batch row is one
    routing group.  ``with_aux=False`` skips the auxiliary loss (None): the
    serving steps discard it, as the reference's compiled steps drop it."""
    b, s, d = x.shape
    cap = capacity(s, num_experts, top_k, capacity_factor)
    _COUNTS["routed"] += b * s * top_k
    _COUNTS["expert_rows"] += num_experts * b * cap
    with annotate("model.moe.route"):
        logits = matmul(x, params["router"])                     # (B, S, E)
    route_fn = functools.partial(_route_group, top_k=top_k,
                                 num_experts=num_experts, cap=cap)
    combine_fn = functools.partial(_combine_group, s=s, top_k=top_k, cap=cap,
                                   dtype=x.dtype)
    sharded = isinstance(logits, DTensor)
    if sharded:
        # every batch row is one routing group: each rank routes its own
        # rows, and the expert products run with the experts on the tensor
        # axis (the reference's moe_dispatch pins, on the (B, E, C, D)
        # view of the expert-major buffer)
        buf, route = dops.batch_local(route_fn, [x, logits], [0, 0],
                                      (1, (0, 0, 0, 0)))
        with annotate("model.moe.dispatch"):
            buf = _dispatch(buf)
    else:
        buf, route = route_fn(x, logits)

    # Expert FFN: products over the expert axis, f32 results.
    with annotate("model.moe.experts"):
        h = F.silu(einsum("ebcd,edf->ebcf", buf, params["w_gate"]))
        h = h * einsum("ebcd,edf->ebcf", buf, params["w_up"])
        out_e = einsum("ebcf,efd->ebcd", h.to(x.dtype), params["w_down"])
    with annotate("model.moe.combine"):
        if sharded:
            out = constrain(dops.batch_local(combine_fn, [_dispatch(out_e),
                                                          *route],
                                             [1, 0, 0, 0, 0], 0), "hidden")
        else:
            out = combine_fn(out_e, *route)
    if not with_aux:
        return out, None

    # Load-balance auxiliary loss (Switch-style): E * sum(f_e * p_e), with
    # f_e from the logits' argmax (the first expert on ties).
    probs = _softmax(logits)
    me = probs.mean((0, 1))
    ce = F.one_hot(torch.argmax(logits, dim=-1), num_experts).float().mean(
        (0, 1))
    aux = num_experts * torch.sum(me * ce)
    return out, aux
