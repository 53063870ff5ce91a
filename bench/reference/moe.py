"""The mixture-of-experts family as the configuration states it: a router
over ``num_experts`` gated SiLU experts, each token's ``experts_per_token``
most likely ones (ties to the lower index) with their probabilities
renormalised, and a capacity per expert in each routing group.

Routing groups are as served.  An admission prefill is one group per
prompt, left-padded to the admission's bucket ``plen`` with pad tokens
(id 0) ahead of it: each choice, in token order, takes the next of its
expert's ``ceil(k * plen * cf / E)`` slots (rounded up to 8), or is
dropped.  Each decoded token is a group of its own (capacity 8 >= k: no
drop).

Pads attend to nothing, so they reach the prompt only through the slots
they take, and which experts they take is a discrete function of
rounding: a near tie among a pad's router logits that the served type
breaks one way and float32 the other would move a whole expert's slots.
So the pads' own path (their residual stream, norm, router and experts)
is taken in the served type's rounding, bfloat16, at the points where a
bf16 model rounds; everything the prompt and served tokens compute is in
float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference import common


def capacity(cfg: dict, group: int) -> int:
    c = math.ceil(cfg["experts_per_token"] * group
                  * cfg["moe_capacity_factor"] / cfg["num_experts"])
    return max(8, -(-c // 8) * 8)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _route(cfg, lw, h, quant, rnd=lambda x: x):
    """Top-k experts (ties to the lower index) and renormalised gates."""
    k = cfg["experts_per_token"]
    probs = torch.softmax(rnd(common.mm(h, lw["moe/router"], quant)), -1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    return idx, gate / gate.sum(-1, keepdim=True)


def _positions(cfg, idx, ahead=None):
    """Each choice's slot in its expert: the earlier choices of the same
    expert in (token, choice) order, after ``ahead`` (E,) taken before."""
    e = cfg["num_experts"]
    hot = F.one_hot(idx, e).reshape(-1, e)
    pos = ((torch.cumsum(hot, 0) - hot) * hot).sum(-1).view(idx.shape)
    if ahead is not None:
        pos = pos + ahead[idx]
    return pos


def _experts(cfg, lw, h, idx, gate, keep, quant, rnd=lambda x: x):
    out = torch.zeros_like(h)
    for x in range(cfg["num_experts"]):
        t, c = torch.nonzero((idx == x) & keep, as_tuple=True)
        if t.numel() == 0:
            continue
        hx = h[t]
        y = F.silu(common.mm(hx, lw["moe/w_gate"][x], quant)) * \
            common.mm(hx, lw["moe/w_up"][x], quant)
        y = common.mm(rnd(y), lw["moe/w_down"][x], quant)
        out.index_add_(0, t, y * rnd(gate[t, c])[:, None])
    return out


def pad_choices(cfg, weights, pads: int, plen: int, quant=None):
    """Each layer's expert choices of the ``pads`` pad tokens (P, k), their
    path rounded as bfloat16: a pad's attention gives 0, so its stream is
    the pad embedding plus its experts' outputs, and the pads, first in
    the group, fill slots in their own order."""
    if pads == 0:
        return [None] * cfg["num_layers"]
    x = weights["embedding"][0].float()[None].repeat(pads, 1)
    out = []
    for i in range(cfg["num_layers"]):
        lw = common.layer_weights(weights, i)
        h = _bf16(common.norm(cfg, x, lw["ln2/scale"], lw.get("ln2/bias")))
        idx, gate = _route(cfg, lw, h, quant, _bf16)
        out.append(idx)
        keep = _positions(cfg, idx) < capacity(cfg, plen)
        x = _bf16(x + _bf16(_experts(cfg, lw, h, idx, gate, keep, quant,
                                     _bf16)))
    return out


def logits(cfg: dict, weights, prompt, served, plen: int, quant=None):
    """f32 logits at the position of each served token, the prompt routed
    as one group padded to ``plen``."""
    n = len(prompt)
    pads = pad_choices(cfg, weights, plen - n, plen, quant)
    cap = capacity(cfg, plen)

    def ffn(cfg, lw, h, quant, i):
        idx, gate = _route(cfg, lw, h, quant)
        keep = torch.ones_like(idx, dtype=torch.bool)
        ahead = None
        if pads[i] is not None:
            ahead = torch.bincount(pads[i].reshape(-1),
                                   minlength=cfg["num_experts"])
        keep[:n] = _positions(cfg, idx[:n], ahead) < cap
        return _experts(cfg, lw, h, idx, gate, keep, quant)

    return common.forward(cfg, weights, *common.sequence(weights, prompt,
                                                         served), ffn, quant)
