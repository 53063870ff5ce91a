"""The parts of a decoder-only transformer that every family shares, in
float32: norms, rotary positions, grouped causal attention, the stack and
the head.  A family module supplies the feed-forward part of a layer.

``quant`` (None for the reference) rounds each matrix product's operands
before the product: the control runs the same arithmetic in a lower
precision.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch

Quant = Optional[Callable[[torch.Tensor, int], torch.Tensor]]


def mm(x: torch.Tensor, w: torch.Tensor, quant: Quant = None) -> torch.Tensor:
    """x @ w in float32; under ``quant`` x by rows and w by output columns."""
    x, w = x.float(), w.float()
    if quant is not None:
        x, w = quant(x, -1), quant(w, -2)
    return x @ w


def norm(cfg: dict, x: torch.Tensor, scale, bias=None) -> torch.Tensor:
    eps = cfg.get("norm_eps", 1e-5)
    if cfg.get("norm", "rmsnorm") == "layernorm":
        x = x - x.mean(-1, keepdim=True)
        out = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
        return out * scale.float() + bias.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * \
        scale.float()


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float,
         fraction: float) -> torch.Tensor:
    """Rotary positions on the first ``fraction`` of each head's dims,
    which split into two halves rotated together.  x: (S, H, D)."""
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    if rot == 0:
        return x
    half = rot // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = pos.to(torch.float64)[:, None] * freqs           # (S, half)
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:rot]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin, x[..., rot:]],
                     dim=-1)


def attention(cfg: dict, lw: Dict[str, torch.Tensor], h: torch.Tensor,
              pos: torch.Tensor, valid: torch.Tensor, quant: Quant,
              chunk: int = 512) -> torch.Tensor:
    """Causal self-attention of the sequence ``h`` (S, d) over its valid
    positions; an invalid (pad) query attends to nothing and gives 0."""
    s_len = h.shape[0]
    nh, kvh = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg.get("head_dim") or cfg["d_model"] // nh
    theta = cfg["rope_theta"]
    frac = cfg.get("rope_fraction", 1.0)
    q = mm(h, lw["attn/wq"], quant).view(s_len, nh, hd)
    k = mm(h, lw["attn/wk"], quant).view(s_len, kvh, hd)
    v = mm(h, lw["attn/wv"], quant).view(s_len, kvh, hd)
    if cfg.get("use_rope", True):
        q, k = rope(q, pos, theta, frac), rope(k, pos, theta, frac)
    k = k.repeat_interleave(nh // kvh, dim=1)
    v = v.repeat_interleave(nh // kvh, dim=1)
    out = torch.zeros_like(q)
    idx = torch.arange(s_len, device=h.device)
    for c0 in range(0, s_len, chunk):
        c1 = min(c0 + chunk, s_len)
        sc = torch.einsum("chd,thd->hct", q[c0:c1] / math.sqrt(hd), k)
        allow = (idx[None, :] <= idx[c0:c1, None]) & valid[None, :]
        p = torch.softmax(sc.masked_fill(~allow[None], float("-inf")), -1)
        p = torch.where(valid[c0:c1][None, :, None], p, torch.zeros_like(p))
        out[c0:c1] = torch.einsum("hct,thd->chd", p, v)
    return mm(out.reshape(s_len, nh * hd), lw["attn/wo"], quant)


def layer_weights(weights: Dict[str, torch.Tensor], i: int
                  ) -> Dict[str, torch.Tensor]:
    """Layer ``i`` of the stacked ``blocks/...`` leaves (views)."""
    return {k[len("blocks/"):]: v[i] for k, v in weights.items()
            if k.startswith("blocks/")}


def forward(cfg: dict, weights: Dict[str, torch.Tensor], seq: torch.Tensor,
            valid: torch.Tensor, pos: torch.Tensor, judged: torch.Tensor,
            ffn, quant: Quant = None) -> torch.Tensor:
    """f32 logits (len(judged), vocab) of the sequence ``seq`` at the
    positions ``judged``.  ``ffn(cfg, lw, h, quant, i)`` is the family's
    feed-forward part of layer ``i``."""
    x = weights["embedding"][seq].float()
    for i in range(cfg["num_layers"]):
        lw = layer_weights(weights, i)
        x = x + attention(cfg, lw, norm(cfg, x, lw["ln1/scale"],
                                        lw.get("ln1/bias")), pos, valid,
                          quant)
        x = x + ffn(cfg, lw, norm(cfg, x, lw["ln2/scale"],
                                  lw.get("ln2/bias")), quant, i)
    x = norm(cfg, x[judged], weights["ln_f/scale"], weights.get("ln_f/bias"))
    return mm(x, weights["lm_head"], quant)


def sequence(weights, prompt, served):
    """(tokens, valid, positions, judged) of a prompt and its served
    tokens: every served token's but the last is an input; the logits
    that chose each served token sit at the last prompt position, then at
    each served token's."""
    dev = weights["embedding"].device
    seq = torch.tensor(list(prompt) + list(served[:-1]), device=dev)
    n = len(prompt)
    return (seq, torch.ones(len(seq), dtype=torch.bool, device=dev),
            torch.arange(len(seq), device=dev),
            torch.arange(n - 1, n - 1 + len(served), device=dev))


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per slice along
    ``dim`` (its largest magnitude at 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale
