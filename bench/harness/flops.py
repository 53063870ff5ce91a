"""Operations and bytes of the model's work, from the configuration alone.

The count is of what the algorithm needs for the tokens served, whatever
implements it: every matrix product of a token's step (the projections,
the router and the ``top_k`` experts it uses, the dense MLP, the unembed
where logits are wanted) at 2 FLOP a multiply-add, and attention's two
products (scores and the weighted sum of values) at each token's own
context.  Bytes count each weight once a call, each activation read once
and written once, in the served type (2 bytes); logits are f32.
"""
from __future__ import annotations

from typing import Iterable, List, Tuple

from harness import peaks

BF16 = 2
F32 = 4


def dims(cfg: dict):
    hd = cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]
    return (cfg["num_layers"], cfg["d_model"], cfg["num_heads"],
            cfg["num_kv_heads"], hd)


def projections(cfg: dict) -> List[Tuple[int, int]]:
    """(in, out) of one layer's dense products a token goes through, the
    experts' excluded."""
    _, d, h, kv, hd = dims(cfg)
    out = [(d, h * hd), (d, kv * hd), (d, kv * hd), (h * hd, d)]
    if cfg.get("num_experts"):
        out.append((d, cfg["num_experts"]))
    else:
        ff = cfg["d_ff"]
        out += [(d, ff), (d, ff), (ff, d)]
    return out


def matmul_params_per_token(cfg: dict, unembed: bool = True) -> int:
    """Weights a token multiplies: every layer's projections, the experts
    it is routed to, and (``unembed``) the head."""
    L, d, *_ = dims(cfg)
    per_layer = sum(i * o for i, o in projections(cfg))
    if cfg.get("num_experts"):
        per_layer += cfg["experts_per_token"] * 3 * d * cfg["d_ff"]
    return L * per_layer + (d * cfg["vocab_size"] if unembed else 0)


def attention_flops(cfg: dict, ctx: int) -> int:
    """Scores and weighted values of one query over ``ctx`` keys, every
    layer: 2 * 2 * heads * head_dim * ctx."""
    L, _, h, _, hd = dims(cfg)
    return 4 * L * h * hd * ctx


def decode_token_flops(cfg: dict, ctx: int) -> int:
    """One decoded token at context ``ctx`` (itself included)."""
    return 2 * matmul_params_per_token(cfg) + attention_flops(cfg, ctx)


def prompt_flops(cfg: dict, n: int) -> int:
    """A prompt of ``n`` real tokens: every token through the stack,
    causal attention, logits at its last position only."""
    L, _, h, _, hd = dims(cfg)
    return (2 * matmul_params_per_token(cfg, unembed=False) * n
            + 2 * cfg["d_model"] * cfg["vocab_size"]
            + 4 * L * h * hd * n * (n + 1) // 2)


def bound_s(flops: float, nbytes: float) -> float:
    """Least time on one H100 for a call: compute or memory."""
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_S)


def _product(m: int, k: int, n: int, weight_bytes=None) -> float:
    """Bound of an (m x k) @ (k x n) product in bf16."""
    wb = k * n * BF16 if weight_bytes is None else weight_bytes
    return bound_s(2 * m * k * n, wb + (m * k + m * n) * BF16)


def touched_experts(cfg: dict, slots: int) -> float:
    """Experts that ``slots`` routed choices reach on average, under even
    routing: E (1 - (1 - k/E) ** tokens), tokens = slots / k."""
    e, k = cfg["num_experts"], cfg["experts_per_token"]
    return e * (1.0 - (1.0 - k / e) ** (slots / k))


def _expert_bound(cfg: dict, tokens: int) -> float:
    """One layer's three expert products over ``tokens`` tokens."""
    d, ff, k = cfg["d_model"], cfg["d_ff"], cfg["experts_per_token"]
    slots = tokens * k
    wb = touched_experts(cfg, slots) * d * ff * BF16
    return (2 * _product(slots, d, ff, wb) + _product(slots, ff, d, wb))


def decode_step_gemm_bound_s(cfg: dict, ctxs: Iterable[int]) -> float:
    """Least time of one decode step's matrix products over the live rows
    at contexts ``ctxs``: projections, router, experts, unembed, and
    attention's two products (K, then V, read once at each row's context)."""
    ctxs = list(ctxs)
    b = len(ctxs)
    if not b:
        return 0.0
    L, d, h, kv, hd = dims(cfg)
    per_layer = sum(_product(b, i, o) for i, o in projections(cfg))
    if cfg.get("num_experts"):
        per_layer += _expert_bound(cfg, b)
    attn = sum(2 * bound_s(2 * h * hd * c, (kv * hd * c + 2 * h * hd) * BF16)
               for c in ctxs)
    head = bound_s(2 * b * d * cfg["vocab_size"],
                   (d * cfg["vocab_size"] + b * d) * BF16
                   + b * cfg["vocab_size"] * F32)
    return L * (per_layer + attn) + head


def prefill_gemm_bound_s(cfg: dict, lengths: Iterable[int]) -> float:
    """Least time of one admission prefill's matrix products over the real
    tokens of the admitted prompts (attention apart: that is the flash
    kernel's), with the logits of each prompt's last position."""
    lengths = list(lengths)
    t, rows = sum(lengths), len(lengths)
    if not t:
        return 0.0
    L, d, *_ = dims(cfg)
    per_layer = sum(_product(t, i, o) for i, o in projections(cfg))
    if cfg.get("num_experts"):
        per_layer += _expert_bound(cfg, t)
    head = bound_s(2 * rows * d * cfg["vocab_size"],
                   (d * cfg["vocab_size"] + rows * d) * BF16
                   + rows * cfg["vocab_size"] * F32)
    return L * per_layer + head


def prefill_attention_bound_s(cfg: dict, lengths: Iterable[int]) -> float:
    """Least time of one admission prefill's causal attention over the
    real prompts (one call a layer over every admitted row): scores and
    weighted values at n (n + 1) / 2 pairs a prompt; Q, K, V read and the
    output written once."""
    lengths = list(lengths)
    if not lengths:
        return 0.0
    L, _, h, kv, hd = dims(cfg)
    fl = sum(2 * 2 * h * hd * n * (n + 1) // 2 for n in lengths)
    by = sum(n * (2 * h * hd + 2 * kv * hd) * BF16 for n in lengths)
    return L * bound_s(fl, by)

