"""Plain PyTorch versions of every kernel in this package.

They share the semantics of the JAX package's oracles (``repro/kernels/ref.py``
and the Pallas kernels): the paper's GEMM (Eq. 1)

    C = act(alpha * A @ B + beta * C + bias)

accumulated in float32 whatever the input dtype, and the online-softmax
flash attention with its masking guards.  The CPU tests hold them against
the JAX package; ``chip_smoke.py`` holds the CUDA kernels against them on
the card.  A wrapper runs them only for tensors that lie on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

#: masked score value, and the threshold at/below which a score counts as
#: masked when guarding exp() (far below any reachable logit, far above NEG_INF)
NEG_INF = -1e30
MASKED_BELOW = -1e28

# jax.nn.gelu defaults to the tanh approximation; torch's default is erf.
_ACTIVATIONS = {
    None: lambda x: x,
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
}
#: kernel-side activation codes (same order as the CUDA epilogue's switch)
ACTIVATION_CODES = {None: 0, "relu": 1, "gelu": 2, "silu": 3, "tanh": 4}


def apply_epilogue(out_f32: torch.Tensor, bias: Optional[torch.Tensor] = None,
                   activation: Optional[str] = None) -> torch.Tensor:
    if bias is not None:
        out_f32 = out_f32 + bias.float()
    if activation not in _ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    return _ACTIVATIONS[activation](out_f32)


def gemm_ref(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
             *, alpha: float = 1.0, beta: float = 0.0,
             bias: Optional[torch.Tensor] = None,
             activation: Optional[str] = None,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``act(alpha * A @ B + beta * C + bias)`` with float32 accumulation."""
    if a.ndim != 2 or b.ndim != 2:
        raise ValueError(f"gemm_ref expects 2-D operands, got "
                         f"{tuple(a.shape)} @ {tuple(b.shape)}")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"contraction mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    out_dtype = out_dtype or torch.promote_types(a.dtype, b.dtype)
    acc = a.float() @ b.float()
    if alpha != 1.0:
        acc = alpha * acc
    if c is not None:
        acc = acc + beta * c.float()
    acc = apply_epilogue(acc, bias=bias, activation=activation)
    return acc.to(out_dtype)


def attention_ref(q, k, v, *, causal: bool = True, scale=None) -> torch.Tensor:
    """Naive softmax attention.  q: (B, S, H, d); k, v: (B, T, KV, d)."""
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    scale = d ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bthd->bhqt", q.float() * scale, k.float())
    if causal:
        mask = torch.ones(sq, skv, dtype=torch.bool,
                          device=q.device).tril(skv - sq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqt,bthd->bqhd", p, v.float()).to(q.dtype)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        kv_start: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """What the flash kernel computes, without its tiling.

    q: (B, S, H, d); k, v: (B, S_kv, KV, d) with KV dividing H; kv_start:
    optional (B,) first valid KV column per row.  The causal mask is aligned
    bottom-right (``col <= row + S_kv - S``).  Masked scores are -1e30, any
    score <= -1e28 contributes exactly 0, and a row with no valid column
    (``l == 0``) divides by 1, so it comes out as zeros, never NaN.
    """
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    scale = d ** -0.5 if scale is None else scale
    g = h // kvh
    qg = q.float().reshape(b, sq, kvh, g, d) * scale
    s = torch.einsum("bqkgd,btkd->bkgqt", qg, k.float())
    cols = torch.arange(skv, device=q.device)
    valid = torch.ones(b, sq, skv, dtype=torch.bool, device=q.device)
    if causal:
        rows = torch.arange(sq, device=q.device)
        valid = valid & (cols[None, :] <= rows[:, None] + (skv - sq))[None]
    if kv_start is not None:
        ks = kv_start.to(device=q.device, dtype=torch.int64)
        valid = valid & (cols[None, None, :] >= ks[:, None, None])
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s > MASKED_BELOW, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgqt,btkd->bkgqd", p, v.float())
    out = acc / torch.where(l == 0.0, torch.ones_like(l), l)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)
