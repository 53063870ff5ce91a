"""Shared layers: norms, RoPE, GQA attention (chunked or flash), gated MLP.

Every dense projection goes through ``core.matmul`` (the CUDA GEMM kernel
on the card) and every eligible prefill attention through
``core.flash_attention`` (the CUDA flash kernel).  Decode-step attention
(``_sdpa_chunked``) stays plain torch ops, as it is plain jnp in the
reference.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import torch

from repro_torch.core import einsum, matmul
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.params import ParamSpec

logger = logging.getLogger(__name__)

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def norm_template(d: int, kind: str):
    if kind == "rmsnorm":
        return {"scale": ParamSpec((d,), ("embed",), init="ones")}
    if kind == "layernorm":
        return {"scale": ParamSpec((d,), ("embed",), init="ones"),
                "bias": ParamSpec((d,), ("embed",), init="zeros")}
    raise ValueError(kind)


def apply_norm(params, x: torch.Tensor, *, eps: float) -> torch.Tensor:
    xf = x.float()
    if "bias" in params:  # layernorm
        xf = xf - xf.mean(-1, keepdim=True)
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    else:  # rmsnorm
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * params["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (with partial-dim fraction, as in ChatGLM / StableLM)
# ---------------------------------------------------------------------------


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    d = x.shape[-1]
    rot = int(d * fraction) // 2 * 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(theta, exps)
    angles = positions[..., None].float() * freqs           # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    return torch.cat([out, x_pass], dim=-1) if rot < d else out


# ---------------------------------------------------------------------------
# Attention (GQA, query-chunked, KV cache)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnDims:
    num_heads: int
    num_kv_heads: int
    head_dim: int

    @property
    def group(self) -> int:
        return self.num_heads // self.num_kv_heads


def attention_template(d_model: int, dims: AttnDims, qkv_bias: bool = False):
    h, kv, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim
    t = {
        "wq": ParamSpec((d_model, h * hd), ("embed", "ff")),
        "wk": ParamSpec((d_model, kv * hd), ("embed", "ff")),
        "wv": ParamSpec((d_model, kv * hd), ("embed", "ff")),
        "wo": ParamSpec((h * hd, d_model), ("ff", "embed")),
    }
    if qkv_bias:
        t["bq"] = ParamSpec((h * hd,), ("ff",), init="zeros")
        t["bk"] = ParamSpec((kv * hd,), ("ff",), init="zeros")
        t["bv"] = ParamSpec((kv * hd,), ("ff",), init="zeros")
    return t


def _sdpa_chunked(q, k, v, *, causal: bool, q_offset: int,
                  kv_len: Optional[int], chunk: int = 1024,
                  p_dtype: torch.dtype = torch.float32,
                  kv_start: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped scaled-dot-product attention, chunked over queries.

    q: (B, Sq, KV, G, hd); k, v: (B, Skv, KV, hd).  ``q_offset`` is the
    absolute position of q[0] (decode: the cache length); ``kv_len`` the
    number of valid cache entries; ``kv_start`` (B,) the first valid cache
    column per row (earlier columns are left pad and masked with -1e30).
    """
    b, sq, kvh, g, hd = q.shape
    skv = k.shape[1]
    scale = hd ** -0.5
    kf = k.float()
    vf = v.to(p_dtype)
    col_ids = torch.arange(skv, device=q.device)

    def one_chunk(q_c, row0):
        s = einsum("bqkgd,btkd->bqkgt", q_c.float() * scale, kf)
        mask = torch.ones(q_c.shape[1], skv, dtype=torch.bool, device=q.device)
        if causal:
            rows = row0 + q_offset + torch.arange(q_c.shape[1], device=q.device)
            mask &= col_ids[None, :] <= rows[:, None]
        if kv_len is not None:
            mask &= col_ids[None, :] < kv_len
        if kv_start is None:
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
        else:  # per-row pad mask -> (B, C, Skv)
            maskb = mask[None] & (col_ids[None, None, :]
                                  >= kv_start[:, None, None])
            s = torch.where(maskb[:, :, None, None, :], s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(p_dtype)
        return einsum("bqkgt,btkd->bqkgd", p, vf).to(q.dtype)

    if sq <= chunk:
        return one_chunk(q, 0)
    while sq % chunk:  # largest divisor <= chunk
        chunk -= 1
    return torch.cat([one_chunk(q[:, r:r + chunk], r)
                      for r in range(0, sq, chunk)], dim=1)


#: fallback reasons already logged this process (each is logged once)
_FLASH_FALLBACKS_LOGGED = set()


def flash_fallback_reason(*, causal: bool, seq_len: int,
                          cross_attention: bool,
                          cache_offset_static_zero: bool = True
                          ) -> Optional[str]:
    """Why a flash-requested attention call must use the chunked path.

    ``None`` when the flash kernel applies: causal self-attention with more
    than one query, written at cache offset 0 (forwards and prefill, ragged
    rows included).  Otherwise one of ``cross-attention``, ``non-causal``,
    ``decode-step`` or ``cached-continuation``.
    """
    if cross_attention:
        return "cross-attention"
    if not causal:
        return "non-causal"
    if seq_len == 1:
        return "decode-step"
    if not cache_offset_static_zero:
        return "cached-continuation"
    return None


def _log_flash_fallback(reason: str) -> None:
    if reason not in _FLASH_FALLBACKS_LOGGED:
        _FLASH_FALLBACKS_LOGGED.add(reason)
        logger.info("flash attention requested but falling back to the "
                    "chunked path: %s (logged once)", reason)


def attention(
    params,
    x: torch.Tensor,
    dims: AttnDims,
    *,
    positions: Optional[torch.Tensor] = None,
    rope_theta: float = 0.0,
    rope_fraction: float = 1.0,
    kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    cache_offset: Optional[int] = None,
    causal: bool = True,
    q_chunk: int = 1024,
    p_dtype: torch.dtype = torch.float32,
    attn_impl: str = "chunked",
    kv_start: Optional[torch.Tensor] = None,
):
    """Self-attention.  Returns (out, new_kv_cache_or_None).

    With ``kv_cache`` the new K/V are written at ``cache_offset`` and
    attention runs over the cache.  The write is in place: the cache
    tensors passed in are the ones returned (a functional copy per layer
    and step would double the cache's memory traffic).  ``kv_start`` (B,)
    masks each row's left pad.  ``attn_impl="flash"`` routes every eligible
    call (see :func:`flash_fallback_reason`) through the flash kernel.
    """
    b, s, _ = x.shape
    h, kvh, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim

    use_flash = False
    if attn_impl == "flash":
        reason = flash_fallback_reason(
            causal=causal, seq_len=s, cross_attention=False,
            cache_offset_static_zero=(kv_cache is None or not cache_offset))
        if reason is None:
            use_flash = True
        else:
            _log_flash_fallback(reason)

    q = matmul(x, params["wq"], bias=params.get("bq")).reshape(b, s, h, hd)
    k = matmul(x, params["wk"], bias=params.get("bk")).reshape(b, s, kvh, hd)
    v = matmul(x, params["wv"], bias=params.get("bv")).reshape(b, s, kvh, hd)
    if rope_theta:
        q = apply_rope(q, positions, theta=rope_theta, fraction=rope_fraction)
        k = apply_rope(k, positions, theta=rope_theta, fraction=rope_fraction)

    new_cache = None
    kv_len = None
    q_offset = 0
    if kv_cache is not None:
        ck, cv = kv_cache
        if isinstance(ck, dict):
            raise NotImplementedError(
                "int8 KV cache: not ported yet (ROADMAP.md queue 1, item 5)")
        off = int(cache_offset)
        ck[:, off:off + s] = k.to(ck.dtype)
        cv[:, off:off + s] = v.to(cv.dtype)
        k, v = ck, cv
        q_offset = off
        kv_len = off + s
        new_cache = (ck, cv)

    if use_flash:
        # With a cache the routing guarantees offset 0 (prefill): attend
        # over exactly the s columns just written, read back from the cache.
        from repro_torch.core import flash_attention
        kf, vf = (k[:, :s], v[:, :s]) if kv_cache is not None else (k, v)
        out = flash_attention(q, kf, vf, causal=causal, kv_start=kv_start)
        return matmul(out.reshape(b, s, h * hd), params["wo"]), new_cache

    qg = q.reshape(b, s, kvh, dims.group, hd)
    out = _sdpa_chunked(qg, k, v, causal=causal, q_offset=q_offset,
                        kv_len=kv_len, chunk=q_chunk, p_dtype=p_dtype,
                        kv_start=kv_start)
    return matmul(out.reshape(b, s, h * hd), params["wo"]), new_cache


# ---------------------------------------------------------------------------
# Gated MLP (llama-style SwiGLU): the SiLU rides on the GEMM's epilogue
# ---------------------------------------------------------------------------


def mlp_template(d_model: int, d_ff: int):
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("embed", "ff")),
        "w_up": ParamSpec((d_model, d_ff), ("embed", "ff")),
        "w_down": ParamSpec((d_ff, d_model), ("ff", "embed")),
    }


def mlp(params, x: torch.Tensor) -> torch.Tensor:
    gate = matmul(x, params["w_gate"], activation="silu")
    up = matmul(x, params["w_up"])
    return matmul(gate * up, params["w_down"])
