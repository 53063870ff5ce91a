"""Shared layers: norms, RoPE, GQA attention (chunked or flash), the gated
MLP and whisper's GELU MLP.

Every dense projection goes through ``core.matmul`` (the CUDA GEMM kernel
on the card) and every eligible prefill attention through
``core.flash_attention`` (the CUDA flash kernel).  Decode-step attention
and cross-attention (``_sdpa_chunked``) stay plain torch ops, as they are
plain jnp in the reference.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core import einsum, matmul
from repro_torch.distributed import ops as dops
from repro_torch.kernels.ref import NEG_INF
from repro_torch.models.params import ParamSpec
from repro_torch.profiling import annotate

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


def cross_kv(params, src: torch.Tensor, dims: AttnDims):
    """Project encoder / image embeddings (B, N, D) to the cross-attention
    K, V (B, N, KV, hd), once per prompt."""
    heads = (dims.num_kv_heads, dims.head_dim)
    k = dops.unflatten(matmul(src, params["wk"], bias=params.get("bk")), -1,
                       heads)
    v = dops.unflatten(matmul(src, params["wv"], bias=params.get("bv")), -1,
                       heads)
    return k, v


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


def kv_quantize(x: torch.Tensor):
    """Per-(token, head) symmetric int8 quantization of a (B, S, KV, hd)
    slab -> (int8 values, f32 scales (B, S, KV)).  Division in f32 and
    round-half-to-even, as the reference: the same bits on the same input."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0]


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.float() * scale[..., None]).to(dtype)


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
    kv_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    q_chunk: int = 1024,
    p_dtype: torch.dtype = torch.float32,
    attn_impl: str = "chunked",
    kv_start: Optional[torch.Tensor] = None,
):
    """Self-attention, or cross-attention over ``kv_override`` (K, V from
    :func:`cross_kv`: non-causal, chunked, no cache).  Returns (out,
    new_kv_cache_or_None).

    With ``kv_cache`` the new K/V are written at ``cache_offset`` and
    attention runs over the cache.  The write is in place: the cache
    tensors passed in are the ones returned (a functional copy per layer
    and step would double the cache's memory traffic).  An int8 cache
    (``{"q": int8, "s": f32}`` per K and V) stores the quantized K/V and
    attention reads them dequantized.  ``kv_start`` (B,)
    masks each row's left pad.  ``attn_impl="flash"`` routes every eligible
    call (see :func:`flash_fallback_reason`) through the flash kernel.
    """
    b, s, _ = x.shape
    h, kvh, hd = dims.num_heads, dims.num_kv_heads, dims.head_dim

    use_flash = False
    if attn_impl == "flash":
        reason = flash_fallback_reason(
            causal=causal, seq_len=s, cross_attention=kv_override is not None,
            cache_offset_static_zero=(kv_cache is None or not cache_offset))
        if reason is None:
            use_flash = True
        else:
            _log_flash_fallback(reason)

    q = dops.unflatten(matmul(x, params["wq"], bias=params.get("bq")), -1,
                       (h, hd))
    if kv_override is not None:
        k, v = kv_override
        out = _sdpa_chunked(dops.unflatten(q, 2, (kvh, dims.group)), k, v,
                            causal=False, q_offset=0, kv_len=None,
                            chunk=q_chunk, p_dtype=p_dtype)
        return matmul(out.reshape(b, s, h * hd), params["wo"]), None
    k = dops.unflatten(matmul(x, params["wk"], bias=params.get("bk")), -1,
                       (kvh, hd))
    v = dops.unflatten(matmul(x, params["wv"], bias=params.get("bv")), -1,
                       (kvh, hd))
    if rope_theta:
        q = apply_rope(q, positions, theta=rope_theta, fraction=rope_fraction)
        k = apply_rope(k, positions, theta=rope_theta, fraction=rope_fraction)

    # the attention core, from the cache write to the output projection
    with annotate("model.attn"):
        new_cache = None
        kv_len = None
        q_offset = 0
        if kv_cache is not None:
            ck, cv = kv_cache
            off = int(cache_offset)
            if isinstance(ck, dict):   # int8 cache: {"q": i8, "s": f32}
                for leaf, x_new in ((ck, k), (cv, v)):
                    xq, xs = kv_quantize(x_new)
                    _write_columns(leaf["q"], off, xq)
                    _write_columns(leaf["s"], off, xs)
                k = kv_dequantize(ck["q"], ck["s"], k.dtype)
                v = kv_dequantize(cv["q"], cv["s"], v.dtype)
            else:
                _write_columns(ck, off, k.to(ck.dtype))
                _write_columns(cv, off, v.to(cv.dtype))
                k, v = ck, cv
            q_offset = off
            kv_len = off + s
            new_cache = (ck, cv)

        if use_flash:
            # With a cache the routing guarantees offset 0 (prefill): attend
            # over exactly the s columns just written, read back from the
            # cache (for an int8 cache, dequantized, as the chunked path
            # reads them).
            from repro_torch.core import flash_attention
            kf, vf = (k[:, :s], v[:, :s]) if kv_cache is not None else (k, v)
            out = flash_attention(q, kf, vf, causal=causal, kv_start=kv_start)
        else:
            qg = dops.unflatten(q, 2, (kvh, dims.group))
            out = _sdpa_chunked(qg, k, v, causal=causal, q_offset=q_offset,
                                kv_len=kv_len, chunk=q_chunk, p_dtype=p_dtype,
                                kv_start=kv_start)
    return matmul(out.reshape(b, s, h * hd), params["wo"]), new_cache


def _write_columns(cache: torch.Tensor, off: int, new: torch.Tensor) -> None:
    """``cache[:, off:off + S] = new`` in place (a cache on a mesh may split
    its sequence over an axis: each rank writes the columns it holds)."""
    if isinstance(cache, DTensor):
        dops.write_slice(cache, 1, off, new)
    else:
        cache[:, off:off + new.shape[1]] = new


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


def mlp_gelu_template(d_model: int, d_ff: int):
    """Whisper's two-matrix GELU MLP, with biases."""
    return {
        "w_up": ParamSpec((d_model, d_ff), ("embed", "ff")),
        "b_up": ParamSpec((d_ff,), ("ff",), init="zeros"),
        "w_down": ParamSpec((d_ff, d_model), ("ff", "embed")),
        "b_down": ParamSpec((d_model,), ("embed",), init="zeros"),
    }


def mlp_gelu(params, x: torch.Tensor) -> torch.Tensor:
    """The bias and the tanh-approximated GELU ride on the GEMM's epilogue."""
    h = matmul(x, params["w_up"], bias=params["b_up"], activation="gelu")
    return matmul(h, params["w_down"], bias=params["b_down"])
