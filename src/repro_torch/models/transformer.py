"""Decoder-only transformer LM, dense branch: built from the shared layers,
the GEMM kernel and the flash kernel.

Layer params are stacked on a leading "layer" dim, as in the reference; the
stack runs as a Python loop over that dim where the reference uses
``lax.scan``.  KV caches are ``{"self": (K, V)}`` with K, V of shape
(L, B, S, KV, hd), updated in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import matmul
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.params import ParamSpec, map_tree


def attn_dims(cfg: ModelConfig) -> L.AttnDims:
    return L.AttnDims(cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim)


def _stack_template(t, n: int):
    """Prepend a 'layer' axis of size n to every ParamSpec in ``t``."""
    return map_tree(lambda _p, s: ParamSpec((n,) + s.shape, ("layer",) + s.axes,
                                            init=s.init, scale=s.scale,
                                            dtype=s.dtype), t)


def _layer(tree, i: int):
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return map_tree(lambda _p, x: x[i], tree)


def _dense_block_template(cfg: ModelConfig):
    qkv_bias = cfg.name.startswith("chatglm")  # ChatGLM uses QKV bias
    return {
        "ln1": L.norm_template(cfg.d_model, cfg.norm),
        "attn": L.attention_template(cfg.d_model, attn_dims(cfg), qkv_bias),
        "ln2": L.norm_template(cfg.d_model, cfg.norm),
        "mlp": L.mlp_template(cfg.d_model, cfg.d_ff),
    }


def template(cfg: ModelConfig):
    t: Dict[str, Any] = {
        "embedding": ParamSpec((cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"), scale=0.02),
        "ln_f": L.norm_template(cfg.d_model, cfg.norm),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab"))
    t["blocks"] = _stack_template(_dense_block_template(cfg), cfg.num_layers)
    return t


def _dense_block(cfg: ModelConfig, bp, x, positions, kv_cache=None,
                 cache_offset=None, kv_start=None):
    h, new_cache = L.attention(
        bp["attn"], L.apply_norm(bp["ln1"], x, eps=cfg.norm_eps),
        attn_dims(cfg), positions=positions,
        rope_theta=cfg.rope_theta if cfg.use_rope else 0.0,
        rope_fraction=cfg.rope_fraction,
        kv_cache=kv_cache, cache_offset=cache_offset,
        p_dtype=getattr(torch, cfg.attn_p_dtype),
        attn_impl=cfg.attention_impl, kv_start=kv_start)
    x = x + h
    y = L.mlp(bp["mlp"], L.apply_norm(bp["ln2"], x, eps=cfg.norm_eps))
    return x + y, new_cache


def _run_dense_stack(cfg, blocks, x, positions, caches=None,
                     cache_offset=None, kv_start=None):
    """Loop over the stacked layers.  Returns (x, caches_or_None)."""
    for i in range(cfg.num_layers):
        cache = None if caches is None else (caches[0][i], caches[1][i])
        x, _ = _dense_block(cfg, _layer(blocks, i), x, positions,
                            kv_cache=cache, cache_offset=cache_offset,
                            kv_start=kv_start)
    return x, caches


def _embed(cfg, params, tokens):
    rows = params["embedding"].index_select(0, tokens.reshape(-1))
    return rows.reshape(*tokens.shape, -1).to(getattr(torch, cfg.dtype))


def unembed_weight(cfg: ModelConfig, params):
    """(d_model, vocab); for tied embeddings a transposed view, not a copy."""
    return params["embedding"].t() if cfg.tie_embeddings else params["lm_head"]


def _unembed(cfg, params, x):
    x = L.apply_norm(params["ln_f"], x, eps=cfg.norm_eps)
    return matmul(x, unembed_weight(cfg, params).to(x.dtype),
                  out_dtype=torch.float32)


def _positions(batch: int, seq: int, device, offset: int = 0):
    return offset + torch.arange(seq, dtype=torch.int32,
                                 device=device).expand(batch, seq)


def _ragged_positions(seq: int, kv_start: torch.Tensor):
    """Per-row positions of a left-padded ragged batch: each row's first real
    token sits at position 0 (pad columns clamp to 0; they are masked)."""
    pos = (torch.arange(seq, dtype=torch.int32, device=kv_start.device)[None, :]
           - kv_start[:, None])
    return pos.clamp(min=0)


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """Scoring forward -> (logits f32 (B, S, V), aux_loss)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(cfg, params, tokens)
    x, _ = _run_dense_stack(cfg, params["blocks"], x,
                            _positions(b, s, tokens.device))
    return _unembed(cfg, params, x), 0.0


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None):
    """Zeroed KV cache ``{"self": (K, V)}``, each (L, B, max_len, KV, hd)."""
    if cfg.kv_quant:
        raise NotImplementedError(
            "int8 KV cache: not ported yet (ROADMAP.md queue 1, item 5)")
    dtype = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads,
             cfg.resolved_head_dim)
    dev = resolve_device(device)
    return {"self": (torch.zeros(shape, dtype=dtype, device=dev),
                     torch.zeros(shape, dtype=dtype, device=dev))}


def prefill(cfg: ModelConfig, params, batch, cache):
    """Run the prompt through the model, filling ``cache`` in place.
    Returns (last-token logits (B, V) f32, cache).

    ``batch["kv_start"]`` (optional (B,) int32) marks per-row left pad: pad
    columns are masked out of attention and positions restart at 0 at each
    row's first real token, so every row computes what it would alone."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    kv_start: Optional[torch.Tensor] = batch.get("kv_start")
    x = _embed(cfg, params, tokens)
    pos = (_positions(b, s, tokens.device) if kv_start is None
           else _ragged_positions(s, kv_start))
    x, new_self = _run_dense_stack(cfg, params["blocks"], x, pos,
                                   caches=cache["self"], cache_offset=0,
                                   kv_start=kv_start)
    logits = _unembed(cfg, params, x[:, -1:, :])[:, 0]
    return logits, {"self": new_self}


def decode_step(cfg: ModelConfig, params, tokens, cache, offset: int,
                kv_start: Optional[torch.Tensor] = None):
    """One token step.  tokens: (B, 1); ``offset`` (int) = current length.
    Returns (logits (B, V) f32, cache)."""
    b = tokens.shape[0]
    x = _embed(cfg, params, tokens)
    if kv_start is None:
        pos = torch.full((b, 1), offset, dtype=torch.int32, device=tokens.device)
    else:
        pos = (offset - kv_start).clamp(min=0).to(torch.int32)[:, None]
    x, new_self = _run_dense_stack(cfg, params["blocks"], x, pos,
                                   caches=cache["self"], cache_offset=offset,
                                   kv_start=kv_start)
    return _unembed(cfg, params, x)[:, 0], {"self": new_self}
