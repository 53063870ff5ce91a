"""Transformer LMs, dense, MoE and VLM branches, and whisper's
encoder-decoder: built from the shared layers, the MoE layer, the GEMM
kernel and the flash kernel.

Layer params are stacked on a leading "layer" dim, as in the reference; the
stack runs as a Python loop over that dim where the reference uses
``lax.scan``.  A training forward (params under grad) takes the layers
with one ``unbind`` per leaf and, with ``cfg.remat``, recomputes each
block in the backward (``torch.utils.checkpoint``; under ``"dots"`` all but
K1's outputs); its cross layers
project their K, V inside the block, so those are recomputed too.  KV
caches are ``{"self": (K, V)}`` with K, V of shape (L, B, S, KV, hd),
updated in place; an int8 cache (``cfg.kv_quant``) holds ``{"q", "s"}``
dicts in place of K and V.

VLM (llama-3.2-vision style): the stack is ``U`` units of ``P - 1`` self
layers and one cross-attention layer over image embeddings (``P =
cross_attn_period``).  Its self cache keeps both leading dims, (U, P-1, B,
S, KV, hd), and ``"cross"`` holds each unit's image K, V (U, B, N_img, KV,
hd), computed at prefill.  Every cache leaf has its batch dim at -4 and its
token dim at -3, whatever leads them: the serve engine indexes from the end.

Audio (whisper): a non-causal encoder over the frontend stub's frame
embeddings (``encoder_embeds``), then a decoder with learned positions
whose layers run causal self-attention over ``"self"``, cross-attention
over ``"cross"`` (each layer's encoder K, V, (L, B, enc_len, KV, hd),
computed at prefill) and a GELU MLP.

An untied head whose vocab is not a multiple of 8 (whisper's 51866) is
stored K-major: its (d_model, vocab) tensor is the transpose of a
contiguous (vocab, d_model) buffer, as a tied head reads the embedding.
The GEMM's fast kernels read a row-major weight in 16-byte chunks along
its rows, which such a vocab cannot give; a K-major one they read along
d_model at any vocab.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import matmul
from repro_torch.core.gemm_api import dots_checkpoint_contexts
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.distributed import ops as dops
from repro_torch.distributed.ctx import constrain
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.params import ParamSpec, map_tree, tree_leaves


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


def _requires_grad(tree) -> bool:
    """Grad mode is on and a leaf of ``tree`` requires grad: a training
    forward."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(tree))


def _unbound_layers(tree):
    """Every layer of a stacked tree, from one ``unbind`` per leaf.  Under
    autograd ``_layer``'s ``x[i]`` would cost each layer a backward that
    writes a zero tensor the size of the whole stack; ``unbind``'s backward
    stacks the layers' gradients once."""
    per_leaf = [x.unbind(0) for x in tree_leaves(tree)]
    out = []
    for i in range(len(per_leaf[0])):
        it = iter([layers[i] for layers in per_leaf])
        out.append(map_tree(lambda _p, _x: next(it), tree))
    return out


def _stack_layers(blocks, train: bool):
    """Every layer of a stacked tree: by unbind in a training forward
    (``train``), else as select views."""
    if train:
        return _unbound_layers(blocks)
    return [_layer(blocks, i) for i in range(tree_leaves(blocks)[0].shape[0])]


def _maybe_remat(cfg: ModelConfig, fn):
    """``fn`` recomputed in the backward (``cfg.remat``), as the
    reference's ``jax.checkpoint`` of each block: policy ``"full"``
    recomputes the whole block, ``"dots"`` keeps K1's forward outputs and
    recomputes the rest (``gemm_api.dots_policy``, the reference's
    ``dots_with_no_batch_dims_saveable``).  Only a training forward saves
    activations, so only it is wrapped."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn
    if cfg.remat_policy == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    if cfg.remat_policy == "dots":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=dots_checkpoint_contexts)
    raise ValueError(f"unknown remat_policy {cfg.remat_policy!r} "
                     "(full | dots)")


def _dense_block_template(cfg: ModelConfig):
    qkv_bias = cfg.name.startswith("chatglm")  # ChatGLM uses QKV bias
    t = {
        "ln1": L.norm_template(cfg.d_model, cfg.norm),
        "attn": L.attention_template(cfg.d_model, attn_dims(cfg), qkv_bias),
        "ln2": L.norm_template(cfg.d_model, cfg.norm),
    }
    if cfg.num_experts:
        t["moe"] = M.moe_template(cfg.d_model, cfg.d_ff, cfg.num_experts)
    else:
        t["mlp"] = L.mlp_template(cfg.d_model, cfg.d_ff)
    return t


def _cross_block_template(cfg: ModelConfig):
    return {
        "ln1": L.norm_template(cfg.d_model, cfg.norm),
        "cross": L.attention_template(cfg.d_model, attn_dims(cfg)),
        "ln2": L.norm_template(cfg.d_model, cfg.norm),
        "mlp": L.mlp_template(cfg.d_model, cfg.d_ff),
    }


def _encoder_block_template(cfg: ModelConfig):
    return {
        "ln1": L.norm_template(cfg.d_model, cfg.norm),
        "attn": L.attention_template(cfg.d_model, attn_dims(cfg), qkv_bias=True),
        "ln2": L.norm_template(cfg.d_model, cfg.norm),
        "mlp": L.mlp_gelu_template(cfg.d_model, cfg.d_ff),
    }


def _whisper_dec_block_template(cfg: ModelConfig):
    return {
        "ln1": L.norm_template(cfg.d_model, cfg.norm),
        "attn": L.attention_template(cfg.d_model, attn_dims(cfg), qkv_bias=True),
        "ln_x": L.norm_template(cfg.d_model, cfg.norm),
        "cross": L.attention_template(cfg.d_model, attn_dims(cfg), qkv_bias=True),
        "ln2": L.norm_template(cfg.d_model, cfg.norm),
        "mlp": L.mlp_gelu_template(cfg.d_model, cfg.d_ff),
    }


def _units(cfg: ModelConfig):
    """VLM: (units, self layers per unit)."""
    return cfg.num_layers // cfg.cross_attn_period, cfg.cross_attn_period - 1


def embed_template(cfg: ModelConfig) -> Dict[str, Any]:
    """The embedding, the final norm and (untied) the head: every family's
    ends of the stack."""
    t: Dict[str, Any] = {
        "embedding": ParamSpec((cfg.vocab_size, cfg.d_model),
                               ("vocab", "embed"), scale=0.02),
        "ln_f": L.norm_template(cfg.d_model, cfg.norm),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_size),
                                 ("embed", "vocab"),
                                 kmajor=cfg.vocab_size % 8 != 0)
    return t


def template(cfg: ModelConfig):
    t = embed_template(cfg)
    if cfg.family == "vlm":
        units, per_unit = _units(cfg)
        t["units"] = {
            "selfs": _stack_template(
                _stack_template(_dense_block_template(cfg), per_unit), units),
            "cross": _stack_template(_cross_block_template(cfg), units),
        }
    elif cfg.family == "audio":
        t["enc_blocks"] = _stack_template(_encoder_block_template(cfg),
                                          cfg.encoder_layers)
        t["enc_ln_f"] = L.norm_template(cfg.d_model, cfg.norm)
        t["dec_blocks"] = _stack_template(_whisper_dec_block_template(cfg),
                                          cfg.num_layers)
        t["pos_emb"] = ParamSpec((cfg.learned_positions, cfg.d_model),
                                 (None, "embed"), scale=0.02)
    else:
        t["blocks"] = _stack_template(_dense_block_template(cfg),
                                      cfg.num_layers)
    return t


def _dense_block(cfg: ModelConfig, bp, x, positions, kv_cache=None,
                 cache_offset=None, kv_start=None, with_aux=False):
    h, new_cache = L.attention(
        bp["attn"], L.apply_norm(bp["ln1"], x, eps=cfg.norm_eps),
        attn_dims(cfg), positions=positions,
        rope_theta=cfg.rope_theta if cfg.use_rope else 0.0,
        rope_fraction=cfg.rope_fraction,
        kv_cache=kv_cache, cache_offset=cache_offset,
        p_dtype=getattr(torch, cfg.attn_p_dtype),
        attn_impl=cfg.attention_impl, kv_start=kv_start)
    x = x + h
    y_in = L.apply_norm(bp["ln2"], x, eps=cfg.norm_eps)
    if cfg.num_experts:
        y, aux = M.moe_layer(
            bp["moe"], y_in, top_k=cfg.experts_per_token,
            num_experts=cfg.num_experts,
            capacity_factor=cfg.moe_capacity_factor, with_aux=with_aux)
    else:
        y, aux = L.mlp(bp["mlp"], y_in), 0.0
    return x + y, new_cache, aux


def _run_dense_stack(cfg, blocks, x, positions, caches=None,
                     cache_offset=None, kv_start=None, with_aux=False):
    """Loop over the stacked layers (``blocks``' leading dim).  Returns (x,
    caches_or_None, aux): with ``with_aux`` the MoE layers' auxiliary losses
    summed in layer order (0.0 when dense), else None (the serving steps
    discard it)."""
    aux = 0.0
    train = caches is None and _requires_grad(blocks)
    layers = _stack_layers(blocks, train)
    block = _maybe_remat(cfg, _dense_block) if train else _dense_block
    for i, bp in enumerate(layers):
        cache = None if caches is None else tuple(_layer(c, i) for c in caches)
        x, _, a = block(cfg, bp, x, positions, kv_cache=cache,
                        cache_offset=cache_offset, kv_start=kv_start,
                        with_aux=with_aux)
        x = constrain(x, "hidden")
        if with_aux:
            aux = aux + a
    return x, caches, (aux if with_aux else None)


def _cross_block(cfg: ModelConfig, bp, x, cross_kv_pair):
    h, _ = L.attention(
        bp["cross"], L.apply_norm(bp["ln1"], x, eps=cfg.norm_eps),
        attn_dims(cfg), kv_override=cross_kv_pair,
        p_dtype=getattr(torch, cfg.attn_p_dtype))
    x = x + h
    y = L.mlp(bp["mlp"], L.apply_norm(bp["ln2"], x, eps=cfg.norm_eps))
    return x + y


def _cross_block_of(cfg: ModelConfig, bp, x, src):
    """:func:`_cross_block` projecting its K, V from ``src`` itself: in a
    training forward they are recomputed with the block, not kept a layer
    from the forward to the backward."""
    return _cross_block(cfg, bp, x, L.cross_kv(bp["cross"], src,
                                               attn_dims(cfg)))


def _vlm_cross_cache(cfg: ModelConfig, params, image_embeds):
    """Every unit's cross K, V of the image embeddings: each (U, B, N_img,
    KV, hd)."""
    src = image_embeds.to(getattr(torch, cfg.dtype))
    cross = params["units"]["cross"]
    per_unit = [L.cross_kv(_layer(cross, u)["cross"], src, attn_dims(cfg))
                for u in range(_units(cfg)[0])]
    return tuple(torch.stack(t) for t in zip(*per_unit))


def _run_vlm_stack(cfg, params, x, positions, cross_cache, caches=None,
                   cache_offset=None, kv_start=None, with_aux=False,
                   train=False):
    """Loop over the units: the unit's P - 1 self layers (cache leaves
    [u]), then its cross layer.  Returns (x, caches_or_None, aux) as
    :func:`_run_dense_stack`.  ``train``: ``cross_cache`` is the image
    source (see :func:`_cross_cache`), the units come by unbind and each
    cross layer is recomputed in the backward with its K, V."""
    units = params["units"]
    selfs = _stack_layers(units["selfs"], train)
    crosses = _stack_layers(units["cross"], train)
    if train:
        cross = _maybe_remat(cfg, _cross_block_of)
    else:
        ks, vs = cross_cache
    aux = 0.0
    for u in range(_units(cfg)[0]):
        cache = None if caches is None else tuple(_layer(c, u) for c in caches)
        x, _, a = _run_dense_stack(cfg, selfs[u], x, positions, cache,
                                   cache_offset, kv_start, with_aux)
        if with_aux:
            aux = aux + a
        if train:
            x = cross(cfg, crosses[u], x, cross_cache)
        else:
            x = _cross_block(cfg, crosses[u], x, (ks[u], vs[u]))
        x = constrain(x, "hidden")
    return x, caches, (aux if with_aux else None)


def _encoder_block(cfg: ModelConfig, bp, x):
    h, _ = L.attention(
        bp["attn"], L.apply_norm(bp["ln1"], x, eps=cfg.norm_eps),
        attn_dims(cfg), causal=False,
        p_dtype=getattr(torch, cfg.attn_p_dtype),
        attn_impl=cfg.attention_impl)
    x = x + h
    return x + L.mlp_gelu(bp["mlp"],
                          L.apply_norm(bp["ln2"], x, eps=cfg.norm_eps))


def _run_encoder(cfg: ModelConfig, params, encoder_embeds):
    """Whisper's encoder over ``encoder_embeds`` (B, enc_len, D), the
    conv frontend's stub output: non-causal self-attention (the chunked
    path, as in the reference) and the GELU MLP a layer, then the final
    norm.  A training forward takes the layers by unbind and recomputes
    each in the backward (``cfg.remat``), as the reference's."""
    x = encoder_embeds.to(getattr(torch, cfg.dtype))
    blocks = params["enc_blocks"]
    train = _requires_grad(blocks)
    block = _maybe_remat(cfg, _encoder_block) if train else _encoder_block
    for bp in _stack_layers(blocks, train):
        x = constrain(block(cfg, bp, x), "hidden")
    return L.apply_norm(params["enc_ln_f"], x, eps=cfg.norm_eps)


def _whisper_cross_cache(cfg: ModelConfig, params, enc):
    """Every decoder layer's cross K, V of the encoder output: each (L, B,
    enc_len, KV, hd)."""
    blocks = params["dec_blocks"]
    per_layer = [L.cross_kv(_layer(blocks, i)["cross"], enc, attn_dims(cfg))
                 for i in range(blocks["ln1"]["scale"].shape[0])]
    return tuple(torch.stack(t) for t in zip(*per_layer))


def _whisper_dec_block(cfg: ModelConfig, bp, x, positions, cross_kv_pair,
                       kv_cache=None, cache_offset=None, kv_start=None):
    p_dtype = getattr(torch, cfg.attn_p_dtype)
    h, _ = L.attention(
        bp["attn"], L.apply_norm(bp["ln1"], x, eps=cfg.norm_eps),
        attn_dims(cfg), positions=positions, kv_cache=kv_cache,
        cache_offset=cache_offset, p_dtype=p_dtype,
        attn_impl=cfg.attention_impl, kv_start=kv_start)
    x = x + h
    h, _ = L.attention(
        bp["cross"], L.apply_norm(bp["ln_x"], x, eps=cfg.norm_eps),
        attn_dims(cfg), kv_override=cross_kv_pair, p_dtype=p_dtype)
    x = x + h
    return x + L.mlp_gelu(bp["mlp"],
                          L.apply_norm(bp["ln2"], x, eps=cfg.norm_eps))


def _whisper_dec_block_of(cfg: ModelConfig, bp, x, positions, enc):
    """:func:`_whisper_dec_block` projecting its cross K, V from the
    encoder output itself (a training forward: see
    :func:`_cross_block_of`)."""
    return _whisper_dec_block(cfg, bp, x, positions,
                              L.cross_kv(bp["cross"], enc, attn_dims(cfg)))


def _run_whisper_decoder(cfg, params, x, positions, cross_cache, caches=None,
                         cache_offset=None, kv_start=None, with_aux=False,
                         train=False):
    """Loop over the decoder layers: causal self-attention (cache leaves
    [i]), cross-attention over layer i's encoder K, V, the GELU MLP.
    Returns (x, caches_or_None, aux) as :func:`_run_dense_stack` (aux 0.0:
    no MoE layer).  ``train``: ``cross_cache`` is the encoder output, the
    layers come by unbind and each is recomputed in the backward with its
    cross K, V."""
    layers = _stack_layers(params["dec_blocks"], train)
    if train:
        block = _maybe_remat(cfg, _whisper_dec_block_of)
        for bp in layers:
            x = constrain(block(cfg, bp, x, positions, cross_cache), "hidden")
        return x, caches, (0.0 if with_aux else None)
    ks, vs = cross_cache
    for i, bp in enumerate(layers):
        cache = None if caches is None else tuple(_layer(c, i) for c in caches)
        x = constrain(_whisper_dec_block(
            cfg, bp, x, positions, (ks[i], vs[i]), kv_cache=cache,
            cache_offset=cache_offset, kv_start=kv_start), "hidden")
    return x, caches, (0.0 if with_aux else None)


def _cross_cache(cfg: ModelConfig, params, batch, train: bool = False):
    """The cross K, V of the batch's extra inputs (vlm: the image
    embeddings; audio: the encoder's output over the frame embeddings), or
    None for the families without cross-attention.  ``train``: the source
    the cross layers project themselves (the image embeddings in the
    model's dtype; the encoder's output)."""
    if cfg.family == "vlm":
        if train:
            return batch["image_embeds"].to(getattr(torch, cfg.dtype))
        return _vlm_cross_cache(cfg, params, batch["image_embeds"])
    if cfg.family == "audio":
        enc = _run_encoder(cfg, params, batch["encoder_embeds"])
        return enc if train else _whisper_cross_cache(cfg, params, enc)
    return None


def _run_stack(cfg, params, x, positions, cross_cache=None, train=False,
               **kw):
    """The family's stack: (x, caches_or_None, aux).  ``train``: a
    training forward, whose ``cross_cache`` is :func:`_cross_cache`'s
    source (the dense stack tells by itself)."""
    if cfg.family == "vlm":
        return _run_vlm_stack(cfg, params, x, positions, cross_cache,
                              train=train, **kw)
    if cfg.family == "audio":
        return _run_whisper_decoder(cfg, params, x, positions, cross_cache,
                                    train=train, **kw)
    return _run_dense_stack(cfg, params["blocks"], x, positions, **kw)


def _lookup(table, tokens):
    return table.index_select(0, tokens.reshape(-1)).reshape(
        *tokens.shape, -1)


def _embed(cfg, params, tokens):
    table = params["embedding"]
    if isinstance(table, DTensor):
        rows = dops.embedding(table, tokens, _lookup)
    else:
        rows = _lookup(table, tokens)
    return constrain(rows.to(getattr(torch, cfg.dtype)), "hidden")


def unembed_weight(cfg: ModelConfig, params):
    """(d_model, vocab); for tied embeddings a transposed view, not a copy."""
    return params["embedding"].t() if cfg.tie_embeddings else params["lm_head"]


def _unembed(cfg, params, x):
    x = L.apply_norm(params["ln_f"], x, eps=cfg.norm_eps)
    return constrain(matmul(x, unembed_weight(cfg, params).to(x.dtype),
                            out_dtype=torch.float32), "logits")


def _positions(batch: int, seq: int, device, offset: int = 0):
    return offset + torch.arange(seq, dtype=torch.int32,
                                 device=device).expand(batch, seq)


def _add_pos_emb(cfg: ModelConfig, params, x, positions=None):
    """Audio: ``x`` plus the learned positions ``positions`` (B, S), each
    row's own for ragged rows.  Indices past the table clamp to its last
    row, as the reference's gather and ``dynamic_slice`` do.  None: 0 .. S
    - 1, the table's first S rows as a slice (the reference's training
    forward; its backward is a slice too, not an index accumulate)."""
    if cfg.family != "audio":
        return x
    table = params["pos_emb"]
    if positions is None:
        return x + table[:x.shape[1]][None].to(x.dtype)
    idx = positions.long().clamp(0, table.shape[0] - 1)
    return x + table[idx].to(x.dtype)


def _ragged_positions(seq: int, kv_start: torch.Tensor):
    """Per-row positions of a left-padded ragged batch: each row's first real
    token sits at position 0 (pad columns clamp to 0; they are masked)."""
    pos = (torch.arange(seq, dtype=torch.int32, device=kv_start.device)[None, :]
           - kv_start[:, None])
    return pos.clamp(min=0)


def forward_hidden(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """Training / scoring trunk -> (final hidden pre-norm (B, S, D),
    aux_loss: the MoE layers' summed, 0.0 without them)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    pos = _positions(b, s, tokens.device)
    x = _add_pos_emb(cfg, params, _embed(cfg, params, tokens))
    train = _requires_grad(params)
    x, _, aux = _run_stack(cfg, params, x, pos,
                           _cross_cache(cfg, params, batch, train),
                           with_aux=True, train=train)
    return x, aux


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """Scoring forward -> (logits f32 (B, S, V), aux_loss)."""
    x, aux = forward_hidden(cfg, params, batch)
    return _unembed(cfg, params, x), aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None):
    """Zeroed KV cache ``{"self": (K, V)}``, each (L, B, max_len, KV, hd);
    with ``cfg.kv_quant`` each of K and V is ``{"q": int8 (L, B, max_len,
    KV, hd), "s": f32 scales (L, B, max_len, KV)}``.  VLM: ``"self"`` leaves
    (U, P-1, B, max_len, KV, hd) and ``"cross"`` (U, B, N_img, KV, hd), both
    plain (as the reference, whatever ``kv_quant`` says).  Audio: ``"self"``
    as the dense family's and a plain ``"cross"`` (L, B, enc_len, KV, hd)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    kv = (cfg.num_kv_heads, cfg.resolved_head_dim)
    dev = resolve_device(device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.family == "vlm":
        units, per_unit = _units(cfg)
        return {"self": tuple(zeros(units, per_unit, batch, max_len, *kv)
                              for _ in range(2)),
                "cross": tuple(zeros(units, batch, cfg.num_image_tokens, *kv)
                               for _ in range(2))}
    shape = (cfg.num_layers, batch, max_len) + kv
    if cfg.kv_quant:
        out = {"self": tuple(
            {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
             "s": torch.zeros(shape[:-1], dtype=torch.float32, device=dev)}
            for _ in range(2))}
    else:
        out = {"self": (zeros(*shape), zeros(*shape))}
    if cfg.family == "audio":
        out["cross"] = tuple(zeros(cfg.num_layers, batch, cfg.encoder_len, *kv)
                             for _ in range(2))
    return out


def prefill(cfg: ModelConfig, params, batch, cache):
    """Run the prompt through the model, filling ``cache`` in place.
    Returns (last-token logits (B, V) f32, cache).

    ``batch["kv_start"]`` (optional (B,) int32) marks per-row left pad: pad
    columns are masked out of attention and positions restart at 0 at each
    row's first real token, so every row computes what it would alone.
    VLM: ``batch["image_embeds"]`` (B, N_img, D); audio:
    ``batch["encoder_embeds"]`` (B, enc_len, D).  The returned cache's
    ``"cross"`` holds their K, V (new tensors, not ``cache``'s)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    kv_start: Optional[torch.Tensor] = batch.get("kv_start")
    pos = (_positions(b, s, tokens.device) if kv_start is None
           else _ragged_positions(s, kv_start))
    x = _add_pos_emb(cfg, params, _embed(cfg, params, tokens), pos)
    cross = _cross_cache(cfg, params, batch)
    x, new_self, _ = _run_stack(cfg, params, x, pos, cross,
                                caches=cache["self"], cache_offset=0,
                                kv_start=kv_start)
    logits = _unembed(cfg, params, x[:, -1:, :])[:, 0]
    out = {"self": new_self}
    if cross is not None:
        out["cross"] = cross
    return logits, out


def decode_step(cfg: ModelConfig, params, tokens, cache, offset: int,
                kv_start: Optional[torch.Tensor] = None):
    """One token step.  tokens: (B, 1); ``offset`` (int) = current length.
    Returns (logits (B, V) f32, cache)."""
    b = tokens.shape[0]
    if kv_start is None:
        pos = torch.full((b, 1), offset, dtype=torch.int32, device=tokens.device)
    else:
        pos = (offset - kv_start).clamp(min=0).to(torch.int32)[:, None]
    x = _add_pos_emb(cfg, params, _embed(cfg, params, tokens), pos)
    x, new_self, _ = _run_stack(cfg, params, x, pos, cache.get("cross"),
                                caches=cache["self"], cache_offset=offset,
                                kv_start=kv_start)
    return _unembed(cfg, params, x)[:, 0], dict(cache, self=new_self)
