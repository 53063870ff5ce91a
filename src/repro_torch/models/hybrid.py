"""Pure-SSM (Mamba2) and hybrid (Zamba2-style) language models.

Zamba2 topology: units of ``attn_period`` Mamba2 blocks, with ONE
shared-weight attention block applied at the start of every unit (weights
shared across applications, a KV cache per application, so the ``"self"``
leaves carry a leading unit dim).

Layer params are stacked on leading dims as in the reference (``blocks``
(L, ...); ``units`` (U, P, ...)) and the stacks run as Python loops where
the reference uses ``lax.scan``.  Caches: ``{"ssm": {"conv", "ssm"}}``
with leaves (L, B, ...) for the ssm family, (U, P, B, ...) for the hybrid,
which adds ``"self"`` (K, V), each (U, B, S, KV, hd).  The SSM state's
batch dim sits at -4, the conv window's at -3, the K/V's at -4: the serve
engine indexes every leaf from the end.

Prefill returns new state tensors (cast to the given cache's dtypes, as
the reference does) and writes the K/V in place; a decode step updates
every cache leaf in place.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.distributed.ctx import constrain
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.params import map_tree

# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------


def mamba_lm_template(cfg: ModelConfig):
    return dict(T.embed_template(cfg),
                blocks=T._stack_template(_mamba_block_template(cfg),
                                         cfg.num_layers))


def _mamba_block_template(cfg: ModelConfig):
    return {"ln": L.norm_template(cfg.d_model, cfg.norm),
            "ssm": S.ssm_template(cfg)}


def _units(cfg: ModelConfig) -> int:
    return cfg.num_layers // cfg.attn_period


def zamba_template(cfg: ModelConfig):
    return dict(
        T.embed_template(cfg),
        shared_attn={   # ONE copy, applied at every unit boundary
            "ln1": L.norm_template(cfg.d_model, cfg.norm),
            "attn": L.attention_template(cfg.d_model, T.attn_dims(cfg)),
            "ln2": L.norm_template(cfg.d_model, cfg.norm),
            "mlp": L.mlp_template(cfg.d_model, cfg.d_ff),
        },
        units=T._stack_template(
            T._stack_template(_mamba_block_template(cfg), cfg.attn_period),
            _units(cfg)))


def template(cfg: ModelConfig):
    return zamba_template(cfg) if cfg.family == "hybrid" else mamba_lm_template(cfg)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _mamba_block(cfg, bp, x):
    return constrain(x + S.ssm_block(
        bp["ssm"], L.apply_norm(bp["ln"], x, eps=cfg.norm_eps), cfg), "hidden")


def _mamba_block_prefill(cfg, bp, x, valid=None):
    y, state = S.ssm_block(bp["ssm"], L.apply_norm(bp["ln"], x, eps=cfg.norm_eps),
                           cfg, return_state=True, valid_mask=valid)
    return constrain(x + y, "hidden"), state


def _mamba_block_step(cfg, bp, x, state):
    y, _ = S.ssm_decode_step(
        bp["ssm"], L.apply_norm(bp["ln"], x, eps=cfg.norm_eps), state, cfg)
    return x + y


def _shared_attn_apply(cfg, sp, x, positions, kv_cache=None, cache_offset=None,
                       kv_start=None):
    h, _ = L.attention(
        sp["attn"], L.apply_norm(sp["ln1"], x, eps=cfg.norm_eps),
        T.attn_dims(cfg), positions=positions,
        rope_theta=cfg.rope_theta if cfg.use_rope else 0.0,
        kv_cache=kv_cache, cache_offset=cache_offset,
        p_dtype=getattr(torch, cfg.attn_p_dtype),
        attn_impl=cfg.attention_impl, kv_start=kv_start)
    x = x + h
    return constrain(
        x + L.mlp(sp["mlp"], L.apply_norm(sp["ln2"], x, eps=cfg.norm_eps)),
        "hidden")


def _stacks(cfg, params, train: bool = False):
    """(layer params, index of its state in the cache's leading dims) of
    every Mamba2 layer in order: (layer,) for the ssm family, (unit,
    layer) for the hybrid.  ``train``: the layers come from one ``unbind``
    per leaf (``T._unbound_layers``), not a select each."""
    if cfg.family == "ssm":
        blocks = params["blocks"]
        idx = [(i,) for i in range(cfg.num_layers)]
    else:
        blocks = map_tree(lambda _p, x: x.flatten(0, 1), params["units"])
        idx = [(u, i) for u in range(_units(cfg))
               for i in range(cfg.attn_period)]
    if train:
        return list(zip(T._unbound_layers(blocks), idx))
    return [(T._layer(blocks, j), ix) for j, ix in enumerate(idx)]


def _state_at(states, idx):
    return {k: v[idx] for k, v in states.items()}


# ---------------------------------------------------------------------------
# Forward (scoring)
# ---------------------------------------------------------------------------

def forward_hidden(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """Training / scoring trunk -> (final hidden pre-norm (B, S, D), 0.0).

    A training forward (params under grad) takes the layers by unbind and,
    with ``cfg.remat``, recomputes each Mamba2 layer and each application
    of the shared block in the backward.  The reference remats each whole
    unit of the hybrid; the math is the same at any granularity, and one
    Mamba2 layer's SSD intermediates are the most a backward holds here.
    The shared block's gradient sums over its applications."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = T._embed(cfg, params, tokens)
    pos = T._positions(b, s, tokens.device)
    train = T._requires_grad(params)
    mamba, shared = _mamba_block, _shared_attn_apply
    if train:
        mamba = T._maybe_remat(cfg, mamba)
        shared = T._maybe_remat(cfg, shared)
    for bp, idx in _stacks(cfg, params, train):
        if cfg.family == "hybrid" and idx[1] == 0:
            x = shared(cfg, params["shared_attn"], x, pos)
        x = mamba(cfg, bp, x)
    return x, 0.0


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """Scoring forward -> (logits f32 (B, S, V), aux_loss 0.0)."""
    x, aux = forward_hidden(cfg, params, batch)
    return T._unembed(cfg, params, x), aux


# ---------------------------------------------------------------------------
# Decode (recurrent states; the hybrid adds the shared block's KV per unit)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: DeviceLike = None):
    """Zero states ``{"ssm": {"conv", "ssm"}}``: conv windows (L, B, K-1,
    conv_dim) in ``dtype``, SSM states (L, B, H, N, P) in f32; the hybrid's
    lead with (U, P) instead of (L,) and add ``"self"``: K, V (U, B,
    max_len, KV, hd)."""
    dtype = dtype or getattr(torch, cfg.dtype)
    dev = resolve_device(device)
    lead = ((cfg.num_layers,) if cfg.family == "ssm"
            else (_units(cfg), cfg.attn_period))
    states = S.ssm_state_init(cfg, batch, dtype, dev)
    cache = {"ssm": {k: torch.zeros(lead + v.shape, dtype=v.dtype, device=dev)
                     for k, v in states.items()}}
    if cfg.family == "hybrid":
        kv = (_units(cfg), batch, max_len, cfg.num_kv_heads,
              cfg.resolved_head_dim)
        cache["self"] = tuple(torch.zeros(kv, dtype=dtype, device=dev)
                              for _ in range(2))
    return cache


def _stack_states(cfg, per_layer, old):
    """Stack each layer's new state leaves to the cache layout, in the
    dtypes of ``old`` (the given cache's ``"ssm"`` tree) when there is one."""
    out = {}
    for k in per_layer[0]:
        leaf = torch.stack([st[k] for st in per_layer])
        if cfg.family == "hybrid":
            leaf = leaf.unflatten(0, (_units(cfg), cfg.attn_period))
        out[k] = leaf if old is None else leaf.to(old[k].dtype)
    return out


def prefill(cfg: ModelConfig, params, batch, cache):
    """Run the prompt, returning (last-token logits (B, V) f32, cache).

    ``batch["kv_start"]`` (optional (B,) int32) marks per-row left pad: pad
    columns are zeroed inside every SSM block (see ``ssm_block``) and
    masked out of the shared attention, so each row computes what it would
    alone.  ``cache`` needs only the hybrid's ``"self"`` leaves, written in
    place; the returned ``"ssm"`` tree is new, in the dtypes of
    ``cache["ssm"]`` when given (else the conv window in the model's dtype
    and the SSM state in f32, as ``init_cache`` makes them)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    kv_start: Optional[torch.Tensor] = batch.get("kv_start")
    x = T._embed(cfg, params, tokens)
    pos = (T._positions(b, s, tokens.device) if kv_start is None
           else T._ragged_positions(s, kv_start))
    valid = None if kv_start is None else (
        torch.arange(s, dtype=torch.int32, device=tokens.device)[None, :]
        >= kv_start[:, None])
    per_layer = []
    for bp, idx in _stacks(cfg, params):
        if cfg.family == "hybrid" and idx[1] == 0:
            u = idx[0]
            x = _shared_attn_apply(
                cfg, params["shared_attn"], x, pos,
                kv_cache=tuple(c[u] for c in cache["self"]), cache_offset=0,
                kv_start=kv_start)
        x, state = _mamba_block_prefill(cfg, bp, x, valid=valid)
        per_layer.append(state)
    logits = T._unembed(cfg, params, x[:, -1:, :])[:, 0]
    out = {"ssm": _stack_states(cfg, per_layer, cache.get("ssm"))}
    if cfg.family == "hybrid":
        out["self"] = cache["self"]
    return logits, out


def decode_step(cfg: ModelConfig, params, tokens, cache, offset: int,
                kv_start: Optional[torch.Tensor] = None):
    """One token step.  tokens: (B, 1); ``offset`` (int) = current length.
    Returns (logits (B, V) f32, cache), every leaf updated in place.  The
    hybrid's positions restart at each row's first real token (clamped at
    0, as the reference's)."""
    b = tokens.shape[0]
    x = T._embed(cfg, params, tokens)
    if kv_start is None:
        pos = torch.full((b, 1), offset, dtype=torch.int32, device=tokens.device)
    else:
        pos = (offset - kv_start).clamp(min=0).to(torch.int32)[:, None]
    for bp, idx in _stacks(cfg, params):
        if cfg.family == "hybrid" and idx[1] == 0:
            u = idx[0]
            x = _shared_attn_apply(
                cfg, params["shared_attn"], x, pos,
                kv_cache=tuple(c[u] for c in cache["self"]),
                cache_offset=offset, kv_start=kv_start)
        x = _mamba_block_step(cfg, bp, x, _state_at(cache["ssm"], idx))
    return T._unembed(cfg, params, x)[:, 0], cache

