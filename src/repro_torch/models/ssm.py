"""Mamba2 (SSD, state-space duality) block, chunked matmul formulation.

The SSD decomposition (arXiv:2405.21060) recasts the selective-SSM
recurrence as block matrix products: dense intra-chunk contractions plus a
small inter-chunk recurrence.  ``in_proj`` and ``out_proj`` go through
``core.matmul`` (the GEMM kernel on the card); the SSD contractions are
plain f32 products through ``core.einsum``, as they are XLA dots in the
reference.

Convention (h = state, per head):
    h_s = exp(dt_s * A) * h_{s-1} + dt_s * B_s * x_s ;   y_l = C_l . h_l + D x_l
n_groups = 1 (B, C shared across heads), as in the released Mamba2 models.

A decode step updates its state in place: the tensors passed in are the
ones returned, as the attention's KV cache is.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.core import einsum, matmul
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.distributed import ops as dops
from repro_torch.models.params import ParamSpec


def ssm_dims(cfg: ModelConfig):
    d_inner = cfg.d_inner
    n_heads = cfg.ssm_heads
    conv_dim = d_inner + 2 * cfg.ssm_state
    d_in_proj = 2 * d_inner + 2 * cfg.ssm_state + n_heads
    return d_inner, n_heads, conv_dim, d_in_proj


def ssm_template(cfg: ModelConfig):
    d_inner, n_heads, conv_dim, d_in_proj = ssm_dims(cfg)
    return {
        "in_proj": ParamSpec((cfg.d_model, d_in_proj), ("embed", "ff")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), (None, "ff"), scale=0.5),
        "conv_b": ParamSpec((conv_dim,), ("ff",), init="zeros"),
        "A_log": ParamSpec((n_heads,), (None,), init="zeros"),
        "D": ParamSpec((n_heads,), (None,), init="ones"),
        "dt_bias": ParamSpec((n_heads,), (None,), init="zeros"),
        "norm": ParamSpec((d_inner,), ("ff",), init="ones"),
        "out_proj": ParamSpec((d_inner, cfg.d_model), ("ff", "embed")),
    }


def _split_zxbcdt(cfg: ModelConfig, zxbcdt):
    d_inner, _, _, _ = ssm_dims(cfg)
    n = cfg.ssm_state
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
    dt = zxbcdt[..., 2 * d_inner + 2 * n:]
    return z, xBC, dt


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, the same formula."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _gated_norm(scale, y, z, eps):
    yf = y.float() * F.silu(z.float())
    var = (yf * yf).mean(-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale).to(y.dtype)


def _causal_conv(params, xBC, cfg: ModelConfig):
    """Depthwise causal conv over the sequence: xBC (B, S, C).  The K
    products are summed in the reference's order."""
    k = cfg.ssm_conv
    s = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    w = params["conv_w"]
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(out + params["conv_b"])


def _chunk_len(s: int, chunk: int) -> int:
    """The largest divisor of ``s`` not above ``chunk``: any sequence length
    is exact (S = 300 at chunk 128 gives 100; a prime S above the chunk
    gives 1)."""
    length = min(chunk, s)
    while s % length:
        length -= 1
    return length


def _intra_chunk_decay(seg, causal):
    """``exp(seg)`` on and below the diagonal, 0 above it: the reference's
    ``where(causal, exp(seg), 0)``, bit for bit, with ``seg`` masked before
    the exp.  Above the diagonal ``seg`` is a positive sum of ``dt * |A|``
    that can overflow exp to inf (past 88.7 in f32; a full-width chunk of
    128 reaches it), and exp's backward multiplies the zero gradient there
    by it: NaN, even where a ``where`` drops the inf in the forward."""
    return torch.exp(seg.masked_fill(~causal, float("-inf")))


def ssm_block(params, x: torch.Tensor, cfg: ModelConfig,
              return_state: bool = False, valid_mask=None):
    """Full-sequence SSD forward.  x: (B, S, D).

    ``return_state=True`` also returns the recurrent state after the last
    position, ``{"conv", "ssm"}``, so prefill hands off to the single-token
    decode path exactly.

    ``valid_mask`` (B, S) bool marks real tokens in a left-padded ragged
    batch.  Pad columns are zeroed both before the conv (early real tokens
    see the zero left context a lone prompt would) and after it (pad
    positions add nothing to the state, so the state entering the first
    real token is exactly the zero init).
    """
    zxbcdt = matmul(x, params["in_proj"])
    inner = [params[name] for name in _INNER]
    if isinstance(zxbcdt, DTensor):
        # the projection's columns are z | xBC | dt, which a split over
        # the tensor axis cuts across: the SSD runs on each rank's batch
        # rows, whole, between the sharded in_proj and out_proj
        res = dops.batch_local(
            lambda zl, vl, *pl: _ssd(cfg, zl, vl, pl, return_state),
            [zxbcdt, valid_mask, *inner], [0, 0] + [None] * len(inner),
            (0, {"conv": 0, "ssm": 0}) if return_state else 0)
    else:
        res = _ssd(cfg, zxbcdt, valid_mask, inner, return_state)
    y, state = res if return_state else (res, None)
    out = matmul(y, params["out_proj"])
    return (out, state) if return_state else out


#: the SSM params the SSD reads between in_proj and out_proj
_INNER = ("conv_w", "conv_b", "dt_bias", "A_log", "D", "norm")


def _ssd(cfg: ModelConfig, zxbcdt, valid_mask, inner, return_state: bool):
    """The SSD between the projections: the conv, the chunked scan and the
    gated norm.  -> y (B, S, d_inner) (and the state with
    ``return_state``)."""
    params = dict(zip(_INNER, inner))
    b, s, _ = zxbcdt.shape
    d_inner, n_heads, _, _ = ssm_dims(cfg)
    p = cfg.ssm_head_dim
    n = cfg.ssm_state
    k = cfg.ssm_conv
    l = _chunk_len(s, cfg.ssm_chunk)  # noqa: E741
    nc = s // l
    dtype = zxbcdt.dtype

    z, xBC, dt = _split_zxbcdt(cfg, zxbcdt)
    if valid_mask is not None:
        xBC = torch.where(valid_mask[..., None], xBC, 0)
    xBC_pre = xBC
    xBC = _causal_conv(params, xBC, cfg)
    xs, bs, cs = (xBC[..., :d_inner], xBC[..., d_inner:d_inner + n],
                  xBC[..., d_inner + n:])
    if valid_mask is not None:
        xs = torch.where(valid_mask[..., None], xs, 0)

    dt = _softplus(dt.float() + params["dt_bias"])                     # (B,S,H)
    a = -torch.exp(params["A_log"].float())                            # (H,)

    xc = xs.reshape(b, nc, l, n_heads, p).float()
    bc = bs.reshape(b, nc, l, n).float()
    cc = cs.reshape(b, nc, l, n).float()
    dtc = dt.reshape(b, nc, l, n_heads)

    da = dtc * a                                                       # (B,nc,L,H)
    cum = torch.cumsum(da, dim=2)

    # --- intra-chunk (the dense part of SSD) ---------------------------
    cb = einsum("bcln,bcsn->bcls", cc, bc)                             # (B,nc,L,L)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]                # (B,nc,L,S,H)
    causal = torch.ones(l, l, dtype=torch.bool, device=zxbcdt.device).tril()
    decay = _intra_chunk_decay(seg, causal[None, None, :, :, None])
    scores = cb[..., None] * decay * dtc[:, :, None, :, :]             # (B,nc,L,S,H)
    y_diag = einsum("bclsh,bcshp->bclhp", scores, xc)

    # --- chunk boundary states -----------------------------------------
    state_decay = torch.exp(cum[:, :, -1:, :] - cum)                   # (B,nc,L,H)
    states = einsum("bcln,bclh,bclhp->bchnp", bc, dtc * state_decay, xc)

    # --- inter-chunk recurrence ----------------------------------------
    # The reference's associative scan over chunks computes the same
    # recurrence, inc_c = inc_{c-1} * decay_c + states_c, in another order.
    chunk_decay = torch.exp(cum[:, :, -1, :])                          # (B,nc,H)
    incs = [states[:, 0]]
    for c in range(1, nc):
        incs.append(incs[-1] * chunk_decay[:, c, :, None, None] + states[:, c])
    inc = torch.stack(incs, dim=1)                                     # (B,nc,H,N,P)
    prev = torch.cat([torch.zeros_like(inc[:, :1]), inc[:, :-1]], dim=1)

    y_off = einsum("bcln,bchnp,bclh->bclhp", cc, prev, torch.exp(cum))
    y = (y_diag + y_off).reshape(b, s, n_heads, p)
    y = y + (params["D"].float()[None, None, :, None]
             * xs.reshape(b, s, n_heads, p).float())

    y = _gated_norm(params["norm"], y.reshape(b, s, d_inner).to(dtype), z,
                    cfg.norm_eps)
    if not return_state:
        return y
    conv = xBC_pre[:, max(s - (k - 1), 0):, :]      # last K-1 pre-conv inputs
    if conv.shape[1] < k - 1:
        # a prompt shorter than K-1: its left context is zeros
        conv = F.pad(conv, (0, 0, k - 1 - conv.shape[1], 0))
    # copies, so that the state does not keep the whole (B, S, C) input
    # and (B, nc, H, N, P) chunk states alive while later layers run
    return y, {"conv": conv.contiguous(),
               "ssm": inc[:, -1].contiguous()}      # state after position S


def ssm_state_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device: DeviceLike = None):
    """Zero state: the conv window (B, K-1, conv_dim) in ``dtype``, the SSM
    state (B, H, N, P) in f32."""
    d_inner, n_heads, conv_dim, _ = ssm_dims(cfg)
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                            device=dev),
        "ssm": torch.zeros((batch, n_heads, cfg.ssm_state, cfg.ssm_head_dim),
                           dtype=torch.float32, device=dev),
    }


def ssm_decode_step(params, x: torch.Tensor, state, cfg: ModelConfig):
    """Single-token recurrent step.  x: (B, 1, D) -> (y (B, 1, D), state),
    ``state``'s tensors updated in place."""
    zxbcdt = matmul(x[:, 0], params["in_proj"])
    inner = [params[name] for name in _INNER]
    conv, ssm = state["conv"], state["ssm"]
    if isinstance(zxbcdt, DTensor):
        # on each rank's batch rows, whole (see ssm_block); the states it
        # updates are copies where the cache splits channels or heads over
        # the tensor axis, so they are written back
        y, new_conv, new_ssm = dops.batch_local(
            lambda zl, cl, sl, *pl: _step(cfg, zl, cl, sl, pl),
            [zxbcdt, conv, ssm, *inner], [0, 0, 0] + [None] * len(inner),
            (0, 0, 0))
        for dst, src in ((conv, new_conv), (ssm, new_ssm)):
            dst.to_local().copy_(src.redistribute(
                dst.device_mesh, dst.placements).to_local())
    else:
        y, _, _ = _step(cfg, zxbcdt, conv, ssm, inner)
    out = matmul(y, params["out_proj"])[:, None, :]
    return out, state


def _step(cfg: ModelConfig, zxbcdt, conv, ssm, inner):
    """The decode step between the projections, ``conv`` and ``ssm``
    updated in place.  -> (y (B, d_inner), conv, ssm)."""
    params = dict(zip(_INNER, inner))
    b = zxbcdt.shape[0]
    d_inner, n_heads, _, _ = ssm_dims(cfg)
    p, n = cfg.ssm_head_dim, cfg.ssm_state
    z, xBC, dt = _split_zxbcdt(cfg, zxbcdt)
    window = torch.cat([conv, xBC[:, None, :].to(conv.dtype)], dim=1)  # (B,K,C)
    conv_out = F.silu((window * params["conv_w"][None]).sum(1)
                      + params["conv_b"])
    conv.copy_(window[:, 1:])

    xs, bs, cs = (conv_out[..., :d_inner], conv_out[..., d_inner:d_inner + n],
                  conv_out[..., d_inner + n:])
    dt = _softplus(dt.float() + params["dt_bias"])                     # (B,H)
    a = -torch.exp(params["A_log"].float())
    da = torch.exp(dt * a)                                             # (B,H)

    xh = xs.reshape(b, n_heads, p).float()
    ssm.mul_(da[..., None, None]).add_(
        einsum("bn,bh,bhp->bhnp", bs.float(), dt, xh))
    y = einsum("bn,bhnp->bhp", cs.float(), ssm)
    y = y + params["D"].float()[None, :, None] * xh

    y = _gated_norm(params["norm"], y.reshape(b, d_inner).to(zxbcdt.dtype),
                    z, cfg.norm_eps)
    return y, conv, ssm
