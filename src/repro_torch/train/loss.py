"""Cross-entropy loss with a token-chunked unembedding.

``chunked_ce`` runs the unembed GEMM and the CE over sequence chunks, each
recomputed in the backward (``torch.utils.checkpoint``), so the f32 logits
of one (B, chunk, V) block are live at a time; ``chunk=0`` is one pass over
the whole (B, S, V).  The unembed is ``core.matmul`` with an f32 result, as
the reference's, so its backward products run on f32 operands.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch.core import matmul
from repro_torch.distributed import ops as dops
from repro_torch.distributed.ctx import constrain

Z_LOSS_WEIGHT = 1e-4
MOE_AUX_WEIGHT = 1e-2


def _lse_picked(logits, labels):
    """(log-partition, the label's logit), each (B, C)."""
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse, picked


def _ce_block(x, w, labels):
    """x: (B, C, D) final-normed hidden; w: (D, V); labels: (B, C).
    -> (sum of CE, sum of squared log-partition).  On a mesh each rank
    reads its batch rows' logits over the whole vocab."""
    logits = constrain(matmul(x, w.to(x.dtype), out_dtype=torch.float32),
                       "logits")
    if isinstance(logits, DTensor):
        lse, picked = dops.batch_local(_lse_picked, [logits, labels], [0, 0],
                                       (0, 0))
    else:
        lse, picked = _lse_picked(logits, labels)
    return (lse - picked).sum(), lse.square().sum()


def chunked_ce(x, w, labels, *, chunk: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (sum CE over tokens, sum z-loss).  ``chunk`` <= 0, or one that
    does not divide S (or S <= chunk): a single pass."""
    s = x.shape[1]
    if chunk <= 0 or s <= chunk or s % chunk != 0:
        return _ce_block(x, w, labels)
    ce = z = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, chunk):
        c, zc = checkpoint(_ce_block, x[:, i:i + chunk], w,
                           labels[:, i:i + chunk], use_reentrant=False)
        ce, z = ce + c, z + zc
    return ce, z


def lm_loss(model, params, batch, *, logit_chunk: Optional[int] = None):
    """Next-token LM loss.  batch["tokens"], batch["labels"]: (B, S).

    -> (loss scalar, metrics dict)."""
    hidden, aux = model.forward_hidden(params, batch)
    hidden = model.final_norm(params, hidden)
    w = model.unembed_weight(params)
    chunk = model.cfg.logit_chunk if logit_chunk is None else logit_chunk
    ce_sum, z_sum = chunked_ce(hidden, w, batch["labels"], chunk=chunk)
    ntok = batch["labels"].numel()
    ce = ce_sum / ntok
    z = z_sum / ntok
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    loss = ce + Z_LOSS_WEIGHT * z + MOE_AUX_WEIGHT * aux
    return loss, {"ce": ce, "z_loss": z, "moe_aux": aux,
                  "perplexity": torch.exp(ce)}
