"""The dense family: a gated SiLU MLP after attention, in each layer
(``x + attn(norm1(x))``, then ``+ mlp(norm2(x))``)."""
from __future__ import annotations

import torch.nn.functional as F

from reference import common


def ffn(cfg, lw, h, quant, i=None):
    g = F.silu(common.mm(h, lw["mlp/w_gate"], quant))
    u = common.mm(h, lw["mlp/w_up"], quant)
    return common.mm(g * u, lw["mlp/w_down"], quant)


def logits(cfg: dict, weights, prompt, served, plen: int, quant=None):
    """f32 logits at the position of each served token: the last prompt
    position, then each served token's but the last.  A dense layer works
    token by token, so the admission's padded length ``plen`` changes
    nothing here."""
    return common.forward(cfg, weights, *common.sequence(weights, prompt,
                                                         served), ffn, quant)
