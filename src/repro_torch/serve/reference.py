"""Reference generation loop: the correctness oracle.

``generate_per_prompt`` runs each prompt alone (batch 1, no padding, no
masking), so whatever it produces is by construction what a request
"should" get.  It syncs with the host once per token on purpose: the oracle
trades speed for the simplest possible trust chain.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.models.model import Model


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last dim; ties go to the first index (as jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def generate_per_prompt(model: Model, params, prompts: List[List[int]],
                        max_new_tokens: int, max_len: int = 512,
                        eos_token: Optional[int] = None) -> List[List[int]]:
    """Greedy generation, one prompt at a time, on the params' device."""
    device = params["embedding"].device
    outs = []
    for prompt in prompts:
        tokens = torch.tensor([list(prompt)], dtype=torch.int32, device=device)
        cache = model.init_cache(1, max_len, device=device)
        logits, cache = model.prefill(params, {"tokens": tokens}, cache)
        offset = len(prompt)
        cur = greedy(logits)
        toks: List[int] = []
        for _ in range(max_new_tokens):
            t = int(cur[0])
            toks.append(t)
            if eos_token is not None and t == eos_token:
                break
            if len(toks) == max_new_tokens:
                break
            logits, cache = model.decode_step(params, cur[:, None], cache,
                                              offset)
            offset += 1
            cur = greedy(logits)
        outs.append(toks)
    return outs
