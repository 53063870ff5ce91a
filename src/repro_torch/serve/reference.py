"""Reference generation loops: the correctness oracle and the throughput
baseline.

``generate_per_prompt`` runs each prompt alone (batch 1, no padding, no
masking), so whatever it produces is by construction what a request
"should" get.  It syncs with the host once per token on purpose: the oracle
trades speed for the simplest possible trust chain.

``generate_per_token_sync`` (:class:`PerTokenSyncEngine`) is the seed
engine's execution model: batched, but with one host copy of the current
tokens per decoded token.  It is the baseline the fused engine's decode
rate is measured against.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.distributed import ctx as dctx
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import build_mesh
from repro_torch.models.model import Model
from repro_torch.profiling import annotate


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last dim; ties go to the first index (as jnp.argmax)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def generate_per_prompt(model: Model, params, prompts: List[List[int]],
                        max_new_tokens: int, max_len: int = 512,
                        eos_token: Optional[int] = None,
                        extra_inputs: Optional[Dict[str, torch.Tensor]] = None
                        ) -> List[List[int]]:
    """Greedy generation, one prompt at a time, on the params' device;
    prompt ``i`` takes row ``i`` of each ``extra_inputs`` array."""
    device = params["embedding"].device
    outs = []
    for i, prompt in enumerate(prompts):
        batch = {"tokens": torch.tensor([list(prompt)], dtype=torch.int32,
                                        device=device)}
        for name, arr in (extra_inputs or {}).items():
            batch[name] = arr[i:i + 1]
        cache = model.init_cache(1, max_len, device=device)
        with annotate("reference.prefill"):
            logits, cache = model.prefill(params, batch, cache)
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
            with annotate("reference.decode"):
                logits, cache = model.decode_step(params, cur[:, None],
                                                  cache, offset)
            offset += 1
            cur = greedy(logits)
        outs.append(toks)
    return outs


class PerTokenSyncEngine:
    """Batched greedy generation with a host copy per token (the seed
    engine's execution model; prompts must share one length: no ragged
    handling).  One ``init_cache(b, max_len)``, one batched prefill, then
    ``decode_step`` one token at a time, on the params' device.  Eager:
    the reference's ``jax.jit`` is a compile cache, not semantics.

    ``mesh=`` (a spec string or a ``DeviceMesh``) shards the params by the
    inference rules the fused engine uses (``rules_for_mesh(mesh,
    fsdp=False)``) and places and runs each model call with the fused
    engine's own helpers (``sharding.place_batch`` / ``place_cache``,
    ``ctx.on_mesh``), so the fused-vs-sync ratio compares the two
    execution models on one topology.  ``profile=True`` syncs the device
    after the prefill, so ``last_prefill_s`` / ``last_decode_s`` split the
    wall time."""

    def __init__(self, model: Model, params, max_len: int = 512,
                 eos_token: Optional[int] = None, profile: bool = False,
                 mesh=None):
        self.model = model
        self.max_len = max_len
        self.eos_token = eos_token
        self.profile = profile
        self.last_prefill_s = 0.0
        self.last_decode_s = 0.0
        self.device = params["embedding"].device
        if isinstance(mesh, str):
            mesh = build_mesh(mesh, device=self.device)
        self.mesh = mesh
        self.rules = None
        if mesh is not None:
            self.rules = sh.rules_for_mesh(mesh, fsdp=False)
            params = sh.shard_params(params, mesh, self.rules,
                                     model.template)
        self.params = params

    def generate(self, prompts: List[List[int]], max_new_tokens: int
                 ) -> List[List[int]]:
        plens = {len(p) for p in prompts}
        if len(plens) != 1:
            raise ValueError("per-token-sync baseline expects uniform prompt "
                             f"lengths, got {sorted(plens)}")
        (plen,) = plens
        b = len(prompts)
        with torch.no_grad():
            t0 = time.perf_counter()
            cache = sh.place_cache(self.mesh, self.rules,
                                   self.model.init_cache(b, self.max_len,
                                                         device=self.device))
            tokens = torch.tensor([list(p) for p in prompts],
                                  dtype=torch.int32, device=self.device)
            with dctx.on_mesh(self.mesh, self.rules), \
                    annotate("reference.prefill"):
                logits, cache = self.model.prefill(
                    self.params,
                    sh.place_batch(self.mesh, self.rules, {"tokens": tokens}),
                    cache)
                logits = sh.full(logits)
            if self.profile and logits.is_cuda:
                # deliberate sync: the prefill/decode wall-time split is
                # the whole point of profile mode
                # analysis: allow(TP001)
                torch.cuda.synchronize(logits.device)
            t1 = time.perf_counter()
            offset = plen
            cur = greedy(logits)
            outs: List[List[int]] = [[] for _ in range(b)]
            done = np.zeros(b, bool)
            for step in range(max_new_tokens):
                # the per-token copy IS this baseline's execution model: the
                # cost the fused engine's decode rate is measured against
                cur_np = cur.cpu().numpy()   # analysis: allow(TP001)
                for i in range(b):
                    if not done[i]:
                        outs[i].append(int(cur_np[i]))
                        if (self.eos_token is not None
                                and cur_np[i] == self.eos_token):
                            done[i] = True
                if done.all() or step == max_new_tokens - 1:
                    break
                with dctx.on_mesh(self.mesh, self.rules), \
                        annotate("reference.decode"):
                    logits, cache = self.model.decode_step(
                        self.params,
                        sh.place_batch(self.mesh, self.rules, cur[:, None]),
                        cache, offset)
                    logits = sh.full(logits)
                offset += 1
                cur = greedy(logits)
        self.last_prefill_s = t1 - t0
        self.last_decode_s = time.perf_counter() - t1
        return outs


def generate_per_token_sync(model: Model, params, prompts: List[List[int]],
                            max_new_tokens: int, max_len: int = 512,
                            eos_token: Optional[int] = None
                            ) -> List[List[int]]:
    """One-shot convenience wrapper around :class:`PerTokenSyncEngine`."""
    return PerTokenSyncEngine(model, params, max_len, eos_token
                              ).generate(prompts, max_new_tokens)
