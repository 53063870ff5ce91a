"""Continuous-batching serve engine over a paged KV cache.

Requests are admitted into a fixed pool of ``max_batch`` slots; KV memory is
a pool of pages measured in tokens (host bookkeeping in
:mod:`repro_torch.serve.kv_pages`).  The loop body is one *chunk boundary*:
admit every queue-head request that fits (one batched ragged prefill),
grow live block tables for the next chunk (preempting the youngest rows if
the pool runs dry), run one decode chunk, then evict the rows that finished.

* **Decode chunk** — gather every live row's KV into a dense right-aligned
  view, run ``decode_chunk`` greedy steps, scatter the chunk's new KV
  columns back to their pages.  The model never sees a page table.
* **One host transfer per chunk** — the reference ends its ``while_loop``
  early once every row is done; reading that flag here would be a host
  sync per token.  So the chunk always runs its steps, with finished rows
  masked exactly as the reference's loop body masks them (``buf``,
  ``lens``, ``done``).  Steps past the point where every row is done only
  write KV that nothing reads (TRASH pages, or pages of rows that are
  evicted at this boundary) and advance a ``cur`` no live row carries, so
  the tokens are the same.  The chunk's token buffer and counts reach the
  host in one copy.
* **Ragged batches** — prompts are right-aligned (left-padded); the per-slot
  pad offset ``kv_start`` masks pad columns and restarts positions at each
  row's first real token, so each row decodes what it would decode alone.
  Prompt lengths are bucketed to powers of two (min 8).

Greedy decoding only; the wave scheduler, the prefix cache, sampling,
streaming and the threaded server come in later slices (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.device import resolve_device
from repro_torch.kernels.paged import paged_gather, paged_scatter
from repro_torch.models.model import Model
from repro_torch.serve import api, kv_pages
from repro_torch.serve.reference import greedy

_PLEN_BUCKET_MIN = 8
#: tokens per page when ServeConfig.page_size is None (the reference
#: registry's default paged_attn entry)
DEFAULT_PAGE_SIZE = 16
#: per-request latency records kept for percentile stats
_LATENCY_WINDOW = 4096


def _percentiles(xs: List[float]) -> Dict[str, Optional[float]]:
    if not xs:
        return {"p50": None, "p95": None, "p99": None}
    q = np.percentile(np.asarray(xs, np.float64), [50.0, 95.0, 99.0])
    return {"p50": float(q[0]), "p95": float(q[1]), "p99": float(q[2])}


def _bucket_len(n: int) -> int:
    """Smallest power-of-two bucket >= ``n`` (min 8)."""
    b = _PLEN_BUCKET_MIN
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8                # KV-cache slots
    max_len: int = 512                # per-slot capacity (prompt + new)
    temperature: float = 0.0          # only 0 (greedy) in this slice
    eos_token: Optional[int] = None
    profile: bool = False             # synchronize after prefill to split timings
    page_size: Optional[int] = None   # tokens per KV page; None -> 16
    # Paged-pool capacity in TOKENS; None = max_batch * max_len.
    capacity_tokens: Optional[int] = None
    # Tokens decoded per chunk between scheduling boundaries.  Power of two.
    decode_chunk: int = 8
    prefix_cache: bool = False        # only False in this slice
    device: Optional[str] = None      # None -> the card ("cuda")


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_new: int
    handle: api.RequestHandle
    slot: Optional[int] = None
    tokens: Optional[List[int]] = None
    result: Optional[api.GenerationResult] = None
    t_submit: float = 0.0
    t_first: Optional[float] = None   # first token host-visible (TTFT end)


class Engine:
    """Continuous-batching engine over a fixed slot pool and a paged KV pool.

    ``generate`` is the batched entry point; ``submit``/``run`` expose the
    request queue.  Runs on ``ServeConfig.device`` (default: the card); the
    params must already live there.
    """

    def __init__(self, model: Model, params, cfg: ServeConfig):
        self.device = resolve_device(cfg.device)
        if cfg.temperature != 0.0:
            raise NotImplementedError(
                "temperature > 0: only greedy decoding is ported "
                "(sampling: ROADMAP.md queue 1, item 5)")
        if cfg.prefix_cache:
            raise NotImplementedError(
                "prefix_cache=True: not ported yet (ROADMAP.md queue 1, item 5)")
        chunk = int(cfg.decode_chunk)
        if chunk < 1 or chunk & (chunk - 1):
            raise ValueError(
                f"decode_chunk must be a power of two >= 1, got {chunk}")
        pdev = params["embedding"].device
        if pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, the engine runs on "
                             f"{self.device}")
        self.model = model
        self.params = params
        self.cfg = cfg
        self._chunk = chunk
        self._capacity_tokens = int(cfg.capacity_tokens
                                    or cfg.max_batch * cfg.max_len)
        self._page_size = min(max(int(cfg.page_size or DEFAULT_PAGE_SIZE), 1),
                              self._capacity_tokens)
        self._queue: List[_Request] = []
        self._next_rid = 0
        self._alloc: Optional[kv_pages.PageAllocator] = None
        self._csched: Optional[kv_pages.ContinuousScheduler] = None
        self._pools = None                # (K, V) flat pools (L, P*S, KV, hd)
        self._cur = None                  # (max_batch,) next-token register
        self._scratch: Dict[int, object] = {}   # admission prefill caches
        self._plen_buckets: set = set()
        self._lat_ttft: List[float] = []
        self._lat_tok: List[float] = []
        self._stats: Dict[str, float] = {
            "requests": 0, "tokens_generated": 0, "generate_calls": 0,
            "chunks": 0, "admission_prefills": 0, "device_transfers": 0,
            "cache_allocs": 0, "prefill_seconds": 0.0, "decode_seconds": 0.0,
            "total_seconds": 0.0,
        }

    # -- paged KV pool ----------------------------------------------------
    def _ensure_pool(self) -> None:
        """Allocate the paged pool once per engine: one flat token-axis
        buffer per "self" KV leaf."""
        if self._pools is not None:
            return
        self._alloc = kv_pages.PageAllocator(self._capacity_tokens,
                                             self._page_size)
        self._csched = kv_pages.ContinuousScheduler(self.cfg.max_batch,
                                                    self._alloc)
        mcfg = self.model.cfg
        shape = (mcfg.num_layers, self._alloc.num_pages * self._page_size,
                 mcfg.num_kv_heads, mcfg.resolved_head_dim)
        dtype = getattr(torch, mcfg.dtype)
        self._pools = tuple(torch.zeros(shape, dtype=dtype, device=self.device)
                            for _ in range(2))
        self._cur = torch.zeros(self.cfg.max_batch, dtype=torch.int32,
                                device=self.device)
        self._stats["cache_allocs"] += 1

    def _scratch_cache(self, plen: int):
        """Admission prefill cache for one plen bucket, reused across
        admissions: prefill overwrites all its columns [0, plen)."""
        cache = self._scratch.get(plen)
        if cache is None:
            cache = self.model.init_cache(self.cfg.max_batch, plen,
                                          device=self.device)
            self._scratch[plen] = cache
        return cache

    # -- request queue ------------------------------------------------------
    def submit(self, request: api.Request) -> api.RequestHandle:
        """Queue one request; the handle resolves when it finishes."""
        if not isinstance(request, api.Request):
            raise TypeError("submit takes a repro_torch.serve.api.Request")
        if (request.temperature is not None
                and request.temperature != self.cfg.temperature):
            raise ValueError(
                f"Request.temperature {request.temperature} != engine "
                f"ServeConfig.temperature {self.cfg.temperature}")
        prompt = [int(t) for t in request.prompt]
        max_new = int(request.max_new_tokens)
        self._check(prompt, max_new)
        rid = self._next_rid
        self._next_rid += 1
        handle = api.RequestHandle(rid)
        self._queue.append(_Request(rid, prompt, max_new, handle,
                                    t_submit=time.perf_counter()))
        self._stats["requests"] += 1
        return handle

    def _check(self, prompt: List[int], max_new: int) -> None:
        """Reject a request that could never be served, before it queues."""
        if not prompt:
            raise ValueError("empty prompt: each prompt needs >= 1 token")
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if len(prompt) + max_new > self._capacity_tokens:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) "
                f"exceeds capacity_tokens ({self._capacity_tokens})")

    def run(self) -> List[api.GenerationResult]:
        """Drain the queue; results in request-id order."""
        drained = self._run_continuous()
        return [r.result for r in sorted(drained, key=lambda r: r.rid)]

    def generate(self, prompts: List[List[int]],
                 max_new_tokens: int) -> List[List[int]]:
        """Batched greedy generation; more prompts than slots are admitted
        at chunk boundaries as slots free up."""
        if not prompts:
            raise ValueError("generate() needs at least one prompt")
        # the whole batch first: a bad prompt must not leave others queued
        for p in prompts:
            self._check(list(p), max_new_tokens)
        t0 = time.perf_counter()
        handles = [self.submit(api.Request(prompt=list(p),
                                           max_new_tokens=max_new_tokens))
                   for p in prompts]
        try:
            self.run()
        except Exception:
            ids = {h.request_id for h in handles}
            self._queue = [r for r in self._queue if r.rid not in ids]
            raise
        self._stats["generate_calls"] += 1
        self._stats["total_seconds"] += time.perf_counter() - t0
        return [h.result(timeout=0).tokens for h in handles]

    def _finish_request(self, req: _Request, reason: str, now: float) -> None:
        total = max(now - req.t_submit, 1e-9)
        ttft = req.t_first - req.t_submit if req.t_first is not None else total
        n = len(req.tokens)
        self._lat_ttft.append(ttft)
        self._lat_tok.append(n / total)
        if len(self._lat_tok) > _LATENCY_WINDOW:
            del self._lat_ttft[:-_LATENCY_WINDOW]
            del self._lat_tok[:-_LATENCY_WINDOW]
        req.result = api.GenerationResult(
            request_id=req.rid, tokens=list(req.tokens), finish_reason=reason,
            prompt_len=len(req.prompt), ttft_s=ttft, total_s=total,
            tok_per_s=n / total)
        req.handle._set_result(req.result)

    # -- continuous drain: admit/evict at chunk boundaries ------------------
    def _run_continuous(self) -> List[_Request]:
        self._ensure_pool()
        finished: List[_Request] = []
        active: Dict[int, _Request] = {}        # slot -> request
        eos = self.cfg.eos_token
        try:
            while self._queue or active:
                if self._queue:
                    self._admit_batch(active)
                preempted = self._csched.ensure_chunk_pages(self._chunk)
                # Requeue victims at the queue front, smallest rid first,
                # with their tokens discarded: greedy decode makes the
                # restart exact.
                for row in sorted(preempted, key=lambda r: r.rid,
                                  reverse=True):
                    req = active.pop(row.slot)
                    req.tokens = None
                    req.t_first = None
                    self._queue.insert(0, req)
                if not active:
                    continue        # preemption freed the pool; re-admit
                buf_h, lens_h = self._run_chunk()
                now = time.perf_counter()
                for slot in list(active):
                    req = active[slot]
                    row = self._csched.rows[slot]
                    n = int(lens_h[slot])
                    emitted = [int(t) for t in buf_h[slot, :n]]
                    req.tokens.extend(emitted)
                    if emitted and req.t_first is None:
                        req.t_first = now
                    self._stats["tokens_generated"] += n
                    row.length += n
                    row.budget_left -= n
                    stop = eos is not None and eos in emitted
                    if row.budget_left <= 0 or stop:
                        self._csched.evict(row)
                        del active[slot]
                        self._finish_request(
                            req, api.FINISH_STOP if stop else api.FINISH_LENGTH,
                            now)
                        finished.append(req)
        except Exception as exc:
            # Free every live row so one bad request can't brick the pool;
            # fail their handles so waiters aren't stranded.
            for slot in list(active):
                req = active.pop(slot)
                row = self._csched.rows.get(slot)
                if row is not None:
                    self._csched.evict(row)
                if not req.handle.done:
                    req.handle._set_error(exc)
            raise
        return finished

    def _admit_batch(self, active: Dict[int, _Request]) -> None:
        """Admit every queue-head request that fits (slot + prompt pages),
        prefill them in ONE batched ragged call over all ``max_batch`` rows,
        scatter their prompt KV to their pages and put each first token in
        ``cur``.  Rows not admitted this call are fully masked
        (``kv_start = plen``), write to the TRASH page, and keep their
        ``cur``: only the admitted slots are updated (the reference pads its
        slot map with an out-of-range index that JAX drops; here the host
        list of admitted slots is the mask)."""
        admitted: List[_Request] = []
        while self._queue:
            nxt = self._queue[0]
            if not self._csched.can_admit(len(nxt.prompt)):
                break
            req = self._queue.pop(0)
            row = self._csched.admit(req.rid, len(req.prompt), req.max_new)
            req.slot = row.slot
            req.tokens = []
            active[row.slot] = req
            admitted.append(req)
        if not admitted:
            return
        b = self.cfg.max_batch
        page = self._page_size
        plen = _bucket_len(max(len(r.prompt) for r in admitted))
        # host inputs packed into one array: tokens (b, plen) | kv_start (b,)
        packed = np.zeros((b, plen + 1), np.int32)
        packed[:, plen] = plen
        dest = np.broadcast_to(
            kv_pages.TRASH_PAGE * page + np.arange(plen) % page,
            (b, plen)).astype(np.int64).copy()
        for r in admitted:
            n = len(r.prompt)
            packed[r.slot, plen - n:plen] = r.prompt
            packed[r.slot, plen] = plen - n
            logical = np.arange(n)
            pages = np.asarray(self._csched.rows[r.slot].pages, np.int64)
            dest[r.slot, plen - n:] = pages[logical // page] * page \
                + logical % page
        dev = torch.from_numpy(packed).to(self.device)
        batch = {"tokens": dev[:, :plen], "kv_start": dev[:, plen]}
        scratch = self._scratch_cache(plen)
        self._plen_buckets.add(plen)
        t0 = time.perf_counter()
        logits0, filled = self.model.prefill(self.params, batch, scratch)
        dest_t = torch.from_numpy(dest)
        for pool, src in zip(self._pools, filled["self"]):
            paged_scatter(pool, dest_t, src)
        slots = torch.tensor([r.slot for r in admitted], dtype=torch.long,
                             device=self.device)
        self._cur[slots] = greedy(logits0)[slots]
        if self.cfg.profile and self.device.type == "cuda":
            # deliberate sync: profile mode splits prefill / decode time
            torch.cuda.synchronize(self.device)
        self._stats["prefill_seconds"] += time.perf_counter() - t0
        self._stats["admission_prefills"] += 1

    def _run_chunk(self):
        """One decode chunk over every live row.  Returns host copies of the
        chunk's token buffer (B, chunk) and counts (B,): the chunk's single
        device-to-host transfer."""
        rows = self._csched.rows
        b = self.cfg.max_batch
        chunk = self._chunk
        page = self._page_size
        width = _bucket_len(max(r.length for r in rows.values()) + chunk)
        sidx = kv_pages.scatter_indices(rows, b, chunk, page)
        # host inputs packed into one array: gather idx (b, width) |
        # kv_start (b,) | budget (b,)
        packed = np.zeros((b, width + 2), np.int64)
        packed[:, :width] = kv_pages.gather_indices(rows, b, width, chunk, page)
        packed[:, width] = width - chunk
        for slot, row in rows.items():
            packed[slot, width] = width - chunk - row.length
            packed[slot, width + 1] = row.budget_left
        t0 = time.perf_counter()
        dev = torch.from_numpy(packed).to(self.device)
        gidx = dev[:, :width]
        kv_start = dev[:, width].to(torch.int32)
        budget = dev[:, width + 1].to(torch.int32)
        cache = {"self": tuple(paged_gather(pool, gidx) for pool in self._pools)}
        cur = self._cur
        done = budget <= 0                      # empty slots start finished
        buf = torch.zeros((b, chunk), dtype=torch.int32, device=self.device)
        lens = torch.zeros((b,), dtype=torch.int32, device=self.device)
        eos = self.cfg.eos_token
        offset = width - chunk
        for step in range(chunk):
            buf[:, step] = torch.where(done, 0, cur)
            lens += (~done).to(torch.int32)
            if eos is not None:
                done = done | (cur == eos)
            done = done | (lens >= budget)
            # Always advance (see the module docstring): while any row is
            # live this is the reference's step; after, it is masked work.
            logits, cache = self.model.decode_step(self.params, cur[:, None],
                                                   cache, offset, kv_start)
            cur = greedy(logits)
            offset += 1
        sidx_t = torch.from_numpy(sidx)
        for pool, leaf in zip(self._pools, cache["self"]):
            paged_scatter(pool, sidx_t, leaf[:, :, width - chunk:])
        self._cur = cur
        # The ONE device-to-host transfer of this chunk.
        host = torch.cat([buf, lens[:, None]], dim=1).cpu().numpy()
        self._stats["decode_seconds"] += time.perf_counter() - t0
        self._stats["device_transfers"] += 1
        self._stats["chunks"] += 1
        return host[:, :chunk], host[:, chunk]

    # -- telemetry -----------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Counters, paged-pool state, latency percentiles and the kernels'
        launch counts (process-wide, as ``repro_torch.kernels`` keeps them)."""
        out: Dict[str, object] = dict(self._stats)
        out["device"] = str(self.device)
        out["scheduler"] = "continuous"
        out["decode_chunk"] = self._chunk
        out["capacity_tokens"] = self._capacity_tokens
        out["page_size"] = self._page_size
        out["prefill_plen_buckets"] = sorted(self._plen_buckets)
        out["pages"] = None
        if self._alloc is not None:
            out["pages"] = {
                "page_size": self._alloc.page_size,
                "usable_pages": self._alloc.usable_pages,
                "used_pages": self._alloc.used_pages,
                "free_pages": self._alloc.free_pages,
                "utilization": self._alloc.utilization(),
                "high_water_pages": self._alloc.high_water_pages,
                "alloc_count": self._alloc.alloc_count,
                "free_count": self._alloc.free_count,
            }
        sched = self._csched
        out["admissions"] = sched.admissions if sched else 0
        out["evictions"] = sched.evictions if sched else 0
        out["preemptions"] = sched.preemptions if sched else 0
        out["latency"] = {
            "count": len(self._lat_tok),
            "ttft_s": _percentiles(self._lat_ttft),
            "tok_per_s": _percentiles(self._lat_tok),
        }
        out["slots"] = self.cfg.max_batch
        out["kernel_launches"] = kernels.launch_counts()
        return out
