"""Device-resident serve engine over a fixed pool of ``max_batch`` KV slots,
with two schedulers sharing one model path.

* **Continuous (default)** — continuous batching over a *paged* KV cache:
  KV memory is a pool of pages measured in tokens (host bookkeeping in
  :mod:`repro_torch.serve.kv_pages`).  The loop body is one *chunk
  boundary*: poll the server's ingest hook, admit every queue-head request
  that fits (one batched ragged prefill), grow live block tables for the
  next chunk (preempting the youngest rows if the pool runs dry), run one
  decode chunk, stream its tokens, then evict the rows that finished.  A
  decode chunk gathers every live row's KV into a dense right-aligned
  view, runs ``decode_chunk`` steps and scatters the chunk's new KV
  columns back to their pages; the model never sees a page table.
* **Wave (``ServeConfig(scheduler="wave")``)** — requests are packed into
  waves by capacity (``max(prompt) + max(max_new) <= max_len``), admitted
  into free slots of one dense cache (``init_cache(max_batch, max_len)``,
  allocated once per engine and reused across waves: stale columns are
  never read, thanks to per-slot ``kv_start`` and length masking), and
  evicted when the wave ends.  int8-KV models and the ssm family (no
  self-attention KV to page) always take this path.
* **One host transfer per chunk or wave** — the reference ends its
  ``while_loop`` early once every row is done; reading that flag here would
  be a host sync per token.  So a chunk always runs its steps (a wave runs
  ``max(max_new)`` of them, the most any of its rows can take), with
  finished rows masked exactly as the reference's loop body masks them
  (``buf``, ``lens``, ``done``).  Steps past the point where every row is
  done only write KV and SSM state that nothing reads (a finished row's
  slot is prefilled anew before it is read again) and advance a ``cur`` no
  live row carries, so the tokens are the same.  The token buffer and
  counts reach the host in one copy.
* **Sampling** — greedy is exact ``argmax``; ``temperature > 0`` samples by
  Gumbel-max, ``argmax(logits / T + G)`` (how ``jax.random.categorical``
  samples), with ``G`` drawn on the engine's device from a
  ``torch.Generator`` re-seeded from ``ServeConfig.seed`` at every
  ``run()``: repeated runs give the same samples.  Noise is drawn for all
  ``max_batch`` rows at every step, so the stream does not depend on which
  rows are live, and sampling adds no host sync.
* **Prefix cache** (continuous only, :mod:`repro_torch.serve.prefix_cache`)
  — a trie of page-sized token chunks pins prefilled prompt pages with
  refcounts.  A full-prompt hit skips prefill (shared pages, a
  copy-on-write of the tail page, and the first token sampled from the
  cached last-position logits: bit-exact under greedy decoding); a
  page-aligned partial hit shares the prefix pages and re-runs prefill with
  the shared columns' writes redirected to the TRASH page.  A full hit
  also restores the row's fixed leaves (the hybrid's SSM and conv states)
  from a snapshot taken after its prefill.  LRU eviction yields pages
  before live rows are preempted.
* **Streaming** — a request's ``stream`` callback gets one
  :class:`~repro_torch.serve.api.StreamEvent` per token when its tokens
  reach the host (each chunk boundary, or the wave's single transfer) and
  a terminal event; :class:`repro_torch.serve.server.Server` drives the
  engine from a worker thread through the ingest hook.
* **Ragged batches** — prompts are right-aligned (left-padded); the per-slot
  pad offset ``kv_start`` masks pad columns and restarts positions at each
  row's first real token, so each row decodes what it would decode alone.
  Prompt lengths are bucketed to powers of two (min 8; a wave's bucket is
  clamped so the bucket plus its decode budget fits ``max_len``).
* **Tuning provenance** — the engine resolves its hardware profile once
  (``ServeConfig.hardware``, else ``core.hardware.detect_hardware`` for its
  device) and drains under it, so every kernel launch's schedule comes from
  that profile's entries of the tuning registry.  It records where the
  schedules came from, in the reference's format: each GEMM shape of the
  first decode step (captured with ``capture_gemm_shapes``) and each
  prefill bucket's flash problem, mapped to ``{source, tile,
  matched_shape}``; and the page size's source (``config``, a tuned
  ``paged_attn`` entry, or the registry's fallback of 16 tokens).  A CPU engine given
  ``hardware="h100"`` reports what the card would resolve.
* **Extra inputs and fixed leaves** — ``generate``/``run`` take
  ``extra_inputs`` (the vlm family's image embeddings, the audio family's
  frame embeddings), one row per request (``Request.row``), placed at each
  request's slot of a prefill batch.  Cache leaves that are not paged (the
  cross K/V of vlm and audio, the hybrid's SSM and conv states) live in
  one resident tree over the slots; admission copies the admitted rows
  into it, a decode chunk reads it whole and keeps the tree its last step
  returns; a prefill's own cache holds only the ``"self"`` leaves.  The
  prefix cache is skipped while extras are given.  Every cache leaf keeps
  its leading dims (L, or U and P-1, or U) and is indexed from the end:
  batch at -4 (the conv window's at -3), tokens at -3.
* **Telemetry** — ``stats()`` counts the admissions' real and computed
  prompt tokens, the chunks' live and computed row-steps, the MoE layers'
  routed choices and expert buffer rows, and each admitted request's
  queue wait, all on the host; ``prefill_seconds`` / ``decode_seconds``
  are the device's time (CUDA events, read after the chunk's or wave's
  host copy; the host clock on the CPU).  Under a profiler the engine's
  host work is traced as ``serve.schedule``, a chunk's KV copies as
  ``serve.kv_gather`` / ``serve.kv_scatter``, and each admission prefill
  and decode chunk is followed by a ``serve.counts.admit`` /
  ``serve.counts.chunk`` count of what it did.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch import kernels
from repro_torch.core.attention_api import flash_tile_lookup
from repro_torch.core.device import resolve_device
from repro_torch.core.gemm_api import capture_gemm_shapes, execution_context
from repro_torch.core.hardware import find_profile, resolve_hardware
from repro_torch.core.registry import GLOBAL_REGISTRY
from repro_torch.core.tile_config import OP_GEMM, OP_PAGED_ATTN
from repro_torch.distributed import ctx as dctx
from repro_torch.distributed import ops as dops
from repro_torch.distributed import sharding as sh
from repro_torch.kernels.paged import paged_copy, paged_gather, paged_scatter
from repro_torch.launch.mesh import build_mesh, describe_mesh
from repro_torch.models.model import Model
from repro_torch.models.moe import moe_counts
from repro_torch.profiling import annotate, count
from repro_torch.serve import api, kv_pages
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.reference import greedy
from repro_torch.serve.stats_schema import SCHEMA_VERSION

_PLEN_BUCKET_MIN = 8
#: per-request latency records kept for percentile stats
_LATENCY_WINDOW = 4096
#: smallest uniform draw for Gumbel noise (``jax.random.gumbel``'s minval)
_TINY = torch.finfo(torch.float32).tiny
#: batch-dim kind of each non-paged cache leaf (``_fixed_leaves``)
_FIXED_KINDS = {"cross": "kv", "ssm": "ssm", "conv": "conv"}


def _percentiles(xs: List[float]) -> Dict[str, Optional[float]]:
    if not xs:
        return {"p50": None, "p95": None, "p99": None}
    q = np.percentile(np.asarray(xs, np.float64), [50.0, 95.0, 99.0])
    return {"p50": float(q[0]), "p95": float(q[1]), "p99": float(q[2])}


def _bucket_len(n: int, cap: Optional[int] = None) -> int:
    """Smallest power-of-two bucket >= ``n`` (min 8), clamped to ``cap``.
    When ``cap < n`` the cap itself is returned (< n) and the caller falls
    back to another size."""
    b = _PLEN_BUCKET_MIN
    while b < n:
        b *= 2
    if cap is not None and b > cap:
        b = cap
    return b


class _RegionClock:
    """Seconds of the engine's prefills and decodes as the device ran
    them, with no sync of their own.  On the card, CUDA events on the
    engine's stream: a region's end is recorded before the host copy that
    follows it, and read (:meth:`read`) once that copy has returned.  On
    the CPU, where each op runs as it is called, the host clock."""

    def __init__(self, device: torch.device):
        self._device = device if device.type == "cuda" else None
        self._open: List[tuple] = []      # (key, start, end) not yet read

    def _event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self._device))
        return ev

    def start(self):
        """Before a region's first launch."""
        return time.perf_counter() if self._device is None else self._event()

    def mark_end(self):
        """A region's end, inside it, before its host copy (None on the
        CPU, whose time is taken at :meth:`stop`)."""
        return None if self._device is None else self._event()

    def stop(self, stats: Dict[str, float], key: str, start,
             end=None) -> None:
        """After a region: its seconds go to ``stats[key]``, on the card
        at the next :meth:`read`."""
        if self._device is None:
            stats[key] += time.perf_counter() - start
        else:
            self._open.append((key, start,
                               self._event() if end is None else end))

    def read(self, stats: Dict[str, float]) -> None:
        """After a host copy that followed every region stopped so far."""
        for key, start, end in self._open:
            stats[key] += start.elapsed_time(end) * 1e-3
        self._open.clear()


def _moe_delta(before: Dict[str, int]) -> Dict[str, int]:
    """The MoE counts taken since ``before`` (a ``moe_counts()``)."""
    now = moe_counts()
    return {"routed": now["routed"] - before["routed"],
            "expert_rows": now["expert_rows"] - before["expert_rows"]}


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8                # KV-cache slots
    max_len: int = 512                # per-slot capacity (prompt + new)
    temperature: float = 0.0          # 0 => greedy
    eos_token: Optional[int] = None
    seed: int = 0                     # sampling seed, re-applied every run()
    # "continuous" (paged KV, admit/evict at chunk boundaries) or "wave".
    # int8-KV models run "wave" either way.
    scheduler: str = "continuous"
    # tokens per KV page; None -> the tuning registry's paged_attn entry
    # for (max_batch, max_len), else its fallback (16)
    page_size: Optional[int] = None
    # Paged-pool capacity in TOKENS; None = max_batch * max_len.
    capacity_tokens: Optional[int] = None
    # Tokens decoded per chunk between scheduling boundaries.  Power of two.
    decode_chunk: int = 8
    # Share prefilled prompt KV across requests (continuous scheduler only).
    prefix_cache: bool = True
    device: Optional[str] = None      # None -> the card ("cuda")
    # hardware profile the tuning registry is keyed by; None -> detected
    hardware: Optional[str] = None
    # a --mesh spec ("data=4,model=2") or a DeviceMesh; None -> the ambient
    # distributed.use_mesh() one, else one device
    mesh: object = None


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: List[int]
    max_new: int
    handle: api.RequestHandle
    row: Optional[int] = None         # Request.row, carried for callers
    stream: Optional[Callable[[api.StreamEvent], None]] = None
    slot: Optional[int] = None
    tokens: Optional[List[int]] = None
    result: Optional[api.GenerationResult] = None
    t_submit: float = 0.0
    t_first: Optional[float] = None   # first token host-visible (TTFT end)
    prefix_hit: Optional[str] = None  # "full" | "partial" | None
    cached_prefix_tokens: int = 0


class _SlotScheduler:
    """Admit/evict bookkeeping over the fixed pool of KV-cache slots."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots
        self._free = list(range(n_slots))
        self._use_count = [0] * n_slots
        self.admitted = 0
        self.evicted = 0

    def admit(self, req: _Request) -> int:
        if not self._free:
            raise RuntimeError("no free KV-cache slot")
        slot = self._free.pop(0)
        req.slot = slot
        self._use_count[slot] += 1
        self.admitted += 1
        return slot

    def evict(self, req: _Request) -> None:
        self._free.append(req.slot)
        self._free.sort()
        self.evicted += 1

    @property
    def reuses(self) -> int:
        return sum(max(c - 1, 0) for c in self._use_count)


def _fixed_leaves(tree, kind: Optional[str] = None):
    """``(leaf, batch dim)`` of every leaf of a fixed-cache tree (the
    non-paged leaves: cross-KV and SSM state with the batch dim at -4, conv
    state at -3), in a fixed order.  The dense and moe families have none."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _fixed_leaves(v, _FIXED_KINDS.get(k, kind))
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _fixed_leaves(v, kind)
    else:
        yield tree, tree.ndim - (3 if kind == "conv" else 4)


def _fixed_rows(tree, slot: int):
    """Views of ``slot``'s rows of every leaf of a fixed-cache tree (on a
    mesh, of this rank's part of the row; None where another rank holds
    it)."""
    for leaf, bd in _fixed_leaves(tree):
        if isinstance(leaf, DTensor):
            yield dops.local_row(leaf, bd, slot)
        else:
            yield leaf.select(bd, slot)


class Engine:
    """Serve engine over a fixed slot pool: continuous batching over a paged
    KV pool, or waves over a dense cache (``ServeConfig.scheduler``).

    ``generate`` is the batched entry point; ``submit``/``run`` expose the
    request queue.  Runs on ``ServeConfig.device`` (default: the card); the
    params must already live there.
    """

    def __init__(self, model: Model, params, cfg: ServeConfig):
        self.device = resolve_device(cfg.device)
        if cfg.scheduler not in ("continuous", "wave"):
            raise ValueError(f"unknown scheduler {cfg.scheduler!r}; "
                             f"expected 'continuous' or 'wave'")
        chunk = int(cfg.decode_chunk)
        if chunk < 1 or chunk & (chunk - 1):
            raise ValueError(
                f"decode_chunk must be a power of two >= 1, got {chunk}")
        pdev = params["embedding"].device
        if pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, the engine runs on "
                             f"{self.device}")
        self.model = model
        self.cfg = cfg
        # Mesh topology: explicit config > ambient use_mesh() > one device,
        # resolved once, like the hardware profile.  Serving replicates the
        # weights over the data axes and splits them over the tensor axis
        # only (inference TP, rules_for_mesh(fsdp=False)): a decode GEMM is
        # too small to amortise the per-step weight gathers of FSDP.
        # Explicit ambient rules win.
        mesh, rules = cfg.mesh, None
        if mesh is None:
            mesh, rules = dctx.current_mesh(), dctx.current_rules()
        if isinstance(mesh, str):
            mesh = build_mesh(mesh, device=self.device)
        self.mesh = mesh
        self.rules = None
        if mesh is not None:
            self.rules = rules or sh.rules_for_mesh(mesh, fsdp=False)
            params = sh.shard_params(params, mesh, self.rules,
                                     model.template)
        self.params = params
        # resolved once: every lookup (and the stats' provenance) of this
        # engine is keyed by one profile
        self.hardware = resolve_hardware(cfg.hardware, self.device)
        prof = find_profile(self.hardware)
        self._platform = prof.platform if prof else "unknown"
        self._tile_lookups: Optional[Dict[str, Dict[str, object]]] = None
        self._prefill_flash_lookups: Dict[str, Dict[str, object]] = {}
        self._chunk = chunk
        self._scheduler = cfg.scheduler
        self._scheduler_forced: Optional[str] = None
        if cfg.scheduler == "continuous":
            # the paged pool holds plain self-attention K/V leaves: a model
            # without them (pure SSM) or with the {q, s} layout of an int8
            # cache keeps the dense wave path
            if model.cfg.family == "ssm":
                self._scheduler = "wave"
                self._scheduler_forced = "no self-attention KV cache"
            elif model.cfg.kv_quant:
                self._scheduler = "wave"
                self._scheduler_forced = "int8-quantized KV cache"
        self._capacity_tokens = int(cfg.capacity_tokens
                                    or cfg.max_batch * cfg.max_len)
        self._page_size, self._page_size_source = self._resolve_page_size()
        self._sched = _SlotScheduler(cfg.max_batch)
        self._queue: List[_Request] = []
        self._next_rid = 0
        self._cache = None                # wave: dense cache, reused
        self._alloc: Optional[kv_pages.PageAllocator] = None
        self._csched: Optional[kv_pages.ContinuousScheduler] = None
        self._pools = None                # (K, V) flat pools (L, P*S, KV, hd)
        self._fixed: Dict[str, object] = {}   # resident non-paged leaves
        self._cur = None                  # (max_batch,) next-token register
        self._scratch: Dict[int, object] = {}   # admission prefill caches
        self._prefix: Optional[PrefixCache] = None
        self._gen = torch.Generator(device=self.device)
        # Server mode: a callable polled at every chunk/wave boundary that
        # yields (api.Request, RequestHandle) pairs submitted mid-drain.
        self._ingest_hook: Optional[Callable] = None
        self._plen_buckets: set = set()
        self._lat_ttft: List[float] = []
        self._lat_tok: List[float] = []
        self._lat_wait: List[float] = []
        self._clock = _RegionClock(self.device)
        self._stats: Dict[str, float] = {
            "requests": 0, "tokens_generated": 0, "generate_calls": 0,
            "waves": 0, "chunks": 0, "admission_prefills": 0,
            "device_transfers": 0, "cache_allocs": 0,
            "prefill_seconds": 0.0, "decode_seconds": 0.0,
            "total_seconds": 0.0,
            "prefill_rows": 0, "prefill_prompt_tokens": 0,
            "prefill_row_tokens": 0, "decode_live_row_steps": 0,
            "decode_slot_steps": 0,
            "moe_routed": 0, "moe_expert_rows": 0,
        }

    # -- tuning provenance ----------------------------------------------------
    def _resolve_page_size(self):
        """(page size, source): the config's, else a tuned ``paged_attn``
        entry for (max_batch, max_len) on the engine's profile, else the
        registry's fallback; clamped to the pool's capacity."""
        if self.cfg.page_size is not None:
            page, source = max(int(self.cfg.page_size), 1), "config"
        else:
            res = GLOBAL_REGISTRY.lookup_op(
                OP_PAGED_ATTN, self.hardware, self.model.cfg.dtype,
                (self.cfg.max_batch, self.cfg.max_len))
            page = max(int(res.config.page_size), 1)
            source = (f"tuned:{res.source}"
                      if res.source in ("exact", "nearest", "generic")
                      else res.source)
        return min(page, self._capacity_tokens), source

    def _decode_step(self, tokens, cache, offset, kv_start):
        """``model.decode_step`` on the host's (B, 1) tokens and (B,)
        ``kv_start``, -> (the whole (B, V) logits, cache); the first one
        also records the registry's resolution of each GEMM shape it runs
        (``decode_tile_lookups``).  On a mesh each rank's products run on
        local shapes, and the lookup is keyed by them: each entry carries
        its ``local_shape``, and a global (K, N) that weights split two
        ways is keyed ``global->local`` for each."""
        tokens, kv_start = sh.place_batch(self.mesh, self.rules,
                                          (tokens, kv_start))
        if self._tile_lookups is not None:
            logits, cache = self.model.decode_step(self.params, tokens, cache,
                                                   offset, kv_start)
            return sh.full(logits), cache
        pairs: list = []
        with capture_gemm_shapes() as shapes, \
                execution_context(sharded=pairs):
            logits, cache = self.model.decode_step(self.params, tokens, cache,
                                                   offset, kv_start)
        dtype = self.model.cfg.dtype
        lookups = {}
        if self.mesh is None:
            pairs = [(shape, None) for shape in shapes]
        else:
            div = sh.local_gemm_divisors(self.mesh, self.rules,
                                         self.model.template)
        for (m, k, n), local in sorted(set(pairs)):
            res = GLOBAL_REGISTRY.lookup_op(OP_GEMM, self.hardware, dtype,
                                            local or (m, k, n))
            entry = {"source": res.source, "tile": res.config.schedule,
                     "matched_shape": res.matched_shape}
            key = f"{m}x{k}x{n}"
            if local is not None:
                entry["local_shape"] = "x".join(map(str, local))
                entry["mesh"] = res.mesh
                if len(div.get((k, n), ())) > 1:
                    key = f"{key}->{entry['local_shape']}"
            lookups[key] = entry
        self._tile_lookups = lookups
        return sh.full(logits), cache

    # -- the mesh ---------------------------------------------------------
    def _gather_pool(self, pool, gidx):
        """``paged_gather``; on a mesh each rank gathers its batch rows of
        its pool block, laid out as ``cache_shardings`` lays a dense
        cache."""
        if self.mesh is None:
            return paged_gather(pool, gidx)
        shape = tuple(pool.shape[:-3]) + tuple(gidx.shape) + tuple(
            pool.shape[-2:])
        spec = sh.cache_spec(self.mesh, self.rules, shape, len(shape) - 4,
                             seq_dim=len(shape) - 3, head_dim=len(shape) - 2)
        return dops.paged_gather(pool, gidx, sh.placements_for(self.mesh,
                                                                spec),
                                 paged_gather)

    def _scatter_pool(self, pool, idx, cols) -> None:
        if self.mesh is None:
            paged_scatter(pool, idx, cols)
        else:
            dops.paged_scatter(pool, idx, cols, paged_scatter)

    def _record_prefill_flash_tiles(self, plen: int) -> None:
        """Record the registry's resolution of this prefill bucket's flash
        problem ``(plen, plen, head_dim)`` (flash-attention models only)."""
        cfg = self.model.cfg
        if cfg.attention_impl != "flash" or not cfg.num_heads:
            return
        key = f"{plen}x{plen}x{cfg.resolved_head_dim}"
        if key not in self._prefill_flash_lookups:
            res = flash_tile_lookup(self.hardware, cfg.dtype, plen, plen,
                                    cfg.resolved_head_dim)
            self._prefill_flash_lookups[key] = {
                "source": res.source, "tile": res.config.schedule,
                "matched_shape": res.matched_shape}

    # -- sampling -----------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, V) f32 logits -> (B,) int32 tokens: argmax, or Gumbel-max at
        ``temperature > 0`` with noise from the engine's generator."""
        t = self.cfg.temperature
        if t <= 0.0:
            return greedy(logits)
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device, dtype=torch.float32)
        g = -torch.log(-torch.log(u.clamp_(min=_TINY)))
        return torch.argmax(logits / t + g, dim=-1).to(torch.int32)

    # -- dense cache (wave) ---------------------------------------------------
    def _self_cache(self, max_len: int):
        """The ``"self"`` leaves of ``init_cache(max_batch, max_len)`` (none
        for the ssm family): all a prefill reads of its cache argument (it
        makes the fixed leaves, the cross K/V and the SSM states, anew)."""
        cache = self.model.init_cache(self.cfg.max_batch, max_len,
                                      device=self.device)
        return sh.place_cache(self.mesh, self.rules,
                              {k: v for k, v in cache.items() if k == "self"})

    def _ensure_cache(self):
        """One dense ``init_cache(max_batch, max_len)`` per engine, reused by
        every wave: prefill rewrites a wave's columns [0, plen) and decode
        reads only [kv_start, offset]."""
        if self._cache is None:
            self._cache = self._self_cache(self.cfg.max_len)
            self._stats["cache_allocs"] += 1
        return self._cache

    # -- paged KV pool (continuous) -------------------------------------------
    def _ensure_pool(self) -> None:
        """Allocate the paged pool once per engine: one flat token-axis
        buffer per "self" KV leaf, with the leaf's leading dims (L, or U and
        P-1 for the vlm family, U for the hybrid), and the resident tree of
        the fixed leaves (the vlm family's cross K/V, (U, max_batch, N_img,
        KV, hd); the hybrid's SSM and conv states, (U, P, max_batch, ...))
        that admission row-scatters into."""
        if self._pools is not None:
            return
        self._alloc = kv_pages.PageAllocator(self._capacity_tokens,
                                             self._page_size)
        self._csched = kv_pages.ContinuousScheduler(self.cfg.max_batch,
                                                    self._alloc)
        npp = self._alloc.num_pages * self._page_size
        template = self.model.init_cache(self.cfg.max_batch, 1,
                                         device=self.device)
        self._pools = tuple(
            torch.zeros(leaf.shape[:-4] + (npp,) + leaf.shape[-2:],
                        dtype=leaf.dtype, device=self.device)
            for leaf in template["self"])
        self._fixed = sh.place_cache(
            self.mesh, self.rules,
            {k: v for k, v in template.items() if k != "self"})
        if self.mesh is not None:
            # no batch dim: KV heads on the tensor axis where they divide
            self._pools = tuple(sh.distribute(pool, self.mesh,
                                              sh.placements_for(
                                                  self.mesh, sh.pool_spec(
                                                      self.mesh, self.rules,
                                                      pool.shape)))
                                for pool in self._pools)
        self._cur = torch.zeros(self.cfg.max_batch, dtype=torch.int32,
                                device=self.device)
        if self.cfg.prefix_cache:
            self._prefix = PrefixCache(self._alloc)
            # under pool pressure the scheduler reclaims cache-pinned pages
            # (LRU) before preempting live rows
            self._csched.reclaim = self._prefix.reclaim
        self._stats["cache_allocs"] += 1

    def _scratch_cache(self, plen: int):
        """Admission prefill cache for one plen bucket, reused across
        admissions: prefill overwrites all its columns [0, plen)."""
        cache = self._scratch.get(plen)
        if cache is None:
            cache = self._scratch[plen] = self._self_cache(plen)
        return cache

    def _scatter_fixed(self, filled, slots: torch.Tensor,
                       slot_ids: List[int]) -> None:
        """Copy the admitted ``slots``' rows of a prefill's fixed leaves into
        the resident tree; other slots keep their live rows.  The mesh path
        takes the same slots as the host list ``slot_ids``."""
        new = {k: filled[k] for k in self._fixed}
        for (dst, bd), (src, _) in zip(_fixed_leaves(self._fixed),
                                       _fixed_leaves(new)):
            if self.mesh is None:
                dst.index_copy_(bd, slots, src.index_select(bd, slots))
            else:
                dops.copy_rows(dst, src, bd, slot_ids)

    def _batch_extras(self, batch, reqs: List[_Request], extra_inputs):
        """Put each request's rows of ``extra_inputs`` (indexed by
        ``Request.row``) at its slot of a max_batch prefill batch; other
        slots get zeros."""
        if not extra_inputs:
            return
        slots = torch.tensor([r.slot for r in reqs], device=self.device)
        rows = torch.tensor([r.row for r in reqs], device=self.device)
        for name, arr in extra_inputs.items():
            arr = torch.as_tensor(arr, device=self.device)
            padded = arr.new_zeros((self.cfg.max_batch,) + arr.shape[1:])
            padded[slots] = arr[rows]
            batch[name] = padded

    def _slice_fixed_row(self, slot: int) -> List[torch.Tensor]:
        """Snapshot one slot's rows of every fixed cache leaf: the per-row
        state a full prefix hit restores (empty for the dense family)."""
        return [None if row is None else row.clone()
                for row in _fixed_rows(self._fixed, slot)]

    def _restore_fixed_row(self, snap: List[torch.Tensor], slot: int) -> None:
        """Write a :meth:`_slice_fixed_row` snapshot back into ``slot``."""
        for row, saved in zip(_fixed_rows(self._fixed, slot), snap):
            if row is not None:
                row.copy_(saved)

    # -- request queue ----------------------------------------------------------
    def submit(self, request: api.Request,
               _handle: Optional[api.RequestHandle] = None
               ) -> api.RequestHandle:
        """Queue one request; the handle resolves when it finishes.
        ``_handle`` is internal: a Server makes the handle on the caller's
        thread before the worker ingests the request."""
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
        handle = _handle if _handle is not None else api.RequestHandle()
        handle.request_id = rid
        self._queue.append(_Request(rid, prompt, max_new, handle,
                                    row=request.row, stream=request.stream,
                                    t_submit=time.perf_counter()))
        self._stats["requests"] += 1
        return handle

    def _check(self, prompt: List[int], max_new: int) -> None:
        """Reject a request that could never be served, before it queues.
        The continuous scheduler's capacity is tokens in the paged pool; the
        wave scheduler reserves a ``max_len``-column slot."""
        if not prompt:
            raise ValueError("empty prompt: each prompt needs >= 1 token")
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if self._scheduler == "continuous":
            if len(prompt) + max_new > self._capacity_tokens:
                raise ValueError(
                    f"prompt ({len(prompt)}) + max_new ({max_new}) "
                    f"exceeds capacity_tokens ({self._capacity_tokens})")
        elif len(prompt) + max_new > self.cfg.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds "
                f"max_len ({self.cfg.max_len})")

    def run(self, extra_inputs: Optional[Dict[str, torch.Tensor]] = None
            ) -> List[api.GenerationResult]:
        """Drain the queue; results in request-id order.  Re-seeds the
        sampling generator, so repeated runs give the same samples.

        ``extra_inputs``: per-request model inputs (``Model.extra_inputs``,
        e.g. the vlm family's ``image_embeds``), leading dim indexed by each
        request's ``row``.  The prefix cache is not consulted while they are
        given: a cached prompt's KV depends on them."""
        if extra_inputs and any(r.row is None for r in self._queue):
            raise ValueError(
                "extra_inputs needs every request submitted with row= "
                "(its index into the extra arrays); generate() does this")
        self._gen.manual_seed(self.cfg.seed)
        # no_grad and the execution context are thread-local: entered here,
        # they cover a Server's worker
        with torch.no_grad(), execution_context(hardware=self.hardware), \
                dctx.on_mesh(self.mesh, self.rules):
            if self._scheduler == "continuous":
                drained = self._run_continuous(extra_inputs)
            else:
                drained = []
                while True:
                    self._poll_ingest()
                    if not self._queue:
                        break
                    wave = self._pack_wave()
                    self._run_wave(wave, extra_inputs)
                    drained.extend(wave)
        return [r.result for r in sorted(drained, key=lambda r: r.rid)]

    def _poll_ingest(self) -> None:
        """Pull server-mode requests in at a scheduling boundary (no-op
        without an ingest hook)."""
        if self._ingest_hook is None:
            return
        for req, handle in self._ingest_hook():
            self.submit(req, _handle=handle)

    def generate(self, prompts: List[List[int]], max_new_tokens: int,
                 extra_inputs: Optional[Dict[str, torch.Tensor]] = None
                 ) -> List[List[int]]:
        """Batched generation; more prompts than slots are admitted at chunk
        boundaries (continuous) or served in successive waves.
        ``extra_inputs`` arrays have one row per prompt (see :meth:`run`)."""
        if not prompts:
            raise ValueError("generate() needs at least one prompt")
        # the whole batch first: a bad prompt must not leave others queued
        for p in prompts:
            self._check(list(p), max_new_tokens)
        for name, arr in (extra_inputs or {}).items():
            if arr.shape[0] != len(prompts):
                raise ValueError(
                    f"extra input {name!r} leading dim {arr.shape[0]} != "
                    f"len(prompts) {len(prompts)}")
        t0 = time.perf_counter()
        handles = [self.submit(api.Request(prompt=list(p),
                                           max_new_tokens=max_new_tokens,
                                           row=i))
                   for i, p in enumerate(prompts)]
        try:
            self.run(extra_inputs)
        except Exception:
            ids = {h.request_id for h in handles}
            self._queue = [r for r in self._queue if r.rid not in ids]
            raise
        self._stats["generate_calls"] += 1
        self._stats["total_seconds"] += time.perf_counter() - t0
        return [h.result(timeout=0).tokens for h in handles]

    def _emit(self, req: _Request, emitted: List[int], now: float) -> None:
        """Append host-visible tokens to a request and stream them."""
        base = len(req.tokens)
        req.tokens.extend(emitted)
        if emitted and req.t_first is None:
            req.t_first = now
        if req.stream is not None:
            for j, t in enumerate(emitted):
                req.stream(api.StreamEvent(req.rid, t, base + j))
        self._stats["tokens_generated"] += len(emitted)

    def _finish_request(self, req: _Request, reason: str, now: float) -> None:
        """Latency records, the terminal stream event, handle resolution."""
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
            tok_per_s=n / total, prefix_hit=req.prefix_hit,
            cached_prefix_tokens=req.cached_prefix_tokens)
        if req.stream is not None:
            req.stream(api.StreamEvent(req.rid, None, n, finished=True,
                                       finish_reason=reason))
        req.handle._set_result(req.result)

    def _record_wait(self, wait: float) -> None:
        """An admitted request's queue wait (submit to admission)."""
        self._lat_wait.append(wait)
        if len(self._lat_wait) > _LATENCY_WINDOW:
            del self._lat_wait[:-_LATENCY_WINDOW]

    def _finish_reason(self, emitted: List[int]) -> Optional[str]:
        eos = self.cfg.eos_token
        return api.FINISH_STOP if eos is not None and eos in emitted else None

    # -- wave drain: one prefill + one fused decode + one transfer ------------
    def _pack_wave(self) -> List[_Request]:
        """Pop the next capacity-feasible wave off the queue (FIFO-biased):
        the head always ships; later requests join while ``max(prompt) +
        max(max_new)`` stays within ``max_len``, the rest keep their place."""
        wave = [self._queue.pop(0)]
        longest = len(wave[0].prompt)
        need = wave[0].max_new
        i = 0
        while len(wave) < self.cfg.max_batch and i < len(self._queue):
            r = self._queue[i]
            nl = max(longest, len(r.prompt))
            nn = max(need, r.max_new)
            if nl + nn <= self.cfg.max_len:
                wave.append(self._queue.pop(i))
                longest, need = nl, nn
            else:
                i += 1
        return wave

    def _run_wave(self, wave: List[_Request], extra_inputs=None) -> None:
        cfg = self.cfg
        need = max(r.max_new for r in wave)    # real token budget (cache need)
        longest = max(len(r.prompt) for r in wave)
        if longest + need > cfg.max_len:       # submit()/_pack_wave guarantee
            raise ValueError(                  # this; keep the guard for raw
                f"prompt ({longest}) + max_new ({need}) exceeds "   # callers
                f"max_len ({cfg.max_len})")
        # The decode width is a buffer bound, bucketed unclamped.  The
        # prompt pad is capacity-bound: bucketed, clamped to leave the width
        # bucket, else the exact need, else the prompt itself.
        width = _bucket_len(need)
        plen = _bucket_len(longest, cfg.max_len - width)
        if plen < longest:
            plen = _bucket_len(longest, cfg.max_len - need)
        if plen < longest:     # unreachable: longest + need <= max_len
            plen = longest
        for r in wave:
            self._sched.admit(r)
        try:
            self._decode_wave(wave, plen, width, need, extra_inputs)
        except Exception as exc:
            for r in wave:
                if not r.handle.done:
                    r.handle._set_error(exc)
            raise
        finally:
            # free slots even when prefill/decode throws
            for r in wave:
                self._sched.evict(r)

    def _decode_wave(self, wave: List[_Request], plen: int, width: int,
                     need: int, extra_inputs=None) -> None:
        b = self.cfg.max_batch
        # host inputs packed into one array: tokens (b, plen) | kv_start | budget
        packed = np.zeros((b, plen + 2), np.int32)
        packed[:, plen] = plen                 # empty slots: fully padded
        for r in wave:
            n = len(r.prompt)
            packed[r.slot, plen - n:plen] = r.prompt
            packed[r.slot, plen] = plen - n
            packed[r.slot, plen + 1] = r.max_new
        dev = torch.from_numpy(packed).to(self.device)
        kv_start, budget = dev[:, plen], dev[:, plen + 1]
        batch = {"tokens": dev[:, :plen], "kv_start": kv_start}
        self._batch_extras(batch, wave, extra_inputs)
        cache = self._ensure_cache()
        self._plen_buckets.add(plen)
        self._record_prefill_flash_tiles(plen)
        t0 = self._clock.start()
        logits0, cache = self._prefill_wave(batch, cache)
        self._clock.stop(self._stats, "prefill_seconds", t0)
        t1 = self._clock.start()
        host, end = self._decode_loop(logits0, cache, kv_start, budget, plen,
                                      width, need)
        self._clock.stop(self._stats, "decode_seconds", t1, end)
        self._clock.read(self._stats)
        self._stats["device_transfers"] += 1
        self._stats["waves"] += 1
        now = time.perf_counter()
        for r in wave:
            n = int(host[r.slot, width])
            r.tokens = []
            # every token of a wave becomes host-visible at its transfer
            self._emit(r, [int(t) for t in host[r.slot, :n]], now)
            self._finish_request(r, self._finish_reason(r.tokens)
                                 or api.FINISH_LENGTH, now)

    def _prefill_wave(self, batch, cache):
        """The wave's prefill: (the last position's (B, V) logits, cache)."""
        with annotate("serve.prefill_wave"):
            logits0, cache = self.model.prefill(
                self.params, sh.place_batch(self.mesh, self.rules, batch),
                cache)
            logits0 = sh.full(logits0)
        return logits0, cache

    def _decode_loop(self, logits0, cache, kv_start, budget, plen: int,
                     width: int, need: int) -> Tuple[np.ndarray, object]:
        """The wave's ``need`` decode steps from the prefill's logits, the
        tokens into a (B, width) buffer.  Returns its host copy with each
        row's count in the last column (the wave's one transfer), and the
        device's end of the steps (``_RegionClock.mark_end``)."""
        b = self.cfg.max_batch
        with annotate("serve.decode_wave"):
            cur = self._sample(logits0)
            done = budget <= 0                 # empty slots start finished
            buf = torch.zeros((b, width), dtype=torch.int32,
                              device=self.device)
            lens = torch.zeros((b,), dtype=torch.int32, device=self.device)
            eos = self.cfg.eos_token
            offset = plen
            # Every row is done after ``need`` steps, where the reference's
            # loop stops at the latest; the advance after the last step is
            # skipped, as there.  Earlier steps run with finished rows
            # masked.
            for step in range(need):
                buf[:, step] = torch.where(done, 0, cur)
                lens += (~done).to(torch.int32)
                if eos is not None:
                    done = done | (cur == eos)
                done = done | (lens >= budget)
                if step + 1 < need:
                    logits, cache = self._decode_step(cur[:, None], cache,
                                                      offset, kv_start)
                    cur = self._sample(logits)
                    offset += 1
            end = self._clock.mark_end()
            # The ONE device-to-host transfer of this wave.
            # analysis: allow(TP001)
            host = torch.cat([buf, lens[:, None]], dim=1).cpu().numpy()
        return host, end

    # -- continuous drain: admit/evict at chunk boundaries ----------------------
    def _run_continuous(self, extra_inputs=None) -> List[_Request]:
        self._ensure_pool()
        finished: List[_Request] = []
        active: Dict[int, _Request] = {}        # slot -> request
        try:
            while True:
                self._poll_ingest()
                if not (self._queue or active):
                    break
                if self._queue:
                    self._admit_batch(active, extra_inputs)
                with annotate("serve.schedule"):
                    preempted = self._csched.ensure_chunk_pages(self._chunk)
                    # Requeue victims at the queue front, smallest rid
                    # first, with their tokens discarded: greedy decode
                    # makes the restart exact.
                    for row in sorted(preempted, key=lambda r: r.rid,
                                      reverse=True):
                        req = active.pop(row.slot)
                        self._sched.evict(req)
                        req.tokens = None
                        req.t_first = None
                        req.prefix_hit = None
                        req.cached_prefix_tokens = 0
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
                    self._emit(req, emitted, now)
                    row.length += n
                    row.budget_left -= n
                    stop = self._finish_reason(emitted)
                    if row.budget_left <= 0 or stop:
                        self._csched.evict(row)
                        self._sched.evict(req)
                        del active[slot]
                        self._finish_request(req, stop or api.FINISH_LENGTH,
                                             now)
                        finished.append(req)
        except Exception as exc:
            # Free every live row (pages and slots) so one bad request can't
            # brick the pool; fail their handles so waiters aren't stranded.
            for slot in list(active):
                req = active.pop(slot)
                row = self._csched.rows.get(slot)
                if row is not None:
                    self._csched.evict(row)
                self._sched.evict(req)
                if not req.handle.done:
                    req.handle._set_error(exc)
            raise
        return finished

    def _admit_batch(self, active: Dict[int, _Request],
                     extra_inputs=None) -> None:
        """Admit every queue-head request that fits (slot + prompt pages),
        consult the prefix cache for each, restore full hits without
        prefill, and prefill the rest in ONE batched ragged call over all
        ``max_batch`` rows: their prompt KV goes to their pages and their
        first tokens into ``cur``.  Rows not admitted this call are fully
        masked (``kv_start = plen``), write to the TRASH page, and keep
        their ``cur``: only the admitted slots are updated.

        Prefix-cache composition (host bookkeeping): the head's cached pages
        count as shared for the capacity check; when the head still does
        not fit for want of pages, the cache evicts LRU entries first (a
        busy slot frees itself at the next boundary, so it evicts nothing);
        partial hits re-run prefill with the shared columns' writes sent to
        TRASH; every prefilled prompt is inserted while its pages are live.
        With ``extra_inputs`` the cache is neither consulted nor filled.
        The admitted rows of the prefill's fixed leaves (cross K/V) are
        copied to their slots of the resident tree.
        """
        admitted: List[_Request] = []
        hits = []                       # (req, RowState, cache entry)
        caching = self._prefix is not None and not extra_inputs
        with annotate("serve.schedule"):
            now = time.perf_counter()
            while self._queue:
                nxt = self._queue[0]
                m = self._prefix.match(nxt.prompt) if caching else None
                shared = list(m.pages) if m is not None else []
                if not self._csched.can_admit(len(nxt.prompt),
                                              shared_pages=len(shared)):
                    if (self._csched.free_slots > 0 and caching
                            and self._prefix.evict_one()):
                        continue
                    break
                req = self._queue.pop(0)
                row = self._csched.admit(req.rid, len(req.prompt),
                                         req.max_new, shared_pages=shared)
                self._sched.admit(req)  # lockstep: same smallest free slot
                assert req.slot == row.slot
                req.tokens = []
                active[row.slot] = req
                self._record_wait(now - req.t_submit)
                if caching:
                    self._prefix.record_admit(m, len(req.prompt))
                if m is not None:
                    req.prefix_hit = (api.PREFIX_HIT_FULL if m.full
                                      else api.PREFIX_HIT_PARTIAL)
                    req.cached_prefix_tokens = m.tokens
                if m is not None and m.full:
                    hits.append((req, row, m.entry))
                else:
                    admitted.append(req)
        if hits:
            self._restore_hits(hits)
        if not admitted:
            return
        b = self.cfg.max_batch
        page = self._page_size
        with annotate("serve.schedule"):
            plen = _bucket_len(max(len(r.prompt) for r in admitted))
            # host inputs packed into one array: tokens (b, plen) |
            # kv_start (b,)
            packed = np.zeros((b, plen + 1), np.int32)
            packed[:, plen] = plen
            dest = np.broadcast_to(
                kv_pages.TRASH_PAGE * page + np.arange(plen) % page,
                (b, plen)).astype(np.int64).copy()
            for r in admitted:
                n = len(r.prompt)
                packed[r.slot, plen - n:plen] = r.prompt
                packed[r.slot, plen] = plen - n
                # columns a partial hit shares stay with TRASH: their pages
                # are the cache's, and already hold what this prefill
                # would write
                shared_toks = (r.cached_prefix_tokens
                               if r.prefix_hit == api.PREFIX_HIT_PARTIAL
                               else 0)
                logical = np.arange(shared_toks, n)
                pages = np.asarray(self._csched.rows[r.slot].pages, np.int64)
                dest[r.slot, plen - n + shared_toks:] = (
                    pages[logical // page] * page + logical % page)
        dev = torch.from_numpy(packed).to(self.device)
        batch = {"tokens": dev[:, :plen], "kv_start": dev[:, plen]}
        self._batch_extras(batch, admitted, extra_inputs)
        scratch = self._scratch_cache(plen)
        self._plen_buckets.add(plen)
        self._record_prefill_flash_tiles(plen)
        moe0 = moe_counts()
        t0 = self._clock.start()
        with annotate("serve.prefill_admit"):
            logits0, filled = self.model.prefill(
                self.params, sh.place_batch(self.mesh, self.rules, batch),
                scratch)
            logits0 = sh.full(logits0)
            dest_t = torch.from_numpy(dest)
            for pool, src in zip(self._pools, filled["self"]):
                self._scatter_pool(pool, dest_t, src)
            slot_ids = [r.slot for r in admitted]
            slots = torch.tensor(slot_ids, dtype=torch.long,
                                 device=self.device)
            if self._fixed:
                self._scatter_fixed(filled, slots, slot_ids)
            self._cur[slots] = self._sample(logits0)[slots]
        self._clock.stop(self._stats, "prefill_seconds", t0)
        moe = _moe_delta(moe0)
        real = sum(len(r.prompt) for r in admitted)
        count("serve.counts.admit", rows=len(admitted), real=real,
              computed=b * plen, routed=moe["routed"],
              expert_rows=moe["expert_rows"])
        self._stats["admission_prefills"] += 1
        self._stats["prefill_rows"] += len(admitted)
        self._stats["prefill_prompt_tokens"] += real
        self._stats["prefill_row_tokens"] += b * plen
        self._stats["moe_routed"] += moe["routed"]
        self._stats["moe_expert_rows"] += moe["expert_rows"]
        if caching:
            # Insert while the rows' pages are known-live: the cache takes
            # its own refs.  The logits row is cloned: a view would keep the
            # whole batch's (B, vocab) logits alive per entry.
            for r in admitted:
                self._prefix.insert(r.prompt, self._csched.rows[r.slot].pages,
                                    logits0[r.slot].clone(),
                                    self._slice_fixed_row(r.slot))

    def _restore_hits(self, hits) -> None:
        """Admit full-prompt prefix hits without prefill: the row's block
        table already points at the shared pages; copy the straddling page
        (COW), restore the fixed-leaf snapshot, and sample the first token
        from the cached last-position logits (bit-identical under greedy:
        the argmax runs over the exact array the cold path sampled from)."""
        t0 = self._clock.start()
        page = self._page_size
        b = self.cfg.max_batch
        with annotate("serve.prefix_restore"):
            for req, row, entry in hits:
                if entry.tail_page is not None:
                    dst = row.pages[len(req.prompt) // page]
                    for pool in self._pools:
                        paged_copy(pool if self.mesh is None
                                   else pool.to_local(),
                                   entry.tail_page, dst, page)
                if self._fixed:
                    self._restore_fixed_row(entry.fixed, row.slot)
                # noise for all max_batch rows, this row's taken
                first = self._sample(entry.logits0[None, :].expand(b, -1))
                self._cur[row.slot] = first[row.slot]
        self._clock.stop(self._stats, "prefill_seconds", t0)

    def _run_chunk(self):
        """One decode chunk over every live row.  Returns host copies of the
        chunk's token buffer (B, chunk) and counts (B,): the chunk's single
        device-to-host transfer."""
        rows = self._csched.rows
        b = self.cfg.max_batch
        chunk = self._chunk
        page = self._page_size
        with annotate("serve.schedule"):
            width = _bucket_len(max(r.length for r in rows.values()) + chunk)
            sidx = kv_pages.scatter_indices(rows, b, chunk, page)
            # host inputs packed into one array: gather idx (b, width) |
            # kv_start (b,) | budget (b,)
            packed = np.zeros((b, width + 2), np.int64)
            packed[:, :width] = kv_pages.gather_indices(rows, b, width, chunk,
                                                        page)
            packed[:, width] = width - chunk
            for slot, row in rows.items():
                packed[slot, width] = width - chunk - row.length
                packed[slot, width + 1] = row.budget_left
        moe0 = moe_counts()
        t0 = self._clock.start()
        with annotate("serve.decode_chunk"):
            dev = torch.from_numpy(packed).to(self.device)
            gidx = dev[:, :width]
            kv_start = dev[:, width].to(torch.int32)
            budget = dev[:, width + 1].to(torch.int32)
            cache = dict(self._fixed)
            with annotate("serve.kv_gather"):
                cache["self"] = tuple(self._gather_pool(pool, gidx)
                                      for pool in self._pools)
            cur = self._cur
            done = budget <= 0                  # empty slots start finished
            buf = torch.zeros((b, chunk), dtype=torch.int32,
                              device=self.device)
            lens = torch.zeros((b,), dtype=torch.int32, device=self.device)
            eos = self.cfg.eos_token
            offset = width - chunk
            for step in range(chunk):
                buf[:, step] = torch.where(done, 0, cur)
                lens += (~done).to(torch.int32)
                if eos is not None:
                    done = done | (cur == eos)
                done = done | (lens >= budget)
                # Always advance (see the module docstring): while any row
                # is live this is the reference's step; after, it is masked
                # work.  The chunk's last advance is the next chunk's first
                # token.
                logits, cache = self._decode_step(cur[:, None], cache,
                                                  offset, kv_start)
                cur = self._sample(logits)
                offset += 1
            sidx_t = torch.from_numpy(sidx)
            with annotate("serve.kv_scatter"):
                for pool, leaf in zip(self._pools, cache["self"]):
                    self._scatter_pool(pool, sidx_t, leaf.narrow(
                        leaf.ndim - 3, width - chunk, chunk))
            # the fixed leaves the chunk's last step returned (the hybrid's
            # SSM and conv states move on every token), as the reference's
            # chunk returns its new fixed tree
            self._fixed = {k: cache[k] for k in self._fixed}
            self._cur = cur
            end = self._clock.mark_end()
            # The ONE device-to-host transfer of this chunk.
            # analysis: allow(TP001)
            host = torch.cat([buf, lens[:, None]], dim=1).cpu().numpy()
        self._clock.stop(self._stats, "decode_seconds", t0, end)
        self._clock.read(self._stats)
        moe = _moe_delta(moe0)
        live = len(rows)
        count("serve.counts.chunk", rows=live, steps=chunk,
              slot_steps=b * chunk, tokens=int(host[:, chunk].sum()),
              routed=moe["routed"], expert_rows=moe["expert_rows"])
        self._stats["device_transfers"] += 1
        self._stats["chunks"] += 1
        self._stats["decode_live_row_steps"] += live * chunk
        self._stats["decode_slot_steps"] += b * chunk
        self._stats["moe_routed"] += moe["routed"]
        self._stats["moe_expert_rows"] += moe["expert_rows"]
        return host[:, :chunk], host[:, chunk]

    # -- prefix-cache control ---------------------------------------------------
    def clear_prefix_cache(self) -> None:
        """Release every cache-pinned page (cold-cache reset).  Live rows
        keep their refs."""
        if self._prefix is not None:
            self._prefix.clear()

    # -- telemetry ----------------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        """Counters, scheduler and paged-pool state, prefix-cache counters,
        latency percentiles, the kernels' launch counts (process-wide, as
        ``repro_torch.kernels`` keeps them) and the tuning provenance:
        ``hardware`` / ``hardware_platform`` (the resolved profile),
        ``decode_tile_lookups`` (None before the first decode step),
        ``prefill_flash_lookups``, ``registry_hit_stats`` (the global
        registry's resolutions by tier) and, on continuous engines,
        ``page_size_source``.  The key set is versioned in
        :mod:`repro_torch.serve.stats_schema`."""
        out: Dict[str, object] = dict(self._stats)
        out["schema_version"] = SCHEMA_VERSION
        out["hardware"] = self.hardware
        out["hardware_platform"] = self._platform
        out["mesh"] = describe_mesh(self.mesh)
        out["sharding"] = None if self.mesh is None else {
            "rules": self.rules.describe(),
            "params": sh.sharding_summary(self.mesh, self.rules,
                                          self.model.template)}
        out["device"] = str(self.device)
        out["prefill_plen_buckets"] = sorted(self._plen_buckets)
        out["scheduler"] = self._scheduler
        out["scheduler_forced"] = self._scheduler_forced
        if self._scheduler == "continuous":
            out["decode_chunk"] = self._chunk
            out["capacity_tokens"] = self._capacity_tokens
            out["page_size"] = self._page_size
            out["page_size_source"] = self._page_size_source
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
        out["prefix_cache"] = (self._prefix.stats() if self._prefix is not None
                               else PrefixCache.disabled_stats())
        out["latency"] = {
            "count": len(self._lat_tok),
            "ttft_s": _percentiles(self._lat_ttft),
            "tok_per_s": _percentiles(self._lat_tok),
            "queue_wait_s": _percentiles(self._lat_wait),
        }
        out["slots"] = self.cfg.max_batch
        out["slots_admitted"] = self._sched.admitted
        out["slots_evicted"] = self._sched.evicted
        out["slot_reuses"] = self._sched.reuses
        out["kernel_launches"] = kernels.launch_counts()
        out["decode_tile_lookups"] = self._tile_lookups
        out["prefill_flash_lookups"] = dict(self._prefill_flash_lookups)
        out["registry_hit_stats"] = dict(GLOBAL_REGISTRY.hit_stats)
        return out
