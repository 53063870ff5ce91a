"""Autotuner: guided schedule search feeding the persistent TuningDB.

The port's counterpart of the reference's ``core/tuner.py``.  A sweep
enumerates the candidates of a problem (``core.tile_config``'s tuning
spaces: schedules the ``dispatch_*`` lines instantiate and the wrapper
takes at the shape), ranks them with the analytic cost model
(``core.cost_model``), and scores either the top ``top_k``
(``search="guided"``) or all of them (``search="exhaustive"``):

* ``mode="model"``  — the cost model's estimate; runs anywhere.
* ``mode="measure"`` — the real kernel (``gemm_cuda`` /
  ``flash_attention_cuda`` with the candidate schedule) on the card, each
  launch timed alone with CUDA events on the device only: after a read of
  128 MiB that leaves L2 holding other data, and a ~1 ms device spin
  during which the host enqueues the launch (so the events bracket the
  device's work).  The best of ``repeats`` is kept; in a guided search a
  candidate whose first time is ``prune_factor`` x the incumbent's stops
  there.  It raises without a card: the plain versions have no schedule
  to time.

The cost model sees block sizes only; candidates it scores alike (the
ring depths and split counts of one ``decode`` tile) are ordered by how
close their grid comes to ``tile_config.DECODE_TARGET_BLOCKS``, then by
the config.

Winners go to the registry at once (``record=True``) and to a DB via
:func:`repro_torch.core.tuning_db.db_from_sweeps` /
``scripts/torch_tune.py``.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import cost_model
from repro_torch.core.hardware import H100, resolve_profile
from repro_torch.core.registry import GLOBAL_REGISTRY, TileRegistry
from repro_torch.core.tile_config import (
    DECODE_TARGET_BLOCKS, OP_FLASH_ATTENTION, OP_GEMM, OP_PAGED_ATTN,
    FlashTuningSpace, PagedAttentionTuningSpace, TileConfig, TuningSpace,
    _dtype_name)

SEARCH_GUIDED = "guided"
SEARCH_EXHAUSTIVE = "exhaustive"
DEFAULT_TOP_K = 8
DEFAULT_PRUNE_FACTOR = 2.0


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    config: object
    seconds: float
    gflops: float
    source: str  # "model" | "measure" | "measure-pruned"


@dataclasses.dataclass(frozen=True)
class SweepResult:
    shape: Tuple[int, ...]        # gemm (m, k, n); flash (sq, skv, d); paged (b, len)
    dtype: str
    hardware: str
    points: List[SweepPoint]      # evaluated candidates only
    op: str = OP_GEMM
    search: str = SEARCH_EXHAUSTIVE
    candidates_total: int = 0
    evaluated: int = 0
    pruned: int = 0

    @property
    def best(self) -> SweepPoint:
        return min(self.points, key=lambda p: p.seconds)


def _check(mode: str, search: str) -> None:
    if mode not in ("model", "measure"):
        raise ValueError(f"unknown mode {mode!r}")
    if search not in (SEARCH_GUIDED, SEARCH_EXHAUSTIVE):
        raise ValueError(f"unknown search {search!r}")
    if mode == "measure" and not torch.cuda.is_available():
        raise RuntimeError(
            "mode='measure' times the CUDA kernels on the card and there is "
            "no CUDA device; use mode='model' to rank by the cost model")


class DeviceTimer:
    """Best device time in seconds of ``fn`` over ``repeats`` launches, each
    after an L2 flush (a read of 128 MiB) and a device spin while the host
    enqueues it."""

    SLEEP_CYCLES = 2_000_000

    def __init__(self):
        self.flush = torch.zeros(32 * 1024 * 1024, dtype=torch.float32,
                                 device="cuda")
        self.sink = torch.zeros((), dtype=torch.float32, device="cuda")

    def __call__(self, fn: Callable[[], object], repeats: int,
                 prune_above: Optional[float] = None) -> Tuple[float, bool]:
        fn()                                    # warm up (first-use setup)
        best = float("inf")
        for i in range(repeats):
            torch.sum(self.flush, dim=0, out=self.sink)
            torch.cuda._sleep(self.SLEEP_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e-3)
            if i == 0 and prune_above is not None and best > prune_above:
                return best, True
        return best, False


_TIMER: List[DeviceTimer] = []


def _timer() -> DeviceTimer:
    if not _TIMER:
        _TIMER.append(DeviceTimer())
    return _TIMER[0]


def _tie(cfg, m: int, k: int, n: int) -> float:
    """Secondary rank of candidates the cost model scores alike: a decode
    grid's distance from the target block count (log2)."""
    if isinstance(cfg, TileConfig) and cfg.kernel == "decode":
        blocks = -(-n // cfg.bn) * -(-k // cfg.k_chunk(k))
        return abs(math.log2(blocks / DECODE_TARGET_BLOCKS))
    return 0.0


def _rank(scored: Sequence[Tuple[object, float, float]]):
    return [(cfg, secs) for cfg, secs, _ in
            sorted(scored, key=lambda s: (s[1], s[2], s[0]))]


def _evaluate(selected, flops: float, mode: str, search: str,
              prune_factor: float, repeats: int, run, expect_path):
    """Score the selected (config, estimate) pairs; returns (points, pruned).
    ``run(cfg)`` launches the kernel; ``expect_path()`` returns the
    wrapper's launch counts, to check that the candidate's kernel ran."""
    points: List[SweepPoint] = []
    pruned = 0
    if mode == "model":
        for cfg, secs in selected:
            points.append(SweepPoint(cfg, secs, flops / secs / 1e9, "model"))
        return points, pruned
    timer = _timer()
    best_so_far = float("inf")
    for cfg, _est in selected:
        before = dict(expect_path())
        run(cfg)
        if expect_path()[cfg.kernel] == before[cfg.kernel]:
            raise RuntimeError(f"schedule {cfg.schedule} did not launch its "
                               f"kernel (the wrapper took another path)")
        prune_above = (best_so_far * prune_factor
                       if search == SEARCH_GUIDED and best_so_far < float("inf")
                       else None)
        secs, was_pruned = timer(lambda c=cfg: run(c), repeats, prune_above)
        pruned += was_pruned
        best_so_far = min(best_so_far, secs)
        points.append(SweepPoint(cfg, secs, flops / secs / 1e9,
                                 "measure-pruned" if was_pruned else "measure"))
    return points, pruned


def sweep_gemm(
    m: int, k: int, n: int,
    *,
    dtype=torch.bfloat16,
    space: Optional[TuningSpace] = None,
    hardware=H100,
    mode: str = "model",
    search: str = SEARCH_GUIDED,
    top_k: int = DEFAULT_TOP_K,
    prune_factor: float = DEFAULT_PRUNE_FACTOR,
    repeats: int = 3,
    b_kmajor: bool = False,
    out_dtype=None,
    registry: Optional[TileRegistry] = None,
    record: bool = True,
    seed: int = 0,
) -> SweepResult:
    """Tune the schedule of one (m, k, n) GEMM; optionally record the winner.

    ``hardware``: a profile, a registered name, or None (detected).
    ``b_kmajor`` / ``out_dtype`` lay the measured operands out as the
    serving call does (a tied unembed reads ``embedding.t()``, K-major,
    into an f32 output)."""
    _check(mode, search)
    hardware = resolve_profile(hardware)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    space = space or TuningSpace()
    flops = 2.0 * m * k * n
    cands = list(space.candidates(dtype, m=m, k=k, n=n))
    if not cands:
        raise ValueError(f"tuning space empty for ({m},{k},{n}) "
                         f"{_dtype_name(dtype)} on {hardware.name}")
    ranked = _rank([(cfg, cost_model.gemm_cost(m, k, n, cfg, hardware, dtype,
                                               out_dtype).total_s,
                     _tie(cfg, m, k, n)) for cfg in cands])
    selected = ranked[:max(1, top_k)] if search == SEARCH_GUIDED else ranked

    run = expect = None
    if mode == "measure":
        from repro_torch.kernels.gemm import gemm_cuda
        gen = torch.Generator(device="cuda").manual_seed(seed)
        a = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
        b = (torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
             ).to(dtype)
        b = b.t() if b_kmajor else b.t().contiguous()

        def run(cfg):
            return gemm_cuda(a, b, config=cfg, out_dtype=out_dtype)

        def expect():
            return gemm_cuda.launches_by_path
    points, pruned = _evaluate(selected, flops, mode, search, prune_factor,
                               repeats, run, expect)
    result = SweepResult(shape=(m, k, n), op=OP_GEMM, dtype=_dtype_name(dtype),
                         hardware=hardware.name, points=points, search=search,
                         candidates_total=len(cands), evaluated=len(points),
                         pruned=pruned)
    if record:
        (registry or GLOBAL_REGISTRY).put(result.best.config, hardware.name,
                                          dtype, m, k, n)
    return result


def sweep_flash_attention(
    sq: int, skv: int, d: int,
    *,
    dtype=torch.bfloat16,
    causal: bool = True,
    space: Optional[FlashTuningSpace] = None,
    hardware=H100,
    mode: str = "model",
    search: str = SEARCH_GUIDED,
    top_k: int = DEFAULT_TOP_K,
    prune_factor: float = DEFAULT_PRUNE_FACTOR,
    batch: int = 1,
    heads: int = 32,
    kv_heads: int = 8,
    repeats: int = 3,
    registry: Optional[TileRegistry] = None,
    record: bool = True,
    seed: int = 0,
) -> SweepResult:
    """Tune the schedule of one flash-attention problem ``(sq, skv, d)``;
    ``batch``, ``heads`` and ``kv_heads`` size the measured operands only
    (the registry keys by ``(sq, skv, d)``)."""
    _check(mode, search)
    hardware = resolve_profile(hardware)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    space = space or FlashTuningSpace()
    # QK^T + PV per (batch, head) slice, halved when causal
    flops = 4.0 * sq * skv * d * (0.5 if causal else 1.0)
    cands = list(space.candidates(dtype, d=d))
    if not cands:
        raise ValueError(f"flash tuning space empty for ({sq},{skv},{d}) "
                         f"{_dtype_name(dtype)} on {hardware.name}")
    ranked = _rank([(cfg, cost_model.flash_cost(sq, skv, d, cfg, hardware,
                                                dtype, causal=causal).total_s,
                     0.0) for cfg in cands])
    selected = ranked[:max(1, top_k)] if search == SEARCH_GUIDED else ranked

    run = expect = None
    if mode == "measure":
        from repro_torch.kernels.flash_attention import flash_attention_cuda
        gen = torch.Generator(device="cuda").manual_seed(seed)
        q = torch.randn(batch, sq, heads, d, generator=gen,
                        device="cuda").to(dtype)
        k = torch.randn(batch, skv, kv_heads, d, generator=gen,
                        device="cuda").to(dtype)
        v = torch.randn(batch, skv, kv_heads, d, generator=gen,
                        device="cuda").to(dtype)

        def run(cfg):
            return flash_attention_cuda(q, k, v, config=cfg, causal=causal)

        def expect():
            return flash_attention_cuda.launches_by_path
        flops *= batch * heads
    points, pruned = _evaluate(selected, flops, mode, search, prune_factor,
                               repeats, run, expect)
    result = SweepResult(shape=(sq, skv, d), op=OP_FLASH_ATTENTION,
                         dtype=_dtype_name(dtype), hardware=hardware.name,
                         points=points, search=search,
                         candidates_total=len(cands), evaluated=len(points),
                         pruned=pruned)
    if record:
        (registry or GLOBAL_REGISTRY).put_op(
            OP_FLASH_ATTENTION, result.best.config, hardware.name, dtype,
            (sq, skv, d))
    return result


def sweep_paged_attention(
    max_batch: int, max_len: int,
    *,
    dtype=torch.bfloat16,
    space: Optional[PagedAttentionTuningSpace] = None,
    hardware=H100,
    mode: str = "model",
    repeats: int = 3,
    kv_heads: int = 8,
    head_dim: int = 64,
    registry: Optional[TileRegistry] = None,
    record: bool = True,
    mesh: Optional[str] = None,
) -> SweepResult:
    """Tune the paged-KV ``page_size`` for one serve pool ``(max_batch,
    max_len)``, the engine's lookup key.  ``mode="measure"`` times one
    decode chunk's data movement per candidate on the card, host index
    computation included (wall clock, ending in a synchronize);
    ``mode="model"`` ranks as the reference does: per-chunk index work
    falls as ``1 / page_size`` while last-page waste grows with it."""
    _check(mode, SEARCH_EXHAUSTIVE)
    hardware = resolve_profile(hardware)
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    space = space or PagedAttentionTuningSpace()
    cands = list(space.candidates(max_len=max_len))
    if not cands:
        raise ValueError(f"paged-KV tuning space empty for "
                         f"({max_batch},{max_len}) on {hardware.name}")
    tokens = float(max_batch * max_len)

    def model_cost(page_size: int) -> float:
        overhead = tokens / page_size
        waste = max_batch * (page_size - 1) / 2.0
        return (tokens + 4.0 * overhead + 2.0 * waste) * 1e-9

    points: List[SweepPoint] = []
    if mode == "model":
        points = [SweepPoint(cfg, model_cost(cfg.page_size), 0.0, "model")
                  for cfg in cands]
    else:
        import numpy as np

        from repro_torch.kernels.paged import paged_gather, paged_scatter
        from repro_torch.serve import kv_pages
        chunk, width = 8, min(64, max_len)
        for cfg in cands:
            p = cfg.page_size
            alloc = kv_pages.PageAllocator(max_batch * max_len, p)
            sched = kv_pages.ContinuousScheduler(max_batch, alloc)
            rng = np.random.default_rng(0)
            for rid in range(max_batch):
                sched.admit(rid, int(rng.integers(1, width - chunk + 1)),
                            budget=chunk)
            sched.ensure_chunk_pages(chunk)
            pool = torch.zeros((alloc.num_pages * p, kv_heads, head_dim),
                               dtype=dtype, device="cuda")
            cols = torch.ones((max_batch, chunk, kv_heads, head_dim),
                              dtype=dtype, device="cuda")

            def step(p=p, sched=sched, pool=pool, cols=cols):
                gidx = kv_pages.gather_indices(sched.rows, max_batch, width,
                                               chunk, p)
                sidx = kv_pages.scatter_indices(sched.rows, max_batch, chunk,
                                                p)
                paged_gather(pool, gidx)
                paged_scatter(pool, sidx, cols)
                torch.cuda.synchronize()
            step()
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                step()
                best = min(best, time.perf_counter() - t0)
            points.append(SweepPoint(cfg, best, 0.0, "measure"))
    result = SweepResult(shape=(max_batch, max_len), op=OP_PAGED_ATTN,
                         dtype=_dtype_name(dtype), hardware=hardware.name,
                         points=points, search=SEARCH_EXHAUSTIVE,
                         candidates_total=len(cands), evaluated=len(points))
    if record:
        (registry or GLOBAL_REGISTRY).put_op(
            OP_PAGED_ATTN, result.best.config, hardware.name, dtype,
            (max_batch, max_len), mesh=mesh)
    return result


def tune_model_gemms(shapes, *, dtype=torch.bfloat16, hardware=H100,
                     registry: Optional[TileRegistry] = None,
                     search: str = SEARCH_GUIDED) -> dict:
    """Model-mode tune of every (m, k, n) a model runs (collected with
    ``core.capture_gemm_shapes``); returns {shape: best TileConfig}."""
    out = {}
    for (m, k, n) in sorted(set(shapes)):
        res = sweep_gemm(m, k, n, dtype=dtype, hardware=hardware,
                         mode="model", search=search, registry=registry)
        out[(m, k, n)] = res.best.config
    return out


def sweep_shapes(shapes, *, dtype=torch.bfloat16, hardware=H100,
                 mode: str = "model", search: str = SEARCH_GUIDED,
                 registry: Optional[TileRegistry] = None,
                 **kw) -> List[SweepResult]:
    """Sweep a list of (m, k, n) problems; returns their SweepResults."""
    return [sweep_gemm(m, k, n, dtype=dtype, hardware=hardware, mode=mode,
                       search=search, registry=registry, **kw)
            for (m, k, n) in shapes]
