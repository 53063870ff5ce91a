"""Analytic per-schedule cost model: the reference's ``core/cost_model.py``
(paper Eqs. 2, 5-7) with the same formulas, fed by a hardware profile's
numbers (``core.hardware``; the ``h100`` profile by default).

It only ranks candidates for the tuner's guided search.  It sees a
schedule's block sizes and nothing of the port's kernels' other choices
(ring depth, split count, raster grouping): it is not a claim about how
long a kernel takes on the card, which only a measured sweep says.

  compute time   = useful_flops / (peak * mxu_utilization(tiles))
  hbm time       = hbm_traffic(tiles) / hbm_bw     (paper Eq. 6)
  overhead       = per-grid-step fixed cost

  t_est = max(compute, hbm) + overhead
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.hardware import H100, HardwareProfile
from repro_torch.core.tile_config import FlashAttentionConfig, TileConfig

#: fixed cost per grid step (the reference's constant)
GRID_STEP_OVERHEAD_S = 5e-8


@dataclasses.dataclass(frozen=True)
class GemmCost:
    compute_s: float
    hbm_s: float
    overhead_s: float
    flops: int
    hbm_bytes: int

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.hbm_s) + self.overhead_s


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _itemsize(dtype) -> int:
    return (getattr(torch, dtype) if isinstance(dtype, str) else dtype).itemsize


def mxu_utilization(cfg: TileConfig, hw: HardwareProfile, in_dtype) -> float:
    """Fraction of the matrix unit's cycles doing useful work for this
    block shape (small or misaligned blocks waste rows and columns)."""
    sub = hw.sublane * (2 if _itemsize(in_dtype) == 2 else 1)
    eff_m = min(cfg.bm / sub, 16.0) / 16.0 if cfg.bm < 128 else 1.0
    eff_n = min(cfg.bn, hw.mxu_dim) / hw.mxu_dim
    eff_k = min(cfg.bk, hw.mxu_dim) / hw.mxu_dim
    return max(min(eff_m, 1.0), 0.05) * eff_n * eff_k


def gemm_cost(m: int, k: int, n: int, cfg: TileConfig,
              hw: HardwareProfile = H100, in_dtype=torch.bfloat16,
              out_dtype=None) -> GemmCost:
    out_dtype = out_dtype or in_dtype
    s_in = _itemsize(in_dtype)
    s_out = _itemsize(out_dtype)

    gm, gk, gn = _ceil_div(m, cfg.bm), _ceil_div(k, cfg.bk), _ceil_div(n, cfg.bn)
    mp, kp, np_ = gm * cfg.bm, gk * cfg.bk, gn * cfg.bn   # padded dims

    issued_flops = 2 * mp * kp * np_
    useful_flops = 2 * m * k * n

    peak = hw.peak_for(in_dtype)
    compute_s = issued_flops / (peak * mxu_utilization(cfg, hw, in_dtype))

    # paper Eq. 6, rectangular: every (i, j) output tile streams its A row
    # panel and B column panel once, plus the C write
    hbm_bytes = (gn * mp * kp * s_in) + (gm * kp * np_ * s_in) \
        + mp * np_ * s_out
    hbm_s = hbm_bytes / hw.hbm_bandwidth

    overhead_s = gm * gn * gk * GRID_STEP_OVERHEAD_S

    return GemmCost(compute_s=compute_s, hbm_s=hbm_s, overhead_s=overhead_s,
                    flops=useful_flops, hbm_bytes=hbm_bytes)


def ratio_model(n: int, t: int) -> float:
    """Paper Eq. 7: R(N, T) = 2NT / (2N + T)."""
    return 2.0 * n * t / (2.0 * n + t)


def flash_cost(sq: int, skv: int, d: int, cfg: FlashAttentionConfig,
               hw: HardwareProfile = H100, in_dtype=torch.bfloat16,
               causal: bool = True) -> GemmCost:
    """Cost of one (batch, head) slice of flash attention: per query block
    the whole K and V stream once, so the bytes fall as ``1 / bq``."""
    s_in = _itemsize(in_dtype)

    gq, gk = _ceil_div(sq, cfg.bq), _ceil_div(skv, cfg.bk)
    sq_p, skv_p = gq * cfg.bq, gk * cfg.bk

    # QK^T and PV: 4 * sq * skv * d
    issued_flops = 4 * sq_p * skv_p * d
    useful = 4 * sq * skv * d
    if causal:
        useful //= 2

    peak = hw.peak_for(in_dtype)
    util_k = min(cfg.bk, hw.mxu_dim) / hw.mxu_dim
    util_d = min(d, hw.mxu_dim) / hw.mxu_dim
    compute_s = issued_flops / (peak * max(util_k * util_d, 0.05))

    # q read once, o written once, K and V re-read once per query block
    hbm_bytes = (sq_p * d + sq_p * d) * s_in + gq * (2 * skv_p * d) * s_in
    hbm_s = hbm_bytes / hw.hbm_bandwidth

    overhead_s = gq * gk * GRID_STEP_OVERHEAD_S

    return GemmCost(compute_s=compute_s, hbm_s=hbm_s, overhead_s=overhead_s,
                    flops=useful, hbm_bytes=hbm_bytes)
