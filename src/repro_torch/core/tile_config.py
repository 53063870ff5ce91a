"""Tile sizes carried outside the kernels (paper Listing 1.1), H100 defaults.

``TileConfig`` holds every schedule choice of the GEMM kernels: the block
sizes ``(bm, bk, bn)``, which of the kernels in ``kernels/csrc/gemm.cu``
runs (``kernel``), the depth of its shared-memory ring (``stages``), the
split count over K (``split_k``) and the wgmma kernel's raster grouping
(``group_m``).  ``FlashAttentionConfig`` is the flash kernels': query
rows and KV columns per block, the kernel and its ring depth.  The kernels
take them as launch arguments and never choose them; this module's small
tables of H100 defaults do.  The registry,
tuning DB and tuner come later.

Every tile here has a template instantiation in ``kernels/csrc``; a tile
without one makes the wrapper raise.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

@dataclasses.dataclass(frozen=True, order=True)
class TileConfig:
    """Schedule of one GEMM launch.  Hashable.

    ``kernel``: ``wmma`` (bf16 tensor cores through WMMA), ``fma`` (f32),
    ``decode`` (bf16 small M: mma.sync with the operands swapped, split-K)
    or ``wgmma`` (bf16 large M: TMA + wgmma, warp-specialised).
    ``stages``: shared-memory ring depth of ``decode`` and ``wgmma``.
    ``split_k``: the number of K chunks ``decode`` cuts K into.
    ``group_m``: ``wgmma`` walks output tiles in columns of this many rows
    of tiles, so that a wave's A and B panels stay in L2.
    """
    bm: int = 64
    bk: int = 32
    bn: int = 64
    kernel: str = "wmma"
    stages: int = 1
    split_k: int = 1
    group_m: int = 1

    @property
    def label(self) -> str:
        return f"{self.bm}x{self.bk}x{self.bn}"

    def k_chunk(self, k: int) -> int:
        """``decode``: the K elements each split sums, a multiple of ``bk``;
        a launch over K has ``ceil(k / k_chunk(k))`` splits."""
        k_steps = max(1, -(-k // self.bk))
        return -(-k_steps // self.split_k) * self.bk

    @property
    def schedule(self) -> str:
        """``label`` with the kernel, ring depth and split count."""
        extra = f"/s{self.stages}" if self.stages > 1 else ""
        extra += f"/k{self.split_k}" if self.split_k > 1 else ""
        extra += f"/g{self.group_m}" if self.group_m > 1 else ""
        return f"{self.kernel}:{self.label}{extra}"


@dataclasses.dataclass(frozen=True, order=True)
class FlashAttentionConfig:
    """Schedule of one flash-attention launch.  Hashable.

    ``kernel``: ``fma`` (f32 FMA; ``bq`` query positions of one head per
    block) or ``wgmma`` (bf16 TMA + wgmma; ``bq`` packed query rows per
    block, the G = H / KV heads of a KV head times ``bq / G`` positions,
    64 rows per consumer warpgroup).  ``bk``: KV columns per tile.
    ``stages``: depth of ``wgmma``'s K / V ring.
    """
    bq: int = 64
    bk: int = 64
    kernel: str = "fma"
    stages: int = 1

    @property
    def label(self) -> str:
        return f"{self.bq}x{self.bk}"

    @property
    def schedule(self) -> str:
        """``label`` with the kernel and ring depth."""
        extra = f"/s{self.stages}" if self.stages > 1 else ""
        return f"{self.kernel}:{self.label}{extra}"


#: H100 defaults, by input dtype: (largest M, largest N, tile), first match.
#: bf16 with M <= 16 (decode) streams the weights through the ``decode``
#: kernel, whose split count comes from ``decode_split_k`` (K and N only);
#: a 3-deep ring (3 blocks an SM) streams the 128256-column unembed best.
#: Larger M (prefill) runs ``wgmma`` on 128 x 256 tiles walked in columns of
#: 16 tile rows, and on 128 x 64 tiles at small N so that the grid still
#: covers the 132 SMs.  f32 runs on FMA threads.  Set from
#: ``scripts/torch_gemm_sweep.py`` on an H100 SXM at 700 W.
H100_GEMM_TILES = {
    torch.bfloat16: (
        (16, 32768, TileConfig(16, 128, 64, kernel="decode", stages=4)),
        (16, None, TileConfig(16, 128, 64, kernel="decode", stages=3)),
        (None, 512, TileConfig(128, 64, 64, kernel="wgmma", stages=6)),
        (None, None, TileConfig(128, 64, 256, kernel="wgmma", stages=4,
                                group_m=16)),
    ),
    torch.float32: (
        (16, None, TileConfig(16, 16, 128, kernel="fma")),
        (None, None, TileConfig(64, 16, 64, kernel="fma")),
    ),
}
#: bf16 operands that neither ``decode`` nor ``wgmma`` can take (a base
#: address or row stride that is not a multiple of 16 bytes): WMMA, by M.
H100_UNALIGNED_TILES = (
    (16, TileConfig(16, 64, 64)),
    (256, TileConfig(64, 32, 64)),
    (None, TileConfig(128, 32, 128)),
)
#: blocks a ``decode`` launch aims at: about two per SM of the H100's 132
DECODE_TARGET_BLOCKS = 256

#: H100 flash-attention defaults, by input dtype: (largest head dim,
#: largest S, tile), first match.  bf16 runs the ``wgmma`` kernel: at d = 64
#: one consumer warpgroup a block (64 rows), four blocks an SM with 64-column
#: KV tiles up to 1024 query positions and three with 128-column tiles
#: beyond; at d = 128 two warpgroups a block (128 rows).  f32, and bf16
#: operands the wgmma kernel does not take (the wrapper decides before the
#: launch), run ``fma`` with the float32 rows.  Set from
#: ``scripts/torch_flash_sweep.py`` on an H100 SXM at 700 W.
H100_FLASH_TILES = {
    torch.bfloat16: (
        (64, 1024, FlashAttentionConfig(64, 64, kernel="wgmma", stages=2)),
        (64, None, FlashAttentionConfig(64, 128, kernel="wgmma", stages=2)),
        (None, None, FlashAttentionConfig(128, 128, kernel="wgmma", stages=2)),
    ),
    torch.float32: (
        (None, 32, FlashAttentionConfig(32, 64)),
        (None, None, FlashAttentionConfig(64, 64)),
    ),
}


def decode_split_k(k: int, n: int, tile: TileConfig) -> int:
    """Split count of a ``decode`` launch: the power of two that brings
    ``ceil(n / bn) * split`` nearest above ``DECODE_TARGET_BLOCKS``, at most
    one ``bk`` step per split.  Depends on (k, n) only, never on M, so a
    row computes the same bits in a batch of 8 as alone."""
    col_tiles = -(-n // tile.bn)
    k_steps = max(1, -(-k // tile.bk))
    split = 1
    while col_tiles * split < DECODE_TARGET_BLOCKS and split < k_steps:
        split *= 2
    return min(split, k_steps)


@functools.lru_cache(maxsize=4096)
def gemm_tiles(dtype: torch.dtype, m: int, k: int, n: int,
               aligned: bool = True) -> TileConfig:
    """The H100 table's GEMM schedule for an (m, k, n) product of ``dtype``.

    ``aligned=False`` is for bf16 operands the TMA and ``cp.async`` paths
    cannot take; the wrapper decides it from the strides before a launch.
    Cached: a decode step asks for the same few shapes 113 times.
    """
    try:
        table = H100_GEMM_TILES[dtype]
    except KeyError:
        raise TypeError(f"no GEMM tiles for {dtype}") from None
    if dtype == torch.bfloat16 and not aligned:
        for max_m, tile in H100_UNALIGNED_TILES:
            if max_m is None or m <= max_m:
                return tile
    for max_m, max_n, tile in table:
        if (max_m is None or m <= max_m) and (max_n is None or n <= max_n):
            if tile.kernel == "decode":
                tile = dataclasses.replace(
                    tile, split_k=decode_split_k(k, n, tile))
            return tile
    raise AssertionError("unreachable: the last row takes every M and N")


def flash_tiles(dtype: torch.dtype, sq: int, skv: int,
                d: int) -> FlashAttentionConfig:
    """The H100 table's flash-attention schedule for ``dtype`` operands of
    (sq, skv, d)."""
    try:
        table = H100_FLASH_TILES[dtype]
    except KeyError:
        raise TypeError(f"no flash-attention tiles for {dtype}") from None
    for max_d, max_sq, tile in table:
        if (max_d is None or d <= max_d) and (max_sq is None or sq <= max_sq):
            return tile
    raise AssertionError("unreachable: the last row takes every d and S")
