"""Tile sizes carried outside the kernels (paper Listing 1.1), H100 defaults.

``TileConfig(bm, bk, bn)`` are the GEMM kernel's block sizes and
``FlashAttentionConfig(bq, bk)`` the flash kernel's.  The kernels take them
as launch arguments and never choose them; this module's one small table
of H100 defaults does.  The registry, tuning DB and tuner come later.

Every tile here has a template instantiation in ``kernels/csrc``; a tile
without one makes the wrapper raise.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True, order=True)
class TileConfig:
    """Block sizes of the GEMM kernel.  Hashable."""
    bm: int = 64
    bk: int = 32
    bn: int = 64

    @property
    def label(self) -> str:
        return f"{self.bm}x{self.bk}x{self.bn}"


@dataclasses.dataclass(frozen=True, order=True)
class FlashAttentionConfig:
    """Block sizes of the flash-attention kernel: query rows x KV columns."""
    bq: int = 64
    bk: int = 64

    @property
    def label(self) -> str:
        return f"{self.bq}x{self.bk}"


#: H100 defaults, by input dtype: (largest M, tile) in increasing M.  bf16
#: runs on the tensor cores (4 warps of WMMA), f32 on 16 x 16 FMA threads.
#: Decode (M = max_batch) takes the 16-row tile; prefill the large ones.
H100_GEMM_TILES = {
    torch.bfloat16: ((16, TileConfig(16, 64, 64)),
                     (256, TileConfig(64, 32, 64)),
                     (None, TileConfig(128, 32, 128))),
    torch.float32: ((16, TileConfig(16, 16, 128)),
                    (None, TileConfig(64, 16, 64))),
}
H100_FLASH_TILES = ((32, FlashAttentionConfig(32, 64)),
                    (None, FlashAttentionConfig(64, 64)))


def gemm_tiles(dtype: torch.dtype, m: int, k: int, n: int) -> TileConfig:
    """The H100 table's GEMM tile for an (m, k, n) product of ``dtype``."""
    try:
        table = H100_GEMM_TILES[dtype]
    except KeyError:
        raise TypeError(f"no GEMM tiles for {dtype}") from None
    for max_m, tile in table:
        if max_m is None or m <= max_m:
            return tile
    raise AssertionError("unreachable: the last row takes every M")


def flash_tiles(sq: int, skv: int, d: int) -> FlashAttentionConfig:
    """The H100 table's flash-attention blocks for (sq, skv, d)."""
    for max_sq, tile in H100_FLASH_TILES:
        if max_sq is None or sq <= max_sq:
            return tile
    raise AssertionError("unreachable: the last row takes every S")
