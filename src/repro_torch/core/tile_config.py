"""Tile sizes carried outside the kernels (paper Listing 1.1), H100 defaults.

``TileConfig`` holds every schedule choice of the GEMM kernels: the block
sizes ``(bm, bk, bn)``, which of the kernels in ``kernels/csrc/gemm.cu``
runs (``kernel``), the depth of its shared-memory ring (``stages``), the
split count over K (``split_k``) and the wgmma kernel's raster grouping
(``group_m``).  ``FlashAttentionConfig`` is the flash kernels': query
rows and KV columns per block, the kernel and its ring depth.
``PagedAttentionConfig`` is the serve engine's KV page size and
``DecodeLoopConfig`` the reference's decode-loop unroll (kept so that one
tuning file carries every op of the reference's schema).  The kernels take
them as launch arguments and never choose them: the tuning registry
(``core.registry``) does, from a measured table, with this module's hand
tables of H100 defaults as its default tier.

``block_of`` / ``config_from_block`` flatten a config to the integer tuple
a tuning record stores (a kernel name as its ``KERNEL_CODES`` integer).
``TuningSpace``, ``FlashTuningSpace`` and ``PagedAttentionTuningSpace``
enumerate the candidates the tuner sweeps: every GEMM or flash candidate is
a schedule the ``dispatch_*`` lines of ``kernels/csrc`` instantiate, that
the wrapper takes at the problem's shape (``gemm_takes``, ``flash_takes``).

Every tile here has a template instantiation in ``kernels/csrc``; a tile
without one makes the wrapper raise.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gemm as _gemm

@dataclasses.dataclass(frozen=True, order=True)
class TileConfig:
    """Schedule of one GEMM launch.  Hashable.

    ``kernel``: ``wmma`` (bf16 tensor cores through WMMA), ``fma`` (f32,
    small M), ``simt`` (f32 larger M: 8 x 8 outputs a thread, double
    buffered), ``decode`` (bf16 small M: mma.sync with the operands
    swapped, split-K) or ``wgmma`` (bf16 large M: TMA + wgmma,
    warp-specialised).
    ``stages``: shared-memory ring depth of ``decode`` and ``wgmma``.
    ``split_k``: the number of K chunks ``decode`` cuts K into.
    ``group_m``: ``wgmma`` and ``simt`` walk output tiles in columns of this
    many rows of tiles, so that a wave's A and B panels stay in L2.
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
#: covers the 132 SMs.  f32 up to M = 16 (the f32 oracles' decode) runs
#: ``fma``; larger M (the unembed's f32 backward in training) ``simt``,
#: which sums every output in the same order, so the two give the same
#: bits.  Set from ``scripts/torch_gemm_sweep.py`` on an H100 SXM at 700 W
#: (f32: ``--f32``).
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
        (None, 1280, TileConfig(128, 8, 64, kernel="simt")),
        (None, None, TileConfig(128, 16, 128, kernel="simt", group_m=16)),
    ),
}
#: operands the table's kernel cannot take, by input dtype: (largest M,
#: tile), first match.  bf16 that neither ``decode`` nor ``wgmma`` can take
#: (a base address or row stride that is not a multiple of 16 bytes) runs
#: WMMA; f32 that ``simt`` cannot take (not a multiple of 8 bytes) ``fma``.
H100_UNALIGNED_TILES = {
    torch.bfloat16: (
        (16, TileConfig(16, 64, 64)),
        (256, TileConfig(64, 32, 64)),
        (None, TileConfig(128, 32, 128)),
    ),
    torch.float32: (
        (16, TileConfig(16, 16, 128, kernel="fma")),
        (None, TileConfig(64, 16, 64, kernel="fma")),
    ),
}
#: blocks a ``decode`` launch aims at: about two per SM of the H100's 132
DECODE_TARGET_BLOCKS = 256

#: H100 flash-attention defaults, by input dtype: (largest head dim,
#: largest S, tile), first match.  bf16 runs the ``wgmma`` kernel: at d = 64
#: one consumer warpgroup a block (64 rows), four blocks an SM with 64-column
#: KV tiles up to 1024 query positions and three with 128-column tiles
#: beyond; at d = 80 and 128 two warpgroups a block (128 rows); at d = 160
#: two warpgroups with 64-column KV tiles (with 128-column ones the tiles
#: exceed shared memory there).  f32, and bf16
#: operands the wgmma kernel does not take (the wrapper decides before the
#: launch), run ``fma`` with the float32 rows.  Set from
#: ``scripts/torch_flash_sweep.py`` on an H100 SXM at 700 W.
H100_FLASH_TILES = {
    torch.bfloat16: (
        (64, 1024, FlashAttentionConfig(64, 64, kernel="wgmma", stages=2)),
        (64, None, FlashAttentionConfig(64, 128, kernel="wgmma", stages=2)),
        (128, None, FlashAttentionConfig(128, 128, kernel="wgmma", stages=2)),
        (None, None, FlashAttentionConfig(128, 64, kernel="wgmma", stages=2)),
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

    ``aligned=False`` is for operands the table's kernel cannot take (bf16
    off the TMA and ``cp.async`` paths, f32 off ``simt``'s vector loads);
    the wrapper decides it from the strides before a launch.
    Cached: a decode step asks for the same few shapes 113 times.
    """
    try:
        table = H100_GEMM_TILES[dtype]
    except KeyError:
        raise TypeError(f"no GEMM tiles for {dtype}") from None
    if not aligned:
        for max_m, tile in H100_UNALIGNED_TILES[dtype]:
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


# ---------------------------------------------------------------------------
# The serve engine's knobs: paged KV page size, the reference's decode loop
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, order=True)
class PagedAttentionConfig:
    """Tokens a KV page holds in the serve engine's paged pool.  Small pages
    waste less of a request's last page; large ones keep the per-chunk
    gather / scatter index lists short."""
    page_size: int = 16

    @property
    def label(self) -> str:
        return f"p{self.page_size}"

    schedule = label


@dataclasses.dataclass(frozen=True, order=True)
class DecodeLoopConfig:
    """Tokens each iteration of the reference's fused decode loop decodes.
    The port's decode has no fused device loop and never looks it up; the
    config exists so that a tuning file with ``decode_loop`` entries loads."""
    unroll: int = 1

    @property
    def label(self) -> str:
        return f"u{self.unroll}"

    schedule = label


AnyConfig = Union[TileConfig, FlashAttentionConfig, PagedAttentionConfig,
                  DecodeLoopConfig]

#: op names: the kernel families (and engine knobs) the tuning framework keys
OP_GEMM = "gemm"
OP_FLASH_ATTENTION = "flash_attention"
OP_DECODE_LOOP = "decode_loop"
OP_PAGED_ATTN = "paged_attn"
CONFIG_CLASS = {OP_GEMM: TileConfig, OP_FLASH_ATTENTION: FlashAttentionConfig,
                OP_DECODE_LOOP: DecodeLoopConfig,
                OP_PAGED_ATTN: PagedAttentionConfig}
#: the integer code a block stores for each op's ``kernel`` field
_CODES = {OP_GEMM: _gemm.KERNEL_CODES, OP_FLASH_ATTENTION: _fa.KERNEL_CODES}


def hand_config(op: str, dtype, shape) -> Optional[AnyConfig]:
    """The hand tables' schedule for one ``op`` query (``gemm_tiles`` at
    (m, k, n), ``flash_tiles`` at (sq, skv, d)); None for the engine knobs,
    a query without a shape, or a type the kernels do not take.  The
    wrapper's own unaligned-operand rule picks the WMMA rows at launch."""
    if shape is None or op not in (OP_GEMM, OP_FLASH_ATTENTION):
        return None
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    try:
        if op == OP_GEMM:
            return gemm_tiles(dtype, *shape)
        return flash_tiles(dtype, *shape)
    except TypeError:
        return None


def block_of(cfg: AnyConfig) -> Tuple[int, ...]:
    """Flatten a config to the integer tuple a tuning record stores: its
    fields in order, the ``kernel`` name as its ``KERNEL_CODES`` integer
    (the reference's records cast every block element to ``int``)."""
    op = next(o for o, cls in CONFIG_CLASS.items() if isinstance(cfg, cls))
    codes = _CODES.get(op, {})
    return tuple(codes[v] if f.name == "kernel" else int(v)
                 for f, v in zip(dataclasses.fields(cfg),
                                 dataclasses.astuple(cfg)))


def config_from_block(op: str, block: Sequence[int]) -> AnyConfig:
    """Rebuild ``op``'s config from a block tuple.  A shorter block fills
    the remaining fields with their defaults: a legacy GEMM record's
    ``(bm, bk, bn)`` loads as that WMMA tile."""
    try:
        cls = CONFIG_CLASS[op]
    except KeyError:
        raise ValueError(f"unknown op {op!r}; known: {sorted(CONFIG_CLASS)}")
    fields = dataclasses.fields(cls)
    if len(block) > len(fields):
        raise ValueError(f"op {op!r} takes at most {len(fields)} block "
                         f"values, got {tuple(block)}")
    names = {v: k for k, v in _CODES.get(op, {}).items()}
    kw = {}
    for f, v in zip(fields, block):
        if f.name == "kernel":
            if int(v) not in names:
                raise ValueError(f"op {op!r}: unknown kernel code {v}")
            kw[f.name] = names[int(v)]
        else:
            kw[f.name] = int(v)
    return cls(**kw)


# ---------------------------------------------------------------------------
# Candidate spaces: instantiated schedules the wrapper takes at the shape
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _gemm_instantiated():
    return {k: frozenset(v) for k, v in _gemm.instantiated_schedules().items()}


@functools.lru_cache(maxsize=None)
def _flash_instantiated():
    return {k: dict(v) for k, v in _fa.instantiated_head_dims().items()}


def _dtype_name(dtype) -> str:
    return dtype if isinstance(dtype, str) else str(dtype).split(".")[-1]


def gemm_kernel_for(dtype, m: int) -> Optional[str]:
    """The kernel a GEMM of ``dtype`` with ``m`` rows runs on aligned
    operands: up to ``DECODE_MAX_M`` rows ``decode`` (bf16) or ``fma``
    (f32), beyond it ``wgmma`` or ``simt``; None for a type no kernel
    takes."""
    dt = _dtype_name(dtype)
    small = m <= _gemm.DECODE_MAX_M
    if dt == "bfloat16":
        return "decode" if small else "wgmma"
    if dt == "float32":
        return "fma" if small else "simt"
    return None


def gemm_takes(cfg: TileConfig, dtype, m: int) -> bool:
    """Whether ``cfg`` is an instantiated schedule of the kernel an (m, k,
    n) product of ``dtype`` runs on (``gemm_kernel_for``)."""
    return (cfg.kernel == gemm_kernel_for(dtype, m)
            and (cfg.bm, cfg.bk, cfg.bn, cfg.stages)
            in _gemm_instantiated().get(cfg.kernel, ()))


def flash_kernel_for(dtype, d: int) -> str:
    """``wgmma`` for bf16 at a head dim one of its lines instantiates, else
    ``fma`` (which the wrapper also runs for bf16 operands ``wgmma`` does
    not take)."""
    if _dtype_name(dtype) == "bfloat16" and any(
            d in dims for dims in _flash_instantiated()["wgmma"].values()):
        return "wgmma"
    return "fma"


def flash_takes(cfg: FlashAttentionConfig, dtype, d: int) -> bool:
    """Whether ``cfg`` is a schedule of ``flash_kernel_for(dtype, d)`` whose
    ``dispatch_*`` line instantiates head dim ``d``."""
    dims = _flash_instantiated().get(cfg.kernel, {}).get(
        (cfg.bq, cfg.bk, cfg.stages), ())
    return cfg.kernel == flash_kernel_for(dtype, d) and d in dims


@dataclasses.dataclass(frozen=True)
class TuningSpace:
    """GEMM candidates: every schedule ``gemm.cu`` instantiates for the
    kernel the shape runs on, crossed with the split count (``decode``:
    powers of two up to one ``bk`` step a split, each distinct K chunk
    once) or the raster grouping (``wgmma``, ``simt``: up to the tile rows
    M has).
    The hand table's schedule is always among them."""
    split_k_candidates: Sequence[int] = (1, 2, 4, 8, 16, 32)
    group_m_candidates: Sequence[int] = (1, 4, 8, 16)

    def candidates(self, in_dtype=torch.bfloat16, m: int = None,
                   k: int = None, n: int = None) -> Iterator[TileConfig]:
        kernel = gemm_kernel_for(in_dtype, m)
        if kernel is None:
            return
        out = {}
        for bm, bk, bn, stages in sorted(_gemm_instantiated()[kernel]):
            base = TileConfig(bm, bk, bn, kernel=kernel, stages=stages)
            if kernel == "decode":
                chunks = set()
                for s in self.split_k_candidates:
                    cfg = dataclasses.replace(base, split_k=s)
                    chunk = cfg.k_chunk(k)
                    if s > max(1, -(-k // bk)) or chunk in chunks:
                        continue
                    chunks.add(chunk)
                    out[cfg] = None
            elif kernel in ("wgmma", "simt"):
                rows = -(-m // bm)
                for g in self.group_m_candidates:
                    if g == 1 or g <= rows:
                        out[dataclasses.replace(base, group_m=g)] = None
            else:
                out[base] = None
        hand = gemm_tiles(torch.float32 if kernel in _gemm.F32_KERNELS
                          else torch.bfloat16, m, k, n)
        if not any(_same_launch(hand, c, k) for c in out):
            out[hand] = None
        yield from out


def _same_launch(a: TileConfig, b: TileConfig, k: int) -> bool:
    """Whether two schedules launch the same kernel the same way over K."""
    if a.kernel == b.kernel == "decode":
        return (dataclasses.replace(a, split_k=1)
                == dataclasses.replace(b, split_k=1)
                and a.k_chunk(k) == b.k_chunk(k))
    return a == b


@dataclasses.dataclass(frozen=True)
class FlashTuningSpace:
    """Flash candidates: every schedule of ``flash_kernel_for(dtype, d)``
    whose ``dispatch_*`` line instantiates head dim ``d``."""

    def candidates(self, in_dtype=torch.bfloat16, d: int = 64
                   ) -> Iterator[FlashAttentionConfig]:
        kernel = flash_kernel_for(in_dtype, d)
        for (bq, bk, stages), dims in sorted(
                _flash_instantiated()[kernel].items()):
            if d in dims:
                yield FlashAttentionConfig(bq, bk, kernel=kernel, stages=stages)


@dataclasses.dataclass(frozen=True)
class PagedAttentionTuningSpace:
    """Candidate page sizes (powers of two, so pages tile the power-of-two
    decode-width buckets)."""
    page_candidates: Sequence[int] = (8, 16, 32, 64)

    def candidates(self, max_len: int = None
                   ) -> Iterator[PagedAttentionConfig]:
        for p in self.page_candidates:
            if max_len is None or p <= max_len:
                yield PagedAttentionConfig(page_size=p)
