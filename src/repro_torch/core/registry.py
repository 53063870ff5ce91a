"""Tuned-parameter lookup: the runtime face of the tuning database.

The port's counterpart of the reference's ``core/registry.py``: a
thread-safe registry keyed by **(op, hardware, dtype)** with per-shape
tuned entries.  ``op`` names the kernel family or engine knob (``gemm``,
``flash_attention``, ``decode_loop``, ``paged_attn``).  Model code never
asks it: ``core.matmul`` and ``core.flash_attention`` do, for CUDA
tensors, and pass the schedule to the kernel as a launch argument.

Resolution order of ``lookup_op(op, hardware, dtype, shape)``:

1. **exact**   — a tuned entry for this shape;
2. **nearest** — the tuned entry of the closest shape (sum of |log2|
   distances over the dims, at most ``NEAREST_MAX_LOG2_DIST``; ties go to
   the smaller shape);
3. **generic** — a shape-agnostic tuned entry for (op, hardware, dtype);
4. **default** — the hardware profile's default tier (the ``h100``
   profile's is the hand tables of ``core.tile_config``);
5. **fallback** — for a profile with no default tier (``cpu``), or an
   unregistered hardware name (after a once-per-process warning): the
   kernels' hand tables (``tile_config.hand_config``), which the wrapper
   takes for any card the ``sm_90a`` kernels run on, else the op's
   default config.  So a CUDA tensor served under the ``cpu`` profile runs
   the schedules it runs under ``h100``'s default tier.

Three rules are the port's own:

a. **The decode regime is one key.**  A bf16 GEMM entry or lookup with
   M <= 16 is stored and looked up with M taken as 16 (``key_shape``).
   Otherwise a tuned decode schedule could differ between M = 8 and M = 1,
   and a row decoded in a batch would stop being bit-equal to the same row
   decoded alone (the reason ``tile_config.decode_split_k`` depends on K
   and N only).
b. **A tier returns only a schedule the wrapper takes for the query**: the
   kernel of the query's regime (``decode`` for M <= 16, ``wgmma`` beyond,
   ``fma`` for f32; for flash, ``wgmma`` in bf16 at a head dim it is
   instantiated for), instantiated in ``kernels/csrc``.  A tuned entry that
   is not is skipped and the lookup goes on to the next candidate or tier:
   a nearest flash entry at d 64 is never served for a d 80 query, whose
   launch would raise.  The default and fallback tiers are the hand
   tables, which hold by construction.
c. **Resolutions are cached** per (op, hardware, dtype, shape, mesh), and
   the cache is cleared by ``put_op`` (which loading a tuning DB goes
   through) and ``clear``:
   a decode step asks for the same few shapes ~113 times, and the host
   cost of a ``matmul`` stays that of the ``lru_cache``'d hand table.
   ``hit_stats`` therefore counts resolutions, not calls.

The process-global ``GLOBAL_REGISTRY`` loads every file of the port's
tuned directory (``core.tuning_db``) at its first lookup or put, so an
explicit ``put_op`` (a sweep's winner, a file given on the command line)
lands on top of the committed table, never under it.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import warnings
from typing import Dict, Optional, Tuple

from repro_torch.core import hardware as hw
from repro_torch.core.tile_config import (
    CONFIG_CLASS, OP_DECODE_LOOP, OP_FLASH_ATTENTION, OP_GEMM, OP_PAGED_ATTN,
    AnyConfig, DecodeLoopConfig, FlashAttentionConfig, PagedAttentionConfig,
    TileConfig, _dtype_name, flash_takes, gemm_takes, hand_config)

#: each op's problem-shape length: gemm (m, k, n); flash (sq, skv, d);
#: decode_loop and paged_attn (max_batch, max_len)
OP_SHAPE_LEN = {OP_GEMM: 3, OP_FLASH_ATTENTION: 3, OP_DECODE_LOOP: 2,
                OP_PAGED_ATTN: 2}
OP_BLOCK_LEN = {op: len(dataclasses.fields(cls))
                for op, cls in CONFIG_CLASS.items()}

#: the last resort per op where the hand tables have no schedule (a
#: shape-less query, the engine knobs)
_FALLBACK: Dict[str, AnyConfig] = {
    OP_GEMM: TileConfig(),
    OP_FLASH_ATTENTION: FlashAttentionConfig(),
    OP_DECODE_LOOP: DecodeLoopConfig(),
    OP_PAGED_ATTN: PagedAttentionConfig(),
}

#: the largest M of the decode regime (rule a)
DECODE_KEY_M = 16

#: nearest-shape matches beyond this cumulative |log2| distance are rejected
NEAREST_MAX_LOG2_DIST = 6.0

#: resolutions cached before the cache starts over
_MAX_RESOLVED = 1 << 16

#: hardware names already warned about (once per process)
_WARNED_UNKNOWN_HARDWARE = set()

def mesh_hardware_key(hardware: str, mesh: Optional[str]) -> str:
    """Registry bucket of entries tuned for one topology
    (``<hardware>@<mesh>``), consulted before the plain per-hardware ones."""
    return f"{hardware}@{mesh}" if mesh else hardware


def key_shape(op: str, dtype, shape):
    """The shape an entry is stored and looked up under (rule a): a bf16
    GEMM with M <= 16 under M = 16."""
    if shape is None:
        return None
    shape = tuple(int(s) for s in shape)
    if (op == OP_GEMM and shape[0] <= DECODE_KEY_M
            and _dtype_name(dtype) == "bfloat16"):
        return (DECODE_KEY_M,) + shape[1:]
    return shape


def takes(op: str, dtype, shape, cfg) -> bool:
    """Whether the wrapper takes ``cfg`` for a query of ``shape`` (rule b).
    Shape-less queries and the engine knobs take any config."""
    if shape is None:
        return True
    if op == OP_GEMM:
        return isinstance(cfg, TileConfig) and gemm_takes(cfg, dtype, shape[0])
    if op == OP_FLASH_ATTENTION:
        return (isinstance(cfg, FlashAttentionConfig)
                and flash_takes(cfg, dtype, shape[2]))
    return True


def _seeded_default(op: str, hardware: str, dt: str, shape
                    ) -> Tuple[Optional[AnyConfig], str]:
    """(config, source) of the default tier: a registered profile's default
    (``default``); for an unregistered name, after a once-per-process
    warning, the detected profile's (``fallback``)."""
    prof = hw.find_profile(hardware)
    source = "default"
    if prof is None:
        detected = hw.detect_hardware()
        if hardware not in _WARNED_UNKNOWN_HARDWARE:
            _WARNED_UNKNOWN_HARDWARE.add(hardware)
            warnings.warn(
                f"unknown hardware {hardware!r} (known: {sorted(hw.HARDWARE)});"
                f" falling back to the detected profile {detected!r}'s "
                f"defaults", stacklevel=4)
        prof = hw.find_profile(detected)
        source = "fallback"
    cfg = prof.default_config(op, dt, shape) if prof else None
    return cfg, source


def _shape_dist(a: Tuple[int, ...], b: Tuple[int, ...]) -> float:
    if len(a) != len(b):
        return float("inf")
    return sum(abs(math.log2(max(x, 1)) - math.log2(max(y, 1)))
               for x, y in zip(a, b))


@dataclasses.dataclass(frozen=True)
class LookupResult:
    """A resolved config and the tier that gave it."""
    config: AnyConfig
    source: str                     # exact|nearest|generic|default|fallback
    matched_shape: Optional[Tuple[int, ...]] = None
    distance: float = 0.0
    op: str = OP_GEMM
    #: the mesh label of the bucket that satisfied the lookup, if any
    mesh: Optional[str] = None


class TileRegistry:
    """Thread-safe tuned-parameter store with nearest-shape fallback and a
    resolution cache (rule c): ``lookup_op`` / ``get_op`` / ``put_op``
    (``put`` is the (hardware, dtype, m, k, n) form for GEMMs)."""

    def __init__(self, *, autoload: bool = False):
        self._lock = threading.Lock()
        # re-entrant: the autoload's own puts pass through _ensure_autoloaded
        self._autoload_lock = threading.RLock()
        self._autoloading = False
        self._stats_lock = threading.Lock()
        # (op, hw, dtype) -> {shape -> config}: a lookup scans only its bucket
        self._exact: Dict[Tuple[str, str, str],
                          Dict[Tuple[int, ...], AnyConfig]] = {}
        self._generic: Dict[Tuple[str, str, str], AnyConfig] = {}
        # (op, hardware, dtype, shape, mesh) as the caller gave
        # them -> LookupResult; the generation guards against storing a
        # result resolved before a concurrent put
        self._resolved: Dict[tuple, LookupResult] = {}
        self._generation = 0
        self._autoload = autoload
        self._autoload_done = False
        self.hit_stats: Dict[str, int] = {}

    # -- autoload of the committed tuning DBs ----------------------------
    def _ensure_autoloaded(self) -> None:
        if not self._autoload or self._autoload_done:
            return
        with self._autoload_lock:
            if self._autoload_done or self._autoloading:
                return
            from repro_torch.core import tuning_db   # tuning_db imports us
            self._autoloading = True
            try:
                tuning_db.load_all(self)
            finally:
                self._autoloading = False
            self._autoload_done = True

    def mark_autoloaded(self) -> None:
        """Disable the lazy default-dir load (an explicit load supersedes it)."""
        self._autoload_done = True

    def _invalidate_locked(self) -> None:
        self._resolved.clear()
        self._generation += 1

    # -- lookup ----------------------------------------------------------
    def lookup_op(self, op: str, hardware: str, dtype,
                  shape: Optional[Tuple[int, ...]] = None,
                  mesh: Optional[str] = None) -> LookupResult:
        """Resolve a config for ``op``, reporting which tier gave it.

        Cached (rule c): a repeated query returns the stored result without
        touching ``hit_stats``.  ``mesh`` consults the ``<hardware>@<mesh>``
        bucket's tuned tiers first."""
        if shape is not None and shape.__class__ is not tuple:
            shape = tuple(shape)
        key = (op, hardware, dtype, shape, mesh)
        res = self._resolved.get(key)
        if res is not None:
            return res
        self._ensure_autoloaded()
        with self._lock:
            gen = self._generation
        res = self._resolve(op, hardware, dtype, shape, mesh)
        with self._lock:
            if gen == self._generation:
                if len(self._resolved) >= _MAX_RESOLVED:
                    self._resolved.clear()
                self._resolved[key] = res
        with self._stats_lock:
            self.hit_stats[res.source] = self.hit_stats.get(res.source, 0) + 1
        return res

    def _resolve(self, op, hardware, dtype, shape, mesh) -> LookupResult:
        hardware = hw.canonical_name(hardware)
        dt = _dtype_name(dtype)
        kshape = key_shape(op, dt, shape)
        buckets = ([(mesh_hardware_key(hardware, mesh), mesh)]
                   if mesh else []) + [(hardware, None)]
        for bucket, label in buckets:
            with self._lock:
                res = self._tuned_locked(op, bucket, dt, kshape)
            if res is not None:
                return dataclasses.replace(res, mesh=label)
        cfg, source = _seeded_default(op, hardware, dt, shape)
        if cfg is not None:
            return LookupResult(cfg, source, op=op)
        return LookupResult(hand_config(op, dt, shape) or _FALLBACK[op],
                            "fallback", op=op)

    def _tuned_locked(self, op: str, hardware: str, dt: str,
                      shape: Optional[Tuple[int, ...]]
                      ) -> Optional[LookupResult]:
        """exact > nearest > generic within one bucket, each only where the
        wrapper takes the config (rule b), or None."""
        bucket = self._exact.get((op, hardware, dt), {})
        if shape is not None:
            hit = bucket.get(shape)
            if hit is not None and takes(op, dt, shape, hit):
                return LookupResult(hit, "exact", shape, op=op)
            best = None
            for mshape, cfg in bucket.items():
                dist = _shape_dist(shape, mshape)
                if dist > NEAREST_MAX_LOG2_DIST or not takes(op, dt, shape,
                                                             cfg):
                    continue
                if best is None or (dist, mshape) < best[:2]:
                    best = (dist, mshape, cfg)
            if best is not None:
                dist, mshape, cfg = best
                return LookupResult(cfg, "nearest", mshape, dist, op=op)
        hit = self._generic.get((op, hardware, dt))
        if hit is not None and takes(op, dt, shape, hit):
            return LookupResult(hit, "generic", op=op)
        return None

    def get_op(self, op: str, hardware: str, dtype,
               shape: Optional[Tuple[int, ...]] = None,
               mesh: Optional[str] = None) -> AnyConfig:
        return self.lookup_op(op, hardware, dtype, shape, mesh=mesh).config

    # -- update ----------------------------------------------------------
    def put_op(self, op: str, cfg: AnyConfig, hardware: str, dtype,
               shape: Optional[Tuple[int, ...]] = None,
               mesh: Optional[str] = None) -> None:
        if op not in CONFIG_CLASS:
            raise ValueError(f"unknown op {op!r}; known: {sorted(CONFIG_CLASS)}")
        self._ensure_autoloaded()
        hardware = mesh_hardware_key(hw.canonical_name(hardware), mesh)
        dt = _dtype_name(dtype)
        with self._lock:
            if shape is None:
                self._generic[(op, hardware, dt)] = cfg
            else:
                self._exact.setdefault((op, hardware, dt), {})[
                    key_shape(op, dt, shape)] = cfg
            self._invalidate_locked()

    def put(self, cfg: TileConfig, hardware: str, dtype, m: int = None,
            k: int = None, n: int = None) -> None:
        """GEMM form of :meth:`put_op`; a partial shape is a generic entry."""
        has_shape = m is not None and k is not None and n is not None
        self.put_op(OP_GEMM, cfg, hardware, dtype,
                    (m, k, n) if has_shape else None)

    def clear(self) -> None:
        with self._lock:
            self._exact.clear()
            self._generic.clear()
            self._invalidate_locked()
        with self._stats_lock:
            self.hit_stats.clear()


#: process-global registry: loads every file of the port's tuned directory
#: at its first lookup
GLOBAL_REGISTRY = TileRegistry(autoload=True)
