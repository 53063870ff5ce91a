"""Versioned, persistent, multi-op tuning database: the paper's Tab. 4 as a
committed file.

The port's counterpart of the reference's ``core/tuning_db.py``.  One
schema-checked JSON file per hardware target, ``<hardware>.json`` under
``src/repro_torch/tuned/`` (inside the package, apart from the reference's
``tuned/``, whose loader would flag a file for hardware it has no profile
for), each entry the winning schedule of one ``(op, dtype, shape)``
problem with how it was obtained (``model`` estimate or ``measure``d on
the card) and the score that won.

Ops, shapes and blocks (``core.tile_config.block_of``):

* ``gemm``            — shape ``(m, k, n)``, block ``(bm, bk, bn, kernel,
  stages, split_k, group_m)``;
* ``flash_attention`` — shape ``(sq, skv, d)``, block ``(bq, bk, kernel,
  stages)``;
* ``paged_attn``      — shape ``(max_batch, max_len)``, block
  ``(page_size,)``;
* ``decode_loop``     — shape ``(max_batch, max_len)``, block ``(unroll,)``.

A kernel is stored as its ``KERNEL_CODES`` integer.

Schema: version 4 (op-keyed entries, an optional per-entry ``mesh``).
Versions 1-3 load (1-2: flat GEMM-only entries, migrated to ``op="gemm"``,
whose three-element block is that WMMA tile); a newer version raises
:class:`TuningDBError`.  A file written by a measured sweep also carries a
top-level ``measured_on``: the card's name and power limit as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them (the
reference ignores top-level keys it does not know).

Where files are read from: ``$REPRO_TORCH_TUNED_DIR`` if set, else the
package's ``tuned/``; ``$REPRO_TORCH_DISABLE_TUNED`` (any non-empty value)
turns the registry's autoload off.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import warnings
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.registry import (OP_BLOCK_LEN, OP_SHAPE_LEN, key_shape,
                                       takes)
from repro_torch.core.tile_config import OP_GEMM, block_of, config_from_block

#: current on-disk schema
SCHEMA_VERSION = 4
#: older schemas that still load
LEGACY_SCHEMA_VERSIONS = (1, 2, 3)

#: env var overriding where tuned DBs are read from / written to
TUNED_DIR_ENV = "REPRO_TORCH_TUNED_DIR"
#: env var disabling the registry's autoload (any non-empty value)
DISABLE_ENV = "REPRO_TORCH_DISABLE_TUNED"


class TuningDBError(ValueError):
    """Raised for schema-version mismatches and malformed DB files."""


@dataclasses.dataclass(frozen=True)
class TuningRecord:
    """One tuned winner: (op, dtype, shape), the winning block, provenance."""
    dtype: str
    shape: Tuple[int, ...]
    block: Tuple[int, ...]
    op: str = OP_GEMM
    source: str = "model"        # "model" | "measure" | "measure-pruned"
    seconds: float = 0.0         # winning score (estimated or measured)
    gflops: float = 0.0
    mesh: Optional[str] = None

    def __post_init__(self):
        want_s = OP_SHAPE_LEN.get(self.op)
        if want_s is None:
            raise TuningDBError(f"unknown op {self.op!r}")
        try:
            shape = tuple(int(x) for x in self.shape)
            block = tuple(int(x) for x in self.block)
            if len(shape) == want_s and 0 < len(block) <= OP_BLOCK_LEN[self.op]:
                # a short (legacy) block fills its remaining fields
                block = block_of(config_from_block(self.op, block))
        except (TypeError, ValueError) as e:
            raise TuningDBError(f"bad shape/block {self.shape}/{self.block} "
                                f"for op {self.op!r}: {e}") from e
        if len(shape) != want_s or len(block) != OP_BLOCK_LEN[self.op]:
            raise TuningDBError(
                f"op {self.op!r} expects shape[{want_s}]/block[<="
                f"{OP_BLOCK_LEN[self.op]}], got {self.shape}/{self.block}")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "block", block)

    @classmethod
    def gemm(cls, dtype: str, m: int, k: int, n: int,
             bm: int, bk: int, bn: int, **kw) -> "TuningRecord":
        """Legacy-style GEMM constructor (a WMMA tile)."""
        return cls(dtype=dtype, shape=(m, k, n), block=(bm, bk, bn),
                   op=OP_GEMM, **kw)

    @property
    def config(self):
        """The typed config object."""
        return config_from_block(self.op, self.block)

    def to_json(self) -> dict:
        out = {"op": self.op, "dtype": self.dtype,
               "shape": list(self.shape), "block": list(self.block),
               "source": self.source, "seconds": self.seconds,
               "gflops": self.gflops}
        if self.mesh:
            out["mesh"] = self.mesh
        return out

    @classmethod
    def from_json(cls, blob: dict) -> "TuningRecord":
        try:
            if "op" in blob or "shape" in blob:
                return cls(op=blob.get("op", OP_GEMM), dtype=blob["dtype"],
                           shape=tuple(blob["shape"]),
                           block=tuple(blob["block"]),
                           source=blob.get("source", "model"),
                           seconds=blob.get("seconds", 0.0),
                           gflops=blob.get("gflops", 0.0),
                           mesh=blob.get("mesh"))
            # legacy (schema <= 2) flat GEMM entry
            return cls.gemm(blob["dtype"], blob["m"], blob["k"], blob["n"],
                            blob["bm"], blob["bk"], blob["bn"],
                            source=blob.get("source", "model"),
                            seconds=blob.get("seconds", 0.0),
                            gflops=blob.get("gflops", 0.0))
        except (KeyError, TypeError, ValueError) as e:
            if isinstance(e, TuningDBError):
                raise
            raise TuningDBError(f"malformed tuning record {blob!r}: {e}") from e


class TuningDB:
    """Every tuned winner of one hardware target, persistable as JSON.

    Records are keyed by ``(op, dtype, shape, mesh)``; ``add`` keeps the
    most trustworthy winner per key (measured > modelled, the better of two
    measured scores, the latest model estimate)."""

    #: measurements outrank estimates: their seconds are not comparable
    _SOURCE_RANK = {"model": 0, "measure": 1, "measure-pruned": 1}

    def __init__(self, hardware: str, measured_on: Optional[str] = None):
        self.hardware = hardware
        #: the card (and power limit) a measured sweep ran on
        self.measured_on = measured_on
        self._records: Dict[Tuple[str, str, Tuple[int, ...], Optional[str]],
                            TuningRecord] = {}

    def add(self, rec: TuningRecord, *, keep_best: bool = True) -> None:
        """Insert a record.  With ``keep_best``: a measured entry always
        beats a model estimate; measured vs measured keeps the better
        score; model vs model takes the new record (estimates are
        recomputable, so the latest cost model is authoritative)."""
        key = (rec.op, rec.dtype, rec.shape, rec.mesh)
        old = self._records.get(key)
        if keep_best and old is not None:
            new_rank = self._SOURCE_RANK.get(rec.source, 0)
            old_rank = self._SOURCE_RANK.get(old.source, 0)
            if new_rank < old_rank:
                return
            if (new_rank == old_rank and new_rank > 0
                    and old.seconds > 0 and rec.seconds > old.seconds):
                return
        self._records[key] = rec

    def records(self, op: Optional[str] = None) -> List[TuningRecord]:
        keys = sorted((k for k in self._records if op is None or k[0] == op),
                      key=lambda k: (k[0], k[1], k[2], k[3] or ""))
        return [self._records[k] for k in keys]

    def ops(self) -> List[str]:
        return sorted({k[0] for k in self._records})

    def get_op(self, op: str, dtype: str, shape: Tuple[int, ...],
               mesh: Optional[str] = None) -> Optional[TuningRecord]:
        return self._records.get((op, dtype, tuple(shape), mesh))

    def get(self, dtype: str, m: int, k: int, n: int) -> Optional[TuningRecord]:
        return self.get_op(OP_GEMM, dtype, (m, k, n))

    def __len__(self) -> int:
        return len(self._records)

    def merge(self, other: "TuningDB", *, keep_best: bool = True) -> None:
        if other.hardware != self.hardware:
            raise TuningDBError(
                f"cannot merge DB for {other.hardware!r} into {self.hardware!r}")
        for rec in other.records():
            self.add(rec, keep_best=keep_best)
        self.measured_on = other.measured_on or self.measured_on

    def stale(self) -> List[TuningRecord]:
        """Records the wrapper would not take at their own shape (a
        schedule no ``dispatch_*`` line instantiates, or of another
        regime): the registry never serves them."""
        return [r for r in self.records()
                if not takes(r.op, r.dtype, r.shape, r.config)]

    # -- persistence -----------------------------------------------------
    def to_json(self) -> dict:
        out = {"schema_version": SCHEMA_VERSION, "hardware": self.hardware,
               "entries": [r.to_json() for r in self.records()]}
        if self.measured_on:
            out["measured_on"] = self.measured_on
        return out

    @classmethod
    def from_json(cls, blob: dict) -> "TuningDB":
        if not isinstance(blob, dict) or "schema_version" not in blob:
            raise TuningDBError("not a tuning DB (missing schema_version)")
        ver = blob["schema_version"]
        if ver != SCHEMA_VERSION and ver not in LEGACY_SCHEMA_VERSIONS:
            raise TuningDBError(
                f"tuning DB schema_version {ver} is newer than supported "
                f"{SCHEMA_VERSION}; re-run `python scripts/torch_tune.py "
                f"sweep` to regenerate")
        db = cls(blob.get("hardware", "unknown"), blob.get("measured_on"))
        entries = blob.get("entries", [])
        if not isinstance(entries, list):
            raise TuningDBError("tuning DB entries must be a list")
        for entry in entries:
            if not isinstance(entry, dict):
                raise TuningDBError(f"malformed tuning record {entry!r}")
            db.add(TuningRecord.from_json(entry), keep_best=False)
        return db

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)

    @classmethod
    def from_file(cls, path: str) -> "TuningDB":
        with open(path) as f:
            try:
                blob = json.load(f)
            except json.JSONDecodeError as e:
                raise TuningDBError(f"{path}: invalid JSON: {e}") from e
        return cls.from_json(blob)

    # -- reporting -------------------------------------------------------
    def markdown(self) -> str:
        """The DB as one markdown table per op."""
        lines = []
        if self.measured_on:
            lines += [f"Measured on: {self.measured_on}", ""]
        for op in self.ops() or [OP_GEMM]:
            if lines and lines[-1]:
                lines.append("")
            lines += [
                f"### Tuned {op} table — `{self.hardware}`",
                "",
                "| dtype | shape | best schedule | source | est/meas time "
                "| GFLOP/s |",
                "|---|---|---|---|---|---|",
            ]
            for r in self.records(op):
                t = f"{r.seconds * 1e6:.1f} us" if r.seconds else "-"
                gf = f"{r.gflops:.0f}" if r.gflops else "-"
                shape = "x".join(str(s) for s in r.shape)
                if r.mesh:
                    shape += f" @{r.mesh}"
                lines.append(f"| {r.dtype} | {shape} | {r.config.schedule} "
                             f"| {r.source} | {t} | {gf} |")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Location and registry wiring
# ---------------------------------------------------------------------------

def default_tuned_dir() -> str:
    """``$REPRO_TORCH_TUNED_DIR`` if set, else the package's ``tuned/``."""
    env = os.environ.get(TUNED_DIR_ENV)
    if env:
        return env
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tuned")


def db_path(hardware: str, tuned_dir: Optional[str] = None) -> str:
    return os.path.join(tuned_dir or default_tuned_dir(), f"{hardware}.json")


def load_into_registry(registry, path: str, *, strict: bool = False) -> int:
    """Load one DB file into a registry; returns the entries loaded."""
    try:
        db = TuningDB.from_file(path)
    except (TuningDBError, OSError) as e:
        if strict:
            raise
        warnings.warn(f"skipping tuning DB {path}: {e}", stacklevel=2)
        return 0
    for rec in db.records():
        registry.put_op(rec.op, rec.config, db.hardware, rec.dtype, rec.shape,
                        mesh=rec.mesh)
    return len(db)


def load_all(registry, tuned_dir: Optional[str] = None, *,
             strict: bool = False) -> Dict[str, int]:
    """Load every ``<hardware>.json`` under the tuned dir into ``registry``;
    returns ``{path: entries loaded}`` (empty when the dir is missing or
    ``$REPRO_TORCH_DISABLE_TUNED`` is set).  The registry's lazy autoload
    is marked done either way."""
    d = tuned_dir or default_tuned_dir()
    out: Dict[str, int] = {}
    try:
        if os.environ.get(DISABLE_ENV) or not os.path.isdir(d):
            return out
        for path in sorted(glob.glob(os.path.join(d, "*.json"))):
            out[path] = load_into_registry(registry, path, strict=strict)
        return out
    finally:
        mark = getattr(registry, "mark_autoloaded", None)
        if mark is not None:
            mark()


def db_from_sweeps(hardware: str, results: Iterable,
                   measured_on: Optional[str] = None) -> TuningDB:
    """A DB from :class:`repro_torch.core.tuner.SweepResult` objects, each
    under the shape the registry keys it by (rule a)."""
    db = TuningDB(hardware, measured_on)
    for res in results:
        best = res.best
        db.add(TuningRecord(
            op=res.op, dtype=res.dtype,
            shape=key_shape(res.op, res.dtype, res.shape),
            block=block_of(best.config),
            source=best.source, seconds=best.seconds, gflops=best.gflops))
    return db
