"""Tuned-table validators: the AR00x check family over
``src/repro_torch/tuned/*.json``.

The port's counterpart of the reference's ``analysis/artifacts.py``.  A
committed tuning table rots silently: a ``dispatch_*`` line is removed
from ``kernels/csrc``, a profile's shared-memory budget changes, a mesh
axis is renamed, and the stale entry keeps winning lookups (or, since the
registry skips what the wrapper would not take, quietly stops winning
them).  These checks re-derive every entry's legality from the current
``HardwareProfile`` (``core/hardware.py``) and the schedules the kernels
instantiate (``core/tile_config.py``):

==========  =========  =====================================================
check id    severity   fires on
==========  =========  =====================================================
``AR001``   error      a schedule misaligned for its profile (the bf16
                       tensor-core kernels' K and N blocks a multiple of
                       ``mxu_dim`` 64, M and flash query blocks of
                       ``sublane`` 8), or one no ``dispatch_*`` line of
                       ``kernels/csrc`` instantiates (for flash, at the
                       entry's head dim)
``AR002``   error      a working set over the profile's ``smem_bytes``:
                       GEMM ``stages x (bm x bk + bk x bn)`` elements; flash
                       ``(bq + stages x 2 x bk) x d`` elements, ``d`` padded
                       to whole 64-column tiles on ``wgmma``
``AR003``   error      an entry ``mesh`` label unparseable or using axes
                       outside ``launch.mesh.MESH_AXES``
``AR004``   warning    a stale entry (``TuningDB.stale()``: an
                       instantiated schedule the wrapper would not take at
                       the entry's own shape, ``gemm_takes`` /
                       ``flash_takes``, so the registry never serves it),
                       or a dtype torch cannot resolve;
                       prunable with ``scripts/torch_tune.py verify
                       --prune``
``AR005``   error      the file stem or the blob's hardware resolves to no
                       registered ``HardwareProfile`` (or the file is
                       unloadable)
==========  =========  =====================================================

The reference's BA00x (bench baselines) are not ported: the port has no
bench baselines yet.
"""
from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

from repro_torch.analysis.findings import Finding, SEV_ERROR, SEV_WARNING
from repro_torch.core.hardware import find_profile
from repro_torch.core import tile_config as tc
from repro_torch.core.tile_config import OP_FLASH_ATTENTION, OP_GEMM
from repro_torch.core.tuning_db import TuningDB, TuningDBError
from repro_torch.launch.mesh import MESH_AXES

SLUGS = {
    "AR001": "tile-misaligned",
    "AR002": "smem-overflow",
    "AR003": "bad-mesh-label",
    "AR004": "stale-entry",
    "AR005": "unknown-hardware",
}

_MESH_LABEL_RE = re.compile(r"^([a-z]+\d+)(x[a-z]+\d+)*$")
# non-greedy axis name + trailing separator, or "xmodel2" would parse as
# one segment with an "xmodel" axis
_MESH_SEGMENT_RE = re.compile(r"([a-z]+?)(\d+)(?:x|$)")
#: kernels on the tensor cores' swizzled 64-element K / N blocks
_TENSOR_CORE_KERNELS = ("decode", "wgmma")


def _entry_label(rec) -> str:
    shape = "x".join(str(s) for s in rec.shape)
    label = f"{rec.op}/{rec.dtype}/{shape}"
    if rec.mesh:
        label += f"@{rec.mesh}"
    return label


def parse_mesh_label(label: str) -> Optional[List[Tuple[str, int]]]:
    """``"data4xmodel2"`` -> ``[("data", 4), ("model", 2)]``; None if the
    label is not of that shape at all."""
    if not _MESH_LABEL_RE.match(label or ""):
        return None
    return [(axis, int(size))
            for axis, size in _MESH_SEGMENT_RE.findall(label)]


def torch_dtype(name: str) -> Optional[torch.dtype]:
    """The torch dtype named ``name``, or None."""
    dt = getattr(torch, str(name), None)
    return dt if isinstance(dt, torch.dtype) else None


def gemm_aligned(cfg, hw) -> bool:
    """The bf16 tensor-core kernels take K and N blocks of whole swizzled
    64-element rows and M blocks of whole 8-row MMA fragments."""
    if cfg.kernel not in _TENSOR_CORE_KERNELS:
        return True
    return (cfg.bk % hw.mxu_dim == 0 and cfg.bn % hw.mxu_dim == 0
            and cfg.bm % hw.sublane == 0)


def gemm_smem_bytes(cfg, dtype: torch.dtype) -> int:
    """Shared memory of one GEMM block: its ring of A and B tiles."""
    size = torch.empty((), dtype=dtype).element_size()
    return cfg.stages * (cfg.bm * cfg.bk + cfg.bk * cfg.bn) * size


def gemm_instantiated(cfg) -> bool:
    return (cfg.bm, cfg.bk, cfg.bn, cfg.stages) in \
        tc._gemm_instantiated().get(cfg.kernel, ())


def flash_instantiated(cfg, d: int) -> bool:
    return d in tc._flash_instantiated().get(cfg.kernel, {}).get(
        (cfg.bq, cfg.bk, cfg.stages), ())


def flash_aligned(cfg, hw) -> bool:
    return cfg.bq % hw.sublane == 0 and (
        cfg.kernel != "wgmma" or cfg.bk % hw.mxu_dim == 0)


def flash_smem_bytes(cfg, d: int, dtype: torch.dtype) -> int:
    """Shared memory of one flash block: its Q tile and a ring of K and V
    tiles; ``wgmma`` pads the head dim to whole 64-column tiles."""
    size = torch.empty((), dtype=dtype).element_size()
    if cfg.kernel == "wgmma":
        d = -(-d // 64) * 64
    return (cfg.bq + cfg.stages * 2 * cfg.bk) * d * size


def validate_tuning_db(path: str, rel: Optional[str] = None
                       ) -> List[Finding]:
    """AR00x checks for one ``tuned/<hardware>.json`` file."""
    rel = rel or path
    findings: List[Finding] = []

    def flag(check_id, severity, scope, message):
        findings.append(Finding(check_id=check_id, severity=severity,
                                path=rel, line=0, scope=scope,
                                message=message))

    try:
        db = TuningDB.from_file(path)
    except (TuningDBError, OSError, ValueError, KeyError, TypeError) as e:
        flag("AR005", SEV_ERROR, "db", f"unloadable tuning DB: {e}")
        return findings

    hw = find_profile(db.hardware)
    if hw is None:
        flag("AR005", SEV_ERROR, "db",
             f"hardware {db.hardware!r} matches no registered "
             f"HardwareProfile; tuned entries can never be looked up")
        return findings
    stem = os.path.splitext(os.path.basename(path))[0]
    if find_profile(stem) is not hw:
        flag("AR005", SEV_ERROR, "db",
             f"file stem {stem!r} does not resolve to the blob's "
             f"hardware {db.hardware!r}")

    stale = {id(r) for r in db.stale()}
    for rec in db.records():
        scope = _entry_label(rec)
        dtype = torch_dtype(rec.dtype)
        if dtype is None:
            flag("AR004", SEV_WARNING, scope,
                 f"dtype {rec.dtype!r} is not a torch dtype; stale entry, "
                 f"prune with `torch_tune.py verify --prune`")
        cfg = rec.config
        instantiated = True
        if dtype is None:
            pass
        elif rec.op == OP_GEMM:
            if not gemm_aligned(cfg, hw):
                flag("AR001", SEV_ERROR, scope,
                     f"schedule {cfg.schedule} misaligned for {hw.name} "
                     f"(mxu_dim={hw.mxu_dim}, sublane={hw.sublane})")
            instantiated = gemm_instantiated(cfg)
            if not instantiated:
                flag("AR001", SEV_ERROR, scope,
                     f"schedule {cfg.schedule} is instantiated by no "
                     f"`dispatch_*` line of gemm.cu")
            need = gemm_smem_bytes(cfg, dtype)
            if need > hw.smem_bytes:
                flag("AR002", SEV_ERROR, scope,
                     f"schedule {cfg.schedule} needs {need} B of shared "
                     f"memory, over {hw.name}'s {hw.smem_bytes} B")
        elif rec.op == OP_FLASH_ATTENTION:
            d = rec.shape[2]
            if not flash_aligned(cfg, hw):
                flag("AR001", SEV_ERROR, scope,
                     f"flash schedule {cfg.schedule} misaligned for "
                     f"{hw.name} (mxu_dim={hw.mxu_dim}, "
                     f"sublane={hw.sublane})")
            instantiated = flash_instantiated(cfg, d)
            if not instantiated:
                flag("AR001", SEV_ERROR, scope,
                     f"flash schedule {cfg.schedule} is instantiated by no "
                     f"`dispatch_*` line of flash_attention.cu at head dim "
                     f"{d}")
            need = flash_smem_bytes(cfg, d, dtype)
            if need > hw.smem_bytes:
                flag("AR002", SEV_ERROR, scope,
                     f"flash schedule {cfg.schedule} needs {need} B of "
                     f"shared memory at head dim {d}, over {hw.name}'s "
                     f"{hw.smem_bytes} B")
        if instantiated and id(rec) in stale:
            flag("AR004", SEV_WARNING, scope,
                 f"schedule {cfg.schedule} is not what the wrapper takes "
                 f"for a {rec.dtype} problem of shape {rec.shape}: the "
                 f"registry never serves it; prune with `torch_tune.py "
                 f"verify --prune`")

        if rec.mesh is not None:
            segs = parse_mesh_label(rec.mesh)
            if segs is None:
                flag("AR003", SEV_ERROR, scope,
                     f"mesh label {rec.mesh!r} is not of the "
                     f"`axis<N>[xaxis<N>...]` form mesh_axis_label emits")
            else:
                bad = [a for a, _n in segs if a not in MESH_AXES]
                if bad:
                    flag("AR003", SEV_ERROR, scope,
                         f"mesh label {rec.mesh!r} uses axes {bad} "
                         f"outside MESH_AXES {MESH_AXES}: orphaned by "
                         f"every topology the launcher can build")
                elif any(n < 1 for _a, n in segs):
                    flag("AR003", SEV_ERROR, scope,
                         f"mesh label {rec.mesh!r} has a non-positive "
                         f"axis size")
    return findings


def validate_tuned_dir(tuned_dir: str, root: Optional[str] = None
                       ) -> List[Finding]:
    findings: List[Finding] = []
    if not os.path.isdir(tuned_dir):
        return findings
    for name in sorted(os.listdir(tuned_dir)):
        if not name.endswith(".json"):
            continue
        path = os.path.join(tuned_dir, name)
        rel = os.path.relpath(path, root) if root else path
        findings.extend(validate_tuning_db(path, rel))
    return findings
