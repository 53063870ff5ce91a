"""Mesh topology construction: the distribution layer's ``--mesh`` knob.

``build_mesh`` turns a ``--mesh`` spec string into a
``torch.distributed`` ``DeviceMesh``:

  * ``"data=4,model=2"``  — explicit axis sizes;
  * ``"auto"``            — every rank on the ``data`` axis;
  * ``None`` / ``""``     — no mesh (single-device execution).

One process runs one rank.  Under ``torchrun --standalone
--nproc_per_node N`` the process group comes from the environment; a
process started alone makes a world of one over an in-memory store (no
port is opened).  The backend follows the device: NCCL on the card, gloo
on the CPU.  Importing this module touches no device and no process group.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import axis_names, mesh_sizes

#: axis names the sharding rules understand (distributed/sharding.py)
MESH_AXES = ("pod", "data", "model")


def mesh_axis_label(mesh) -> Optional[str]:
    """Compact topology label for keys and filenames: ``"data4xmodel2"``
    (None: no mesh)."""
    if mesh is None:
        return None
    return "x".join(f"{n}{s}" for n, s in mesh_sizes(mesh).items())


def parse_mesh_spec(spec: str) -> Dict[str, int]:
    """``"data=4,model=2"`` -> ``{"data": 4, "model": 2}`` (order kept).

    Axis names must come from :data:`MESH_AXES`; sizes must be >= 1."""
    out: Dict[str, int] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad mesh spec {spec!r}: expected axis=size, got {part!r}")
        name, _, size_s = part.partition("=")
        name = name.strip()
        if name not in MESH_AXES:
            raise ValueError(
                f"bad mesh spec {spec!r}: unknown axis {name!r} "
                f"(choose from {', '.join(MESH_AXES)})")
        if name in out:
            raise ValueError(f"bad mesh spec {spec!r}: duplicate axis {name!r}")
        try:
            size = int(size_s)
        except ValueError:
            raise ValueError(
                f"bad mesh spec {spec!r}: size of {name!r} is not an int")
        if size < 1:
            raise ValueError(
                f"bad mesh spec {spec!r}: size of {name!r} must be >= 1")
        out[name] = size
    if not out:
        raise ValueError(f"bad mesh spec {spec!r}: no axes")
    return out


def world_size() -> int:
    """Ranks of the running job: the process group's, else torchrun's
    ``WORLD_SIZE``, else 1."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def rank() -> int:
    """This process's rank (0 without a process group or torchrun)."""
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", "0"))


def _init_process_group(device: torch.device) -> None:
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(
                f"a {have} process group is live; a mesh on {device.type} "
                f"needs {backend}")
        return
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if "MASTER_ADDR" in os.environ:         # torchrun's rendezvous
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def build_mesh(spec: Optional[str], *, device: DeviceLike = None
               ) -> Optional[DeviceMesh]:
    """A ``DeviceMesh`` over every rank from a ``--mesh`` spec (None or ""
    -> no mesh).  ``device``: None is the card (rank r on
    ``cuda:{LOCAL_RANK}``), ``"cpu"`` the CPU over gloo.  The mesh must
    hold every rank of the job: ``"auto"`` puts them all on ``data``."""
    if not spec:
        return None
    dev = resolve_device(device)
    world = world_size()
    if spec.strip() == "auto":
        sizes = {"data": world}
    else:
        sizes = parse_mesh_spec(spec)
    n = math.prod(sizes.values())
    if n != world:
        raise ValueError(
            f"mesh {spec!r} needs {n} ranks, the job has {world} (hint: "
            f"torchrun --standalone --nproc_per_node {n} starts {n}, one "
            f"rank a process)")
    _init_process_group(dev)
    return init_device_mesh(dev.type, tuple(sizes.values()),
                            mesh_dim_names=tuple(sizes))


def describe_mesh(mesh) -> Dict[str, object]:
    """JSON-friendly mesh provenance for ``stats()`` and artifacts."""
    if mesh is None:
        return {"devices": 1, "axes": None, "label": None}
    sizes = mesh_sizes(mesh)
    return {"devices": math.prod(sizes.values()),
            "axes": {a: sizes[a] for a in axis_names(mesh)},
            "label": mesh_axis_label(mesh)}
