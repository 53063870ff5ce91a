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

``make_production_mesh`` and ``make_host_mesh`` are the dry run's meshes:
the reference's production topologies (16 x 16, 2 x 16 x 16) and small
host meshes, over a *fake* process group in this one process
(``torch.distributed``'s ``fake`` backend: every collective returns at
once without moving data).  They trace, with fake tensors, what one rank
of such a mesh would run; they never run a real step, and they refuse to
start where a real process group is live.  ``build_mesh`` stays the only
real mesh.
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


# ---------------------------------------------------------------------------
# The dry run's meshes: a fake process group in one process
# ---------------------------------------------------------------------------

FAKE_BACKEND = "fake"


def _clear_dtensor_caches() -> None:
    """Drop DTensor's sharding-propagation and redistribution caches: their
    entries hold the mesh (and its process-group names) they were made
    on, and a fake world started again as another rank makes groups of
    other names."""
    clear = getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                    None)
    if clear is not None:
        clear()
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute
    prop = DTensor._op_dispatcher.sharding_propagator
    for fn in (getattr(prop, "propagate_op_sharding", None),
               getattr(prop, "_propagate_tensor_meta_cached", None),
               getattr(_redistribute, "_gen_transform_infos", None)):
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()
    planner = getattr(_redistribute, "clear_redistribute_planner_cache",
                      None)
    if planner is not None:
        planner()


def fake_world(world: int, rank: int = 0) -> None:
    """Make this process rank ``rank`` of a fake process group of ``world``
    ranks (kept when it is already that).  Raises where a real process
    group is live: the dry run runs in a process of its own."""
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != FAKE_BACKEND:
            raise RuntimeError(
                f"a real {backend} process group is live in this process; "
                "the dry run's meshes need a fake one, in a process of "
                "their own (build_mesh is the real mesh)")
        if dist.get_world_size() == world and dist.get_rank() == rank:
            return
        end_fake_world()
    # the module registers the fake backend's constructor with c10d
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group(FAKE_BACKEND, rank=rank, world_size=world,
                            store=dist.HashStore())


def end_fake_world() -> None:
    """Destroy the fake process group (if it is the live one) and the
    DTensor caches made on its meshes."""
    if dist.is_initialized() and dist.get_backend() == FAKE_BACKEND:
        dist.destroy_process_group()
        _clear_dtensor_caches()


def _fake_mesh(shape, axes, rank: int) -> DeviceMesh:
    fake_world(math.prod(shape), rank)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def make_fake_mesh(spec: str, *, rank: int = 0) -> DeviceMesh:
    """The mesh of a ``--mesh`` spec (``"data=4,model=2"``) as rank
    ``rank`` of a fake process group: what the IR checker traces a mesh
    case on."""
    sizes = parse_mesh_spec(spec)
    return _fake_mesh(tuple(sizes.values()), tuple(sizes), rank)


def make_production_mesh(*, multi_pod: bool = False,
                         rank: int = 0) -> DeviceMesh:
    """The reference's production mesh, as rank ``rank`` of a fake process
    group: one pod is 16 x 16 = 256 devices (data, model); two pods are
    2 x 16 x 16 = 512 (pod, data, model), the ``pod`` axis pure data
    parallelism."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _fake_mesh(shape, axes, rank)


def make_host_mesh(data: int = 1, model: int = 1, *,
                   rank: int = 0) -> DeviceMesh:
    """A small (data, model) mesh as rank ``rank`` of a fake process
    group, for tests of the dry run."""
    return _fake_mesh((data, model), ("data", "model"), rank)
