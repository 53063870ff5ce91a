"""Checkpoints in the reference's on-disk format.

One directory a step, ``step_XXXXXXXX/``, holding ``manifest.json`` (the
step, and per leaf its stored shape and dtype, its logical dtype and the
crc32 of its bytes) and one ``.npy`` per leaf, named by the leaf's path
as the reference names it: a NamedTuple field is ``.<field>``, a dict key
or a sequence index is itself, and the parts are joined by ``__``
(``.params__blocks__attn__wq``, ``.opt__.m__embedding``).  bfloat16,
which numpy cannot store, is written as its ``uint16`` view with logical
dtype ``bfloat16``.  Each package restores what the other wrote from the
same state.  A K-major leaf is stored as the reference's row-major array
of its shape and restored in its template's layout.

A step is written into ``step_XXXXXXXX.tmp`` and renamed into place, so a
partial checkpoint is never visible; ``keep`` bounds how many stay.
Leaves are written and read by a few threads at once (the crc32 and the
file I/O release the GIL), which matters at a billion parameters.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.device import DeviceLike
from repro_torch.distributed.sharding import distribute, full
from repro_torch.models.params import in_layout_of

_THREADS = 8


def _flatten_with_paths(tree, prefix: Tuple[str, ...] = ()
                        ) -> List[Tuple[str, Any]]:
    """(name, leaf) in the reference's order: NamedTuple fields in order,
    dict keys sorted, None contributing nothing."""
    if tree is None:
        return []
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [item for f in tree._fields for item in
                _flatten_with_paths(getattr(tree, f), prefix + ("." + f,))]
    if isinstance(tree, dict):
        return [item for k in sorted(tree) for item in
                _flatten_with_paths(tree[k], prefix + (str(k),))]
    if isinstance(tree, (tuple, list)):
        return [item for i, v in enumerate(tree) for item in
                _flatten_with_paths(v, prefix + (str(i),))]
    return [("__".join(prefix), tree)]


def _unflatten(tree, leaves: dict, prefix: Tuple[str, ...] = ()):
    """``tree``'s structure with each leaf replaced by ``leaves[name]``."""
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves,
                                       prefix + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return leaves["__".join(prefix)]


def _crc32(arr: np.ndarray) -> int:
    """crc32 of the array's bytes, read in place (no ``tobytes`` copy)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(array to store, logical dtype name)."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _host_copy(t: torch.Tensor, keep: bool):
    """``_to_numpy(t)`` where ``keep``, else None."""
    return _to_numpy(t) if keep else None


def _write_leaf(tmp: str, name: str, t) -> dict:
    """Write one leaf: a tensor, or the ``_to_numpy`` pair of one."""
    arr, logical = t if isinstance(t, tuple) else _to_numpy(t)
    np.save(os.path.join(tmp, name + ".npy"), arr)
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "logical_dtype": logical,
            "crc32": _crc32(arr)}


def _read_leaf(path: str, name: str, meta: dict, like,
               device: DeviceLike) -> torch.Tensor:
    arr = np.load(os.path.join(path, name + ".npy"))
    if _crc32(arr) != meta["crc32"]:
        raise IOError(f"checkpoint corruption in leaf {name!r}")
    if meta.get("logical_dtype", str(arr.dtype)) == "bfloat16":
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if not isinstance(like, torch.Tensor):
        return t if device is None else t.to(device)
    dev = device if device is not None else (
        like.device if like.device.type != "meta" else "cpu")
    return in_layout_of(like, t, like.dtype, dev)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def save(self, step: int, state: Any) -> str:
        """Write ``state``.  A state on a mesh (DTensor leaves) is written
        whole, in the layout one device writes: every rank gathers each
        leaf in turn (a collective), rank 0 writes, and every rank returns
        once the step is published."""
        flat = _flatten_with_paths(state)
        final = self._step_dir(step)
        sharded = any(isinstance(t, DTensor) for _, t in flat)
        if sharded:
            writer = dist.get_rank() == 0
            # one leaf whole at a time on the device (every rank takes
            # part in each gather); rank 0 keeps a host copy of each
            flat = [(name, _host_copy(full(t), writer)) for name, t in flat]
            if not writer:
                dist.barrier()
                return final
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with ThreadPoolExecutor(_THREADS) as pool:
            metas = list(pool.map(lambda nl: _write_leaf(tmp, *nl), flat))
        manifest = {"step": step, "leaves": {
            name: meta for (name, _), meta in zip(flat, metas)}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)      # atomic publish
        self._gc()
        if sharded:
            dist.barrier()
        return final

    def _steps(self) -> List[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: Any, device: DeviceLike = None,
                shardings: Any = None) -> Any:
        """``target`` gives the tree's structure and each leaf's dtype and
        strides (a tensor, e.g. a ``meta`` one from
        ``abstract_train_state``).  Leaves land on ``device``; None: each
        target leaf's own (the CPU for ``meta``).  ``shardings``: a tree
        of ``distributed.sharding.Layout`` matching ``target`` (e.g.
        ``train.trainer.state_shardings``) re-shards every leaf onto its
        mesh as it is read, whatever mesh wrote it (an elastic restore);
        each rank keeps its block."""
        path = self._step_dir(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        flat = _flatten_with_paths(target)
        layouts = dict(_flatten_with_paths(shardings)) if shardings else {}

        def read(nl):
            leaf = _read_leaf(path, nl[0], manifest["leaves"][nl[0]], nl[1],
                              device)
            lay = layouts.get(nl[0])
            return leaf if lay is None else distribute(leaf, lay.mesh,
                                                       lay.placements)
        with ThreadPoolExecutor(_THREADS) as pool:
            leaves = list(pool.map(read, flat))
        return _unflatten(target, {name: leaf for (name, _), leaf
                                   in zip(flat, leaves)})

    def _gc(self):
        for s in self._steps()[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
