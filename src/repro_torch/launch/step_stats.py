"""Per-device counts of one traced step: the roofline's inputs.

The port's counterpart of the reference's ``hlo_stats.py`` and
``hlo_analysis.py``, which parse the HLO XLA compiled.  Here the step runs
eagerly, once, under :func:`count_step`: a ``TorchDispatchMode`` sees
every ATen op the step dispatches, its backward included, and counts what
the rank it runs as does:

* ``flops``: ``2 * numel(out) * K`` for every product, as ``hlo_stats.py``
  defines it (``torch.utils.flop_counter``'s formulas for ``mm``, ``bmm``,
  convolutions and fused attention), split by the operands' dtype
  (``flops_by_dtype``): the roofline divides each dtype by its own peak;
* ``traffic_bytes``: the bytes each dispatched op reads and writes, its
  tensor inputs and outputs once each (views, metadata queries and
  profiler markers move nothing).  This is what eager PyTorch moves with
  no fusion, an upper bound where a fused kernel keeps intermediates on
  chip.  It is not the reference's proxy, which counts the outputs of the
  HLO's top-level instructions and its parameters, fusion internals
  excluded;
* collectives: each c10d functional op DTensor issues (all-gather,
  all-reduce, reduce-scatter, all-to-all), its count, result bytes and
  this device's link bytes on the ring model of ``hlo_stats.py``'s
  ``_link_bytes``;
* ``op_histogram``: each op's count;
* ``peak_bytes``: the most bytes live at once, the step's arguments
  included: every storage from its first op until Python frees it, as
  the caching allocator would hold it with no fragmentation;
* ``flash_flops``: what K2 would do on the card for the flash calls of
  the step, 4 d FLOP per unmasked (query, key) pair and head (no
  ``kv_start`` padding: the dry run's rows are full), the count
  ``chip_smoke.py``'s ``flash_bound`` uses.

K1's products, the two-operand einsums and K2's calls are counted as the
card runs them, one launch each (a *unit*): K1's ``repro_torch::gemm``
op under autograd, and otherwise ``core.gemm_api`` / ``core.attention_api``
report each call to the ambient counter.  A unit's products are keyed by
its operands' dtype and its bytes are its operands and result; what its
plain version does inside on the CPU (f32 upcasts, masked score blocks,
the inner ``aten.mm``) is not counted again.

``program=True`` also keeps what the IR checks (``analysis/ir``) read
of the step, as a :class:`ProgramRecord` in ``StepStats.program``: every
collective, dtype conversion and product as a record, the float64 values,
and the canonical op sequence (each counted op's name with its inputs'
and outputs' dtypes and shapes) as a hash and a histogram.  The record is
not part of ``StepStats.record()``.

On a mesh a step's ops are dispatched twice, once on DTensors and once on
each rank's local tensors; only the local ones are counted, so every
number is this rank's.  ``sites=True`` also splits the product flops by
the model function that issued them (``flops_by_site``; a backward
product by its forward's, through the autograd graph's anomaly-mode
traceback).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import os
import re
import sys
import weakref
from typing import Dict, List, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.core.gemm_api import _ctx, execution_context

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

#: c10d functional op name -> the collective it is
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "all-gather",
    "broadcast_": "all-gather",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "_dtensor", "c10d")
#: namespaces whose ops move no data: markers and metadata queries
_QUIET_NAMESPACES = ("profiler", "prim")
_QUIET_OPS = {"sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
              "promote_types", "is_same_size", "_local_scalar_dense",
              "wait_tensor", "lift_fresh"}
#: K1 under autograd: ``core.gemm_api.gemm_op``
_GEMM_OP = "repro_torch::gemm"

_SRC = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SITE_DIRS = tuple(os.path.join(_SRC, d) + os.sep
                   for d in ("models", "train"))
_TB_FRAME = re.compile(r'File "([^"]+)", line \d+, in (\w+)')


def _link_bytes(op: str, result_bytes: float, g: int) -> float:
    """Ring-algorithm per-device link-byte estimate (the reference's
    ``hlo_stats._link_bytes``)."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if op == "all-reduce":
        return 2.0 * result_bytes * frac          # reduce-scatter + all-gather
    if op == "all-gather":
        return result_bytes * frac                # result = gathered buffer
    if op == "reduce-scatter":
        return result_bytes * (g - 1)             # result = one shard
    if op == "all-to-all":
        return result_bytes * frac
    return result_bytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def flash_pairs(s: int, skv: int, causal: bool) -> int:
    """Unmasked (query, key) pairs of one row and head: causal queries are
    aligned to the end of the KV sequence, as K2's."""
    if not causal:
        return s * skv
    return sum(max(0, min(skv, r + (skv - s) + 1)) for r in range(s))


@dataclasses.dataclass
class ProgramRecord:
    """What the IR checks read of one counted step (``count_step(...,
    program=True)``); ops inside a unit are the plain version's, not the
    card's, and are not recorded."""
    #: each collective: {"op", "numel", "bytes", "dims"}, ``dims`` the
    #: result's shape on this rank
    collectives: List[dict] = dataclasses.field(default_factory=list)
    #: each dtype conversion, explicit (``_to_copy``, ``copy_`` across
    #: dtypes) or a pointwise op's promotion of an input:
    #: {"src", "dst", "numel", "dims"}
    converts: List[dict] = dataclasses.field(default_factory=list)
    #: each product (K1 and einsum units, ATen products): {"lhs", "rhs",
    #: "out"} dtypes
    dots: List[dict] = dataclasses.field(default_factory=list)
    #: float64 tensors among the counted ops' inputs and outputs
    f64_values: int = 0
    #: sha256 of the canonical op sequence
    program_hash: str = ""
    #: counted ops by name
    prim_histogram: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: the collectives dispatched inside :func:`loop_body` scopes (the
    #: decode steps of a serve loop)
    loop_collectives: List[dict] = dataclasses.field(default_factory=list)


def _sig(tensors) -> str:
    return ",".join(f"{_dtype_name(t.dtype)}[{'x'.join(map(str, t.shape))}]"
                    for t in tensors)


@dataclasses.dataclass
class StepStats:
    flops: float = 0.0
    flops_by_dtype: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    traffic_bytes: float = 0.0
    collective_result_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {op: 0.0 for op in COLLECTIVE_OPS})
    collective_link_bytes: float = 0.0
    collective_count: int = 0
    dot_count: int = 0
    flash_flops: float = 0.0
    flash_calls: int = 0
    #: bytes of the step's arguments (each storage once, a DTensor's by
    #: its local tensor), and the most bytes live at once
    argument_bytes: int = 0
    peak_bytes: int = 0
    op_histogram: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: (result bytes, collective, local shape, group size), largest first
    top_collectives: List[tuple] = dataclasses.field(default_factory=list)
    flops_by_site: Optional[Dict[str, float]] = None
    program: Optional[ProgramRecord] = None

    def record(self) -> dict:
        """The dry run's ``step_stats`` entry (JSON-friendly)."""
        out = dataclasses.asdict(self)
        out["top_collectives"] = [list(c) for c in self.top_collectives]
        if self.flops_by_site is None:
            del out["flops_by_site"]
        del out["program"]
        return out


class StepCounter(TorchDispatchMode):
    """The dispatch mode behind :func:`count_step`; the ambient
    ``ExecutionContext.counter`` its units report to."""

    def __init__(self, stats: StepStats, sites: bool = False,
                 program: bool = False):
        super().__init__()
        self.stats = stats
        self.sites = sites
        if program:
            stats.program = ProgramRecord()
        self._seq = hashlib.sha256()
        self.in_loop = False          # inside a loop_body() scope
        self._hist: collections.Counter = collections.Counter()
        self._site_flops: collections.Counter = collections.Counter()
        self._live: Dict[int, int] = {}
        self._live_bytes = 0
        self._in_op = False           # inside an op this mode dispatched
        self._unit_dtype: Optional[torch.dtype] = None
        self._flash: list = []

    # -- memory -----------------------------------------------------------
    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (DTensors by their
        local tensors) as live from now on."""
        for t in _tensors(tree):
            self._hold(t.to_local() if isinstance(t, DTensor) else t)

    def _hold(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self._live_bytes += n
        self.stats.peak_bytes = max(self.stats.peak_bytes, self._live_bytes)
        weakref.finalize(st, self._drop, key)

    def _drop(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    # -- sites ------------------------------------------------------------
    def _site(self) -> str:
        node = torch._C._current_autograd_node()
        if node is not None:
            for line in reversed(node.metadata.get("traceback_", [])):
                m = _TB_FRAME.search(line)
                if m and m.group(1).startswith(_SITE_DIRS):
                    return _site_name(m.group(1), m.group(2))
        f = sys._getframe(2)
        while f is not None:
            if f.f_code.co_filename.startswith(_SITE_DIRS):
                return _site_name(f.f_code.co_filename, f.f_code.co_name)
            f = f.f_back
        return "?"

    # -- units ------------------------------------------------------------
    def unit(self, fn, name: str, dtype: torch.dtype, inputs, flash=None):
        """``fn()`` counted as one kernel launch ``name`` on ``inputs``
        (``flash``: K2's (B, S, S_kv, H, d, causal))."""
        if self._in_op or self._unit_dtype is not None:
            return fn()             # counted by the op or unit around it
        self._unit_dtype = dtype
        try:
            out = fn()
        finally:
            self._unit_dtype = None
        outs = _tensors(out)
        ins = _tensors(inputs)
        self._hist[name] += 1
        self.stats.traffic_bytes += (
            sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))
        prog = self.stats.program
        if prog is not None:
            self._sequence(name, ins, outs)
            if flash is None:
                prog.dots.append({"lhs": _dtype_name(ins[0].dtype),
                                  "rhs": _dtype_name(ins[1].dtype),
                                  "out": _dtype_name(outs[0].dtype)})
        for t in outs:
            self._hold(t)
        if flash is not None:
            self._flash.append(flash)
        return out

    # -- dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self._in_op = True
        try:
            out = func(*args, **kwargs)
        finally:
            self._in_op = False
        inputs = pytree.tree_leaves((args, kwargs))
        if any(isinstance(x, DTensor) for x in inputs):
            return out                  # counted on the local tensors
        ns = func.namespace
        name = func._opname
        if ns in _QUIET_NAMESPACES or name in _QUIET_OPS:
            return out
        outs = _tensors(out)
        collective = (_COLLECTIVES.get(name)
                      if ns in _COLLECTIVE_NAMESPACES else None)
        if collective is not None:
            self._collective(collective, args, outs)
        else:
            self._product(func, args, kwargs, out)
        if self._unit_dtype is not None:
            return out                  # the unit counts its own bytes
        self._hist[f"{ns}.{name}"] += 1
        ins = [x for x in inputs if isinstance(x, torch.Tensor)]
        if self.stats.program is not None:
            self._program(func, f"{ns}.{name}", collective, ins, outs)
        if not func.is_view:
            self.stats.traffic_bytes += (sum(map(_nbytes, ins))
                                         + sum(map(_nbytes, outs)))
            for t in outs:
                self._hold(t)
        return out

    # -- the IR checks' record ---------------------------------------------
    def _sequence(self, name: str, ins, outs) -> None:
        """One op of the canonical sequence: its name, its inputs' and
        outputs' dtypes and shapes."""
        prog = self.stats.program
        prog.f64_values += sum(t.dtype == torch.float64
                               for t in (*ins, *outs))
        self._seq.update(f"{name}({_sig(ins)})->({_sig(outs)});".encode())

    def _program(self, func, name: str, collective: Optional[str], ins,
                 outs) -> None:
        prog = self.stats.program
        self._sequence(name, ins, outs)
        if collective is not None and outs:
            rec = {"op": collective, "numel": outs[0].numel(),
                   "bytes": _nbytes(outs[0]),
                   "dims": [int(d) for d in outs[0].shape]}
            prog.collectives.append(rec)
            if self.in_loop:
                prog.loop_collectives.append(rec)
        elif (f"{func.namespace}::{func._opname}" == _GEMM_OP
              or func.overloadpacket in flop_registry) and outs:
            a, b = ins[:2] if name == "repro_torch.gemm" else ins[-2:]
            prog.dots.append({"lhs": _dtype_name(a.dtype),
                              "rhs": _dtype_name(b.dtype),
                              "out": _dtype_name(outs[0].dtype)})
        elif func._opname == "_to_copy" or (
                func._opname == "copy_" and len(ins) == 2):
            src, dst = (ins[1], ins[0]) if func._opname == "copy_" else (
                ins[0], outs[0])
            self._convert(src.dtype, dst)
        elif torch.Tag.pointwise in func.tags and outs:
            dst = outs[0]
            for t in ins:
                if (t.dtype != dst.dtype and t.dtype.is_floating_point
                        and dst.dtype.is_floating_point):
                    self._convert(t.dtype, t, dst.dtype)

    def _convert(self, src: torch.dtype, dst: torch.Tensor,
                 dst_dtype: Optional[torch.dtype] = None) -> None:
        """A conversion from ``src`` to ``dst_dtype`` (default ``dst``'s)
        of a tensor of ``dst``'s shape."""
        dst_dtype = dst_dtype or dst.dtype
        if src != dst_dtype:
            self.stats.program.converts.append({
                "src": _dtype_name(src), "dst": _dtype_name(dst_dtype),
                "numel": dst.numel(), "dims": [int(d) for d in dst.shape]})

    def _product(self, func, args, kwargs, out) -> None:
        if f"{func.namespace}::{func._opname}" == _GEMM_OP:
            a, b = args[0], args[1]
            flops = 2 * a.shape[0] * a.shape[1] * b.shape[1]
        elif func.overloadpacket in flop_registry:
            flops = flop_registry[func.overloadpacket](*args, **kwargs,
                                                       out_val=out)
            a, b = [x for x in args if isinstance(x, torch.Tensor)][-2:]
        else:
            return
        if not flops:
            return
        s = self.stats
        s.flops += flops
        s.dot_count += 1
        dt = _dtype_name(self._unit_dtype
                         or torch.promote_types(a.dtype, b.dtype))
        s.flops_by_dtype[dt] = s.flops_by_dtype.get(dt, 0.0) + flops
        if self.sites:
            self._site_flops[self._site()] += flops

    def _collective(self, op: str, args, outs) -> None:
        s = self.stats
        rbytes = sum(map(_nbytes, outs))
        g = _group_size(args)
        s.collective_result_bytes[op] += rbytes
        s.collective_link_bytes += _link_bytes(op, rbytes, g)
        s.collective_count += 1
        shape = "x".join(map(str, outs[0].shape)) if outs else ""
        s.top_collectives.append((rbytes, op, shape, g))
        s.top_collectives.sort(reverse=True)
        del s.top_collectives[12:]

    def finish(self) -> None:
        s = self.stats
        s.op_histogram = dict(self._hist.most_common())
        if s.program is not None:
            s.program.program_hash = self._seq.hexdigest()
            s.program.prim_histogram = dict(sorted(self._hist.items()))
        if self.sites:
            s.flops_by_site = dict(self._site_flops.most_common())
        for b, sq, skv, h, d, causal in self._flash:
            s.flash_flops += 4.0 * d * h * b * flash_pairs(sq, skv, causal)
        s.flash_calls = len(self._flash)


def _site_name(path: str, fn: str) -> str:
    return f"{os.path.splitext(os.path.basename(path))[0]}.{fn}"


def _group_size(args) -> int:
    """The size of a c10d functional op's process group, by the group
    name (its last string argument; the ops' other strings are reduce
    ops)."""
    from torch.distributed import distributed_c10d as c10d
    for name in reversed([a for a in args[1:] if isinstance(a, str)]):
        try:
            return c10d._resolve_process_group(name).size()
        except (RuntimeError, KeyError, ValueError):
            continue
    return 1


@contextlib.contextmanager
def count_step(*arg_trees, sites: bool = False, program: bool = False):
    """Count the ops dispatched in this scope into the yielded
    :class:`StepStats` (filled when the scope closes).  ``arg_trees``:
    the step's arguments (state, batch, cache), live from the start.
    ``sites`` also splits product flops by model function, with autograd's
    anomaly mode on so that a backward product finds its forward's;
    ``program`` keeps the IR checks' :class:`ProgramRecord`."""
    stats = StepStats()
    counter = StepCounter(stats, sites, program)
    counter.track(arg_trees)
    stats.argument_bytes = counter._live_bytes
    anomaly = (torch.autograd.set_detect_anomaly(True, check_nan=False)
               if sites else contextlib.nullcontext())
    try:
        with execution_context(counter=counter), anomaly, counter:
            yield stats
    finally:
        counter.finish()


@contextlib.contextmanager
def loop_body():
    """Mark the ops of this scope as one iteration of a loop body (a serve
    loop's decode step) for the ambient counter's :class:`ProgramRecord`;
    nothing without one."""
    counter = _ctx().counter
    if not isinstance(counter, StepCounter):
        yield
        return
    outer, counter.in_loop = counter.in_loop, True
    try:
        yield
    finally:
        counter.in_loop = outer
