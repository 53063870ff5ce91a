"""Host-sync lint: the TP00x check family, in PyTorch's terms.

The port's counterpart of the reference's ``analysis/purity.py``.  JAX
refuses most host syncs at trace time; eager PyTorch refuses none of
them, so every ``.item()``, ``.tolist()``, ``.cpu()``, ``int(t)`` and
``if t.any():`` quietly stalls the stream, and a CUDA graph cannot
capture the step around it.  The lint runs over the
:class:`~repro_torch.analysis.callgraph.CallGraph`'s step code (what runs
once per device step) plus the serve/train driver code, and reports:

==========  =========  =====================================================
check id    severity   fires on
==========  =========  =====================================================
``TP001``   error      host transfers and waits: ``.item()`` /
                       ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
                       ``.to("cpu")`` / ``torch.cuda.synchronize`` /
                       ``Event``/``Stream`` ``.synchronize()`` in driver or
                       step code; in step code also ``np.asarray`` /
                       ``np.array`` and ops whose output size depends on
                       the data (``nonzero``, ``argwhere``,
                       ``masked_select``, ``unique``, ``repeat_interleave``
                       of computed repeats without ``output_size``)
``TP002``   error      ``float()``/``int()``/``bool()`` of a computed value
                       in step code (a sync on a device tensor)
``TP003``   error      Python ``if``/``while`` on a device value (a
                       ``torch.`` call, or ``.any()``/``.all()``/
                       ``.item()`` in the test) in step code
``TP004``   error      nondeterminism in step code: ``random.*``,
                       ``time.*``, ``np.random.*``; torch's global
                       generator (``torch.rand*`` / ``randn*`` /
                       ``randint`` / ``randperm`` / ``normal`` /
                       ``bernoulli`` / ``multinomial`` and the in-place
                       samplers without ``generator=``,
                       ``torch.manual_seed``)
``TP005``   error      a model step entry point (a ``Model`` step method,
                       or a step made by ``make_*_step``) called in a
                       serve/train module outside a
                       ``repro_torch.profiling.annotate(...)`` scope
==========  =========  =====================================================

A TP005 call counts as annotated when it sits lexically inside an
``annotate`` (or ``trace``) scope, or in a same-module function whose
every call site in the module is annotated (transitively): the engine's
``_decode_step`` is called only from its wave and chunk scopes.

Sanctioned exceptions carry a pragma **on the offending line or the line
above**::

    host = buf.cpu().numpy()   # analysis: allow(TP001)

``allow(host-transfer)`` (the slug) works too, as does a bare ``analysis:
allow`` to waive every check on that line.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Sequence, Set, Tuple

from repro_torch.analysis.callgraph import (CallGraph, FunctionInfo,
                                            ModuleInfo, STEP_METHODS,
                                            _body_without_nested, call_tail,
                                            dotted_name)
from repro_torch.analysis.findings import Finding, SEV_ERROR

#: check id -> human slug (either form valid in a pragma)
SLUGS = {
    "TP001": "host-transfer",
    "TP002": "host-coercion",
    "TP003": "traced-control-flow",
    "TP004": "nondeterminism",
    "TP005": "missing-annotation",
}

#: subtrees whose drivers may host-sync only at pragma'd lines
DRIVER_PREFIXES = ("src/repro_torch/serve", "src/repro_torch/train")

_PRAGMA_RE = re.compile(r"#\s*analysis:\s*allow(?:\(([^)]*)\))?")

#: method calls that copy a tensor to the host
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
#: ops whose output size depends on the data (a sync to size the output)
_DATA_DEPENDENT = {"nonzero", "argwhere", "masked_select", "unique",
                   "unique_consecutive"}
#: tensor metadata read on the host, no sync: a coercion or test built on
#: it is static
_STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "stride", "numel", "dim",
                 "element_size", "itemsize", "nbytes", "data_ptr",
                 "storage_offset", "get_device", "device", "is_cuda",
                 "requires_grad", "layout"}
_ANNOTATE_TAILS = {"annotate", "trace", "TraceSession", "record_function"}
# call tails that inspect static metadata or host state: legal in a test
_STATIC_CALL_TAILS = {"dtype", "result_type", "promote_types", "can_cast",
                      "finfo", "iinfo", "isinstance", "len", "shape", "ndim",
                      "dim", "size", "numel", "stride", "device",
                      "get_default_dtype", "device_count"}
_STATIC_CALL_PREFIXES = ("is_", "are_", "has_", "get_")
#: torch samplers that draw from the global generator without generator=
_TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "normal",
                   "bernoulli", "multinomial", "rand_like", "randn_like",
                   "randint_like", "poisson"}
_INPLACE_SAMPLERS = {"normal_", "uniform_", "bernoulli_", "random_",
                     "exponential_", "cauchy_", "log_normal_", "geometric_"}
_SEEDERS = {"manual_seed", "manual_seed_all", "seed", "seed_all"}


def pragma_line(mod: ModuleInfo, lineno: int, check_id: str):
    """Line number of the pragma waiving `check_id` at `lineno` (the line
    itself or the one above), or None: the pragma ledger needs to know
    *which* pragma ate a finding, not just that one did."""
    for ln in (lineno, lineno - 1):
        if not (1 <= ln <= len(mod.lines)):
            continue
        m = _PRAGMA_RE.search(mod.lines[ln - 1])
        if m is None:
            continue
        tokens = m.group(1)
        if tokens is None or not tokens.strip():
            return ln                         # bare allow: waive everything
        toks = {t.strip() for t in tokens.split(",")}
        if check_id in toks or SLUGS.get(check_id, "") in toks:
            return ln
    return None


def _head(mod: ModuleInfo, dn: str) -> str:
    """The top-level module a dotted call's base was imported from."""
    base = dn.split(".")[0]
    return mod.imports.get(base, base).split(".")[0]


def _in_try(node: ast.AST, fn_node: ast.AST) -> bool:
    """True when `node` sits under a try: (a probe ``try: int(x)`` /
    ``except`` is a legal static test)."""
    root = fn_node if not isinstance(fn_node, ast.Lambda) else fn_node.body
    for sub in ast.walk(root):
        if isinstance(sub, ast.Try):
            for inner in ast.walk(sub):
                if inner is node:
                    return True
    return False


def _computed(expr: ast.AST) -> bool:
    """Heuristic (the reference's): the expression involves a call or an
    indexing, the shapes real device-value coercions take
    (``float(x.mean())``, ``int(cur[0])``).  Plain arithmetic on local
    names (``int(d * fraction)``) is static dim math and stays silent, as
    is anything built from tensor metadata (``.shape``, ``.stride()``)."""
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
            return False
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Subscript):
            return True
        if isinstance(sub, ast.Call):
            if (dotted_name(sub.func) or "") in ("len", "min", "max",
                                                 "round", "abs"):
                continue
            return True
    return False


def _to_cpu(node: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")`` /
    ``x.to(torch.device("cpu"))``."""
    args = list(node.args) + [k.value for k in node.keywords
                              if k.arg == "device"]
    for a in args:
        if isinstance(a, ast.Constant) and a.value == "cpu":
            return True
        if (isinstance(a, ast.Call) and call_tail(a) == "device" and a.args
                and isinstance(a.args[0], ast.Constant)
                and a.args[0].value == "cpu"):
            return True
    return False


def _has_kw(node: ast.Call, name: str) -> bool:
    return any(k.arg == name for k in node.keywords)


class PurityChecker:
    """Run the TP00x family over one CallGraph.

    ``ledger`` (a :class:`repro_torch.analysis.pragmas.PragmaLedger`,
    duck-typed on ``.record``) is told about every finding a pragma
    suppresses, so the PR900 unused-pragma check can tell live waivers
    from stale ones.
    """

    def __init__(self, graph: CallGraph, ledger=None):
        self.graph = graph
        self.ledger = ledger
        self.findings: List[Finding] = []

    # -- emit ---------------------------------------------------------------

    def _flag(self, check_id: str, mod: ModuleInfo, node: ast.AST,
              scope: str, message: str):
        waiver_ln = pragma_line(mod, node.lineno, check_id)
        if waiver_ln is not None:
            if self.ledger is not None:
                self.ledger.record(mod.path, waiver_ln, check_id)
            return
        self.findings.append(Finding(
            check_id=check_id, severity=SEV_ERROR, path=mod.path,
            line=node.lineno, scope=scope, message=message))

    # -- entry --------------------------------------------------------------

    def run(self) -> List[Finding]:
        for info in self.graph.traced_functions():
            self._check_traced(info)
        for info in self.graph.host_functions(DRIVER_PREFIXES):
            self._check_host_driver(info)
        for path, mod in sorted(self.graph.modules.items()):
            if path.startswith(DRIVER_PREFIXES):
                self._check_annotations(mod)
        return self.findings

    # -- host transfers (driver and step code) --------------------------------

    def _host_transfer(self, mod: ModuleInfo, node: ast.Call, scope: str,
                       where: str) -> bool:
        dn = dotted_name(node.func) or ""
        tail = call_tail(node)
        attr = isinstance(node.func, ast.Attribute)
        if tail in _HOST_METHODS and attr:
            what = f"`.{tail}()`"
        elif tail == "to" and attr and _to_cpu(node):
            what = "`.to(\"cpu\")`"
        elif tail == "synchronize" and (attr or _head(mod, dn) == "torch"):
            what = f"`{dn or '.synchronize'}()`"
        else:
            return False
        self._flag("TP001", mod, node, scope,
                   f"{what} waits for the device in {where} (pragma the "
                   f"one sanctioned site)")
        return True

    # -- step-code checks -----------------------------------------------------

    def _check_traced(self, info: FunctionInfo):
        mod = self.graph.modules[info.path]
        scope = info.qualname
        for node in _body_without_nested(info.node):
            if isinstance(node, ast.Call):
                self._traced_call(mod, info, node, scope)
            elif isinstance(node, (ast.If, ast.While)):
                self._traced_branch(mod, node, scope)

    def _traced_call(self, mod: ModuleInfo, info: FunctionInfo,
                     node: ast.Call, scope: str):
        dn = dotted_name(node.func) or ""
        parts = dn.split(".") if dn else []
        tail = call_tail(node)
        head = _head(mod, dn) if dn else ""

        # TP001: host transfers, numpy pulls, data-dependent output sizes
        if self._host_transfer(mod, node, scope, "step code"):
            pass
        elif tail in {"asarray", "array"} and head == "numpy":
            self._flag("TP001", mod, node, scope,
                       f"`{dn}` pulls a device value to host numpy")
        elif tail in _DATA_DEPENDENT and (isinstance(node.func,
                                                     ast.Attribute)):
            self._flag("TP001", mod, node, scope,
                       f"`{tail}` sizes its output from the data: a "
                       f"device-to-host sync")
        elif tail == "repeat_interleave" and not _has_kw(node,
                                                         "output_size"):
            is_fn = head == "torch"
            rep = node.args[1] if is_fn and len(node.args) > 1 else \
                node.args[0] if (not is_fn and node.args) else None
            rep = rep if rep is not None else next(
                (k.value for k in node.keywords if k.arg == "repeats"), None)
            if rep is None or _computed(rep):
                self._flag("TP001", mod, node, scope,
                           "`repeat_interleave` of computed repeats without "
                           "`output_size` syncs to size its output")

        # TP002: host coercion of a computed value
        elif tail in {"float", "int", "bool"} and len(parts) == 1 \
                and node.args:
            if _computed(node.args[0]) and not _in_try(node, info.node):
                self._flag("TP002", mod, node, scope,
                           f"`{tail}()` on a computed value copies it to "
                           f"the host (a sync on a device tensor)")

        # TP004: nondeterminism
        if len(parts) >= 2 and head in {"random", "time"}:
            self._flag("TP004", mod, node, scope,
                       f"`{dn}` is host nondeterminism/clock state inside "
                       f"the step")
        elif len(parts) >= 2 and head == "numpy" and "random" in parts:
            self._flag("TP004", mod, node, scope,
                       f"`{dn}` draws from the host RNG; use a "
                       f"torch.Generator passed as generator=")
        elif head == "torch" and tail in _SEEDERS:
            self._flag("TP004", mod, node, scope,
                       f"`{dn}` reseeds torch's global generator inside "
                       f"the step")
        elif (head == "torch" and tail in _TORCH_SAMPLERS
              and not _has_kw(node, "generator")):
            self._flag("TP004", mod, node, scope,
                       f"`{dn}` draws from torch's global generator; pass "
                       f"an explicit generator=")
        elif (tail in _INPLACE_SAMPLERS and isinstance(node.func,
                                                       ast.Attribute)
              and not _has_kw(node, "generator")):
            self._flag("TP004", mod, node, scope,
                       f"`.{tail}()` draws from torch's global generator; "
                       f"pass an explicit generator=")

    def _traced_branch(self, mod: ModuleInfo, node: ast.AST, scope: str):
        kind = "if" if isinstance(node, ast.If) else "while"
        for sub in ast.walk(node.test):
            if not isinstance(sub, ast.Call):
                continue
            dn = dotted_name(sub.func) or ""
            tail = call_tail(sub)
            if tail in _STATIC_CALL_TAILS or tail.startswith(
                    _STATIC_CALL_PREFIXES):
                continue          # metadata / host state: static
            device_method = (isinstance(sub.func, ast.Attribute)
                             and tail in {"any", "all", "item"})
            if (dn and "." in dn and _head(mod, dn) == "torch") \
                    or device_method:
                self._flag(
                    "TP003", mod, node, scope,
                    f"Python `{kind}` on a device value (`{dn or tail}` in "
                    f"the test) syncs every step; use torch.where or a "
                    f"host-side value")
                return

    # -- host-driver checks --------------------------------------------------

    def _check_host_driver(self, info: FunctionInfo):
        """In serve/train driver code only the pragma'd once-per-wave or
        once-per-chunk transfer may sync: every other one is a leak."""
        mod = self.graph.modules[info.path]
        for node in _body_without_nested(info.node):
            if isinstance(node, ast.Call):
                self._host_transfer(mod, node, info.qualname, "driver code")

    # -- annotation coverage -------------------------------------------------

    def _step_entry_names(self, mod: ModuleInfo) -> Set[str]:
        """``Model`` step methods, and names bound to a ``make_*_step``
        result in this module (``self._step = make_train_step(...)``)."""
        names: Set[str] = set(STEP_METHODS)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)):
                continue
            tail = call_tail(node.value)
            if not (tail.startswith("make_") and tail.endswith("_step")):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute):
                    names.add(tgt.attr)
                elif isinstance(tgt, ast.Name):
                    names.add(tgt.id)
        return names

    def _is_annotate_with(self, stmt: ast.With) -> bool:
        for item in stmt.items:
            ctx = item.context_expr
            if isinstance(ctx, ast.Call) and call_tail(ctx) in \
                    _ANNOTATE_TAILS:
                return True
        return False

    def _calls(self, body: Sequence[ast.stmt], annotated: bool
               ) -> List[Tuple[ast.Call, bool]]:
        """Every call in ``body`` (not in nested defs or classes) with
        whether it sits inside an ``annotate`` scope."""
        out: List[Tuple[ast.Call, bool]] = []
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue                        # its own scope
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = annotated or self._is_annotate_with(stmt)
                for item in stmt.items:
                    out += [(c, annotated) for c in ast.walk(item)
                            if isinstance(c, ast.Call)]
                out += self._calls(stmt.body, inner)
                continue
            sub_bodies: List[Sequence[ast.stmt]] = []
            if isinstance(stmt, (ast.If, ast.For, ast.AsyncFor, ast.While)):
                sub_bodies = [stmt.body, stmt.orelse]
            elif isinstance(stmt, ast.Try):
                sub_bodies = [stmt.body, stmt.orelse, stmt.finalbody] + \
                    [h.body for h in stmt.handlers]
            for sb in sub_bodies:
                out += self._calls(sb, annotated)
            headers = [c for c in ast.iter_child_nodes(stmt)
                       if not isinstance(c, (ast.stmt, ast.excepthandler))
                       ] if sub_bodies else [stmt]
            for header in headers:
                out += [(c, annotated) for c in ast.walk(header)
                        if isinstance(c, ast.Call)]
        return out

    def _annotated_functions(self, mod: ModuleInfo,
                             fns: List[FunctionInfo]) -> Set[str]:
        """Qualnames of the module's functions whose every call site in
        the module is annotated, directly or through such a function."""
        by_name: Dict[str, List[FunctionInfo]] = {}
        for info in fns:
            by_name.setdefault(info.name, []).append(info)
        sites: Dict[str, List[Tuple[str, bool]]] = {}
        for info in fns:
            for call, annotated in self._calls(info.node.body, False):
                func = call.func
                name = func.attr if (isinstance(func, ast.Attribute)
                                     and isinstance(func.value, ast.Name)
                                     and func.value.id == "self") \
                    else (func.id if isinstance(func, ast.Name) else None)
                for callee in by_name.get(name, ()):
                    sites.setdefault(callee.qualname, []).append(
                        (info.qualname, annotated))
        done: Set[str] = set()
        changed = True
        while changed:
            changed = False
            for qual, calls in sites.items():
                if qual not in done and all(a or caller in done
                                            for caller, a in calls):
                    done.add(qual)
                    changed = True
        return done

    def _check_annotations(self, mod: ModuleInfo):
        entries = self._step_entry_names(mod)
        fns = [i for i in mod.functions
               if not isinstance(i.node, ast.Lambda)
               and not self.graph.is_traced(i)]
        covered = self._annotated_functions(mod, fns)
        for info in fns:
            for call, annotated in self._calls(info.node.body,
                                               info.qualname in covered):
                if annotated:
                    continue
                func = call.func
                name = func.attr if isinstance(func, ast.Attribute) \
                    else (func.id if isinstance(func, ast.Name) else "")
                if name in entries:
                    self._flag(
                        "TP005", mod, call, info.qualname,
                        f"step entry `{name}` called outside any "
                        f"profiling.annotate(...) scope: invisible in "
                        f"trace breakdowns")
