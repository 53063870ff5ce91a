"""AST module index + the step-code call graph over ``src/repro_torch``.

The port's counterpart of the reference's ``analysis/callgraph.py``.  The
reference's lint needs to know which functions run under a JAX trace; in
eager PyTorch nothing is traced, and what matters instead is **step
code**: what runs once per device step, and what a CUDA graph would
capture.  A host sync there stalls the stream every step (eager PyTorch
refuses none of them), and a graph capture of it fails.  Driver code
(the serve engine's scheduling, the trainer's loop) may sync, but only at
its sanctioned, pragma'd lines.

1. **Index** every function (nested defs and lambdas included) of every
   module under the package, by simple name and by qualname.
2. **Roots** (the port's step entry points):

   * the step methods of ``Model`` (``forward``, ``forward_hidden``,
     ``prefill``, ``decode_step``: ``models/model.py``);
   * ``forward`` / ``backward`` / ``setup_context`` of every
     ``torch.autograd.Function`` subclass;
   * the bodies ``torch.library`` registers: a ``custom_op``-decorated
     function, ``register_fake`` / ``register_kernel`` ones, and the
     functions given to ``register_autograd`` (``core/gemm_api.py``);
   * functions given to ``torch.utils.checkpoint.checkpoint``, directly
     or through ``functools.partial(checkpoint, fn, ...)``;
   * the nested defs of a ``make_*_step`` factory: the step
     ``train/trainer.py::make_train_step`` returns (and its prefill and
     decode siblings);
   * the functions the serve engine calls inside its decode scopes
     (``with annotate("serve.decode_chunk")`` / ``"serve.decode_wave"``):
     the paged gather, the decode step, the sampler and the paged scatter
     a CUDA graph over the decode step would capture.  The scope's own
     body stays driver code: its one sanctioned transfer is there.

3. **Reachability**: BFS over call edges, as in the reference.  Bare and
   attribute callee names resolve against the index; attribute calls
   whose base is an external module alias (``torch``, ``F``, ``np``,
   ``os``, ...) and generic container or tensor method names (``.get``,
   ``.view``, ...) are excluded, so library lookalikes do not drag host
   code into the step set.

This over-approximates (a helper called from both host and step code is
step code): the conservatism a host-sync lint wants.
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: the package the port's lint scans, relative to the repository root
PACKAGE_DIR = "src/repro_torch"
#: the import root of the package: aliases of anything else are external
PACKAGE_ROOT = "repro_torch"

#: ``Model`` methods that run one device step
STEP_METHODS = ("forward", "forward_hidden", "prefill", "decode_step")
#: methods of a ``torch.autograd.Function`` subclass autograd calls
AUTOGRAD_METHODS = ("forward", "backward", "setup_context", "jvp", "vjp")
#: decorators (by tail) that register a ``torch.library`` body
_LIBRARY_DECORATORS = {"custom_op", "register_fake", "register_kernel",
                       "impl", "register_autocast", "register_vmap"}
#: calls (by tail) whose function-valued arguments are ``torch.library``
#: bodies
_LIBRARY_CALLS = {"register_autograd", "register_fake", "register_kernel",
                  "register_vmap"}
_LIBRARY_KEYWORDS = {"setup_context", "backward", "fn", "func"}
#: ``annotate`` labels whose scope's callees are step code
STEP_SCOPE_PREFIX = "serve.decode"

# attribute-call names too generic to resolve against the index when the
# receiver is not `self`: stdlib/container lookalikes and tensor methods
GENERIC_METHOD_NAMES = {
    "get", "add", "update", "items", "keys", "values", "append", "extend",
    "pop", "popleft", "copy", "clear", "join", "split", "strip", "format",
    "read", "write", "close", "open", "mean", "sum", "max", "min", "all",
    "any", "astype", "reshape", "transpose", "at", "set", "dot", "sort",
    "count", "index", "insert", "remove", "save", "load", "render",
    "startswith", "endswith", "replace", "lower", "upper", "setdefault",
    "todo", "put", "run", "result",
    # torch.Tensor methods
    "to", "view", "float", "half", "bfloat16", "int", "long", "bool",
    "contiguous", "clone", "detach", "t", "flatten", "unflatten",
    "squeeze", "unsqueeze", "expand", "expand_as", "permute", "narrow",
    "select", "index_select", "index_copy_", "index_add_", "copy_",
    "fill_", "zero_", "add_", "mul_", "sub_", "div_", "clamp", "clamp_",
    "new_zeros", "new_empty", "new_ones", "new_full", "type_as",
    "masked_fill", "masked_fill_", "scatter_", "gather", "chunk",
    "unbind", "repeat", "split_with_sizes", "exp", "log", "sqrt",
    "rsqrt", "pow", "abs", "neg", "softmax", "log_softmax", "argmax",
    "cumsum", "matmul", "mm", "bmm", "einsum", "where", "size", "dim",
    "numel", "stride", "element_size", "data_ptr", "storage_offset",
    "get_device", "requires_grad_", "register_hook", "apply_", "cuda",
    "cpu", "item", "tolist", "numpy", "synchronize", "record", "wait",
    "wait_event", "wait_stream", "record_stream", "elapsed_time",
    "save_for_backward", "mark_non_differentiable", "retain_grad",
}

# calls that take a function argument and invoke it under the caller's
# step: their Name/Lambda args become step code too
_HIGHER_ORDER_TAILS = {
    "map_tree", "map_trees", "tree_map", "partial", "map", "filter",
    "sorted", "reduce", "apply", "checkpoint",
}


@dataclasses.dataclass
class FunctionInfo:
    """One function (or lambda) definition found in the scanned tree."""
    path: str                 # repo-relative module path
    qualname: str             # e.g. "Engine._decode_step"
    name: str                 # simple name ("_decode_step"; "<lambda>")
    node: ast.AST             # FunctionDef | AsyncFunctionDef | Lambda
    lineno: int
    #: the enclosing class's name and bases (None outside a class body)
    cls: Optional[str] = None
    cls_bases: Tuple[str, ...] = ()

    @property
    def key(self) -> str:
        return f"{self.path}:{self.qualname}"


class ModuleInfo:
    """Per-module artifacts the indexer keeps around for resolution."""

    def __init__(self, path: str, tree: ast.Module, source: str):
        self.path = path
        self.tree = tree
        self.lines = source.splitlines()
        self.functions: List[FunctionInfo] = []
        # local alias -> fully dotted module/name it was imported as
        self.imports: Dict[str, str] = {}
        # simple local/global name -> Call node it was assigned from
        self.assigned_calls: Dict[str, ast.Call] = {}


def _body_without_nested(fn_node: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body, not descending into nested function defs or
    lambdas (those are indexed and analyzed as their own scopes)."""
    if isinstance(fn_node, ast.Lambda):
        stack: List[ast.AST] = [fn_node.body]
    else:
        stack = list(fn_node.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.cuda.synchronize`` -> "torch.cuda.synchronize"; None for
    chains that do not start at a name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _scope_label(node: ast.With) -> Optional[str]:
    """The label of a ``with annotate("label")`` statement, or None."""
    for item in node.items:
        ctx = item.context_expr
        if (isinstance(ctx, ast.Call) and call_tail(ctx) == "annotate"
                and ctx.args and isinstance(ctx.args[0], ast.Constant)
                and isinstance(ctx.args[0].value, str)):
            return ctx.args[0].value
    return None


def call_tail(node: ast.Call) -> str:
    """The called attribute or name (``x.item()`` -> "item"), also for a
    receiver that is itself a call (``f(x).tolist()``)."""
    func = node.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


class _Indexer(ast.NodeVisitor):
    def __init__(self, mod: ModuleInfo):
        self.mod = mod
        self.scope: List[str] = []
        self.classes: List[Tuple[str, Tuple[str, ...]]] = []

    def _register(self, name: str, node: ast.AST):
        qual = ".".join(self.scope + [name]) if self.scope else name
        cls, bases = (None, ())
        if self.classes and self.scope and self.scope[-1] == \
                self.classes[-1][0]:
            cls, bases = self.classes[-1]
        self.mod.functions.append(
            FunctionInfo(self.mod.path, qual, name, node, node.lineno,
                         cls, bases))

    def visit_Import(self, node: ast.Import):
        for a in node.names:
            self.mod.imports[a.asname or a.name.split(".")[0]] = a.name

    def visit_ImportFrom(self, node: ast.ImportFrom):
        base = node.module or ""
        for a in node.names:
            self.mod.imports[a.asname or a.name] = f"{base}.{a.name}"

    def visit_ClassDef(self, node: ast.ClassDef):
        bases = tuple(dotted_name(b) or "" for b in node.bases)
        self.classes.append((node.name, bases))
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()
        self.classes.pop()

    def _visit_fn(self, node):
        self._register(node.name, node)
        self.scope.extend([node.name, "<locals>"])
        self.generic_visit(node)
        self.scope.pop()
        self.scope.pop()

    visit_FunctionDef = _visit_fn
    visit_AsyncFunctionDef = _visit_fn

    def visit_Lambda(self, node: ast.Lambda):
        self._register("<lambda>", node)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign):
        if isinstance(node.value, ast.Call):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self.mod.assigned_calls[tgt.id] = node.value
        self.generic_visit(node)


class CallGraph:
    """Index of every function under a source root + the step-code subset.

    ``traced`` / ``traced_via`` keep the reference's names: the set is the
    port's step code, and ``traced_via`` says why each function is in it."""

    def __init__(self, root: str, package_dir: str = PACKAGE_DIR):
        self.root = os.path.abspath(root)
        self.package_dir = package_dir
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_name: Dict[str, List[FunctionInfo]] = {}
        self.by_key: Dict[str, FunctionInfo] = {}
        self._scan()
        self.traced: Dict[str, FunctionInfo] = {}
        self.traced_via: Dict[str, str] = {}   # key -> why it is step code
        self._mark_traced()

    # -- indexing ----------------------------------------------------------

    def _scan(self):
        pkg = os.path.join(self.root, self.package_dir)
        for dirpath, dirnames, filenames in os.walk(pkg):
            dirnames.sort()
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, self.root)
                with open(full) as f:
                    source = f.read()
                mod = ModuleInfo(rel, ast.parse(source, filename=rel), source)
                _Indexer(mod).visit(mod.tree)
                self.modules[rel] = mod
                for info in mod.functions:
                    self.by_name.setdefault(info.name, []).append(info)
                    self.by_key[info.key] = info

    # -- alias / external classification -----------------------------------

    def _is_external_base(self, mod: ModuleInfo, base: str) -> bool:
        """True when `base.attr(...)`'s base names a module outside the
        package (``torch``, ``F``, ``np``, ...)."""
        target = mod.imports.get(base)
        if target is None:
            return False
        return target.split(".")[0] != PACKAGE_ROOT

    def _imported_from(self, mod: ModuleInfo, name: str, *prefixes) -> bool:
        target = mod.imports.get(name.split(".")[0], "")
        return any(target.startswith(p) for p in prefixes)

    # -- step-root discovery -----------------------------------------------

    def _is_checkpoint(self, mod: ModuleInfo, expr: ast.AST) -> bool:
        """``checkpoint`` from ``torch.utils.checkpoint`` (or its dotted
        form ``torch.utils.checkpoint.checkpoint``)."""
        dn = dotted_name(expr) or ""
        if dn.split(".")[-1] != "checkpoint":
            return False
        if "." in dn:
            return self._imported_from(mod, dn, "torch")
        return mod.imports.get(dn, "").startswith("torch.utils.checkpoint")

    def _is_autograd_function(self, info: FunctionInfo) -> bool:
        return any(b.split(".")[-1] == "Function"
                   and (b.startswith("torch.autograd")
                        or b.startswith("autograd")
                        or b == "Function")
                   for b in info.cls_bases)

    def _roots(self) -> List[Tuple[FunctionInfo, str]]:
        out: List[Tuple[FunctionInfo, str]] = []
        for mod in self.modules.values():
            for info in mod.functions:
                where = f"{mod.path}:{info.lineno}"
                if info.cls == "Model" and info.name in STEP_METHODS:
                    out.append((info, f"{where} Model step method"))
                elif (info.name in AUTOGRAD_METHODS
                      and self._is_autograd_function(info)):
                    out.append((info, f"{where} autograd.Function"))
                if info.name.startswith("make_") and \
                        info.name.endswith("_step"):
                    for nested in self._nested_of(info):
                        out.append((nested, f"{where} {info.name}()"))
                for dec in getattr(info.node, "decorator_list", ()):
                    target = dec.func if isinstance(dec, ast.Call) else dec
                    tail = (dotted_name(target) or "").split(".")[-1]
                    if tail in _LIBRARY_DECORATORS:
                        out.append((info, f"{where} @{tail}"))
            for node in ast.walk(mod.tree):
                if isinstance(node, (ast.With, ast.AsyncWith)):
                    label = _scope_label(node)
                    if label and label.startswith(STEP_SCOPE_PREFIX):
                        out += [(info, f"{mod.path}:{node.lineno} "
                                       f"annotate({label!r})")
                                for info in self._scope_callees(mod, node)]
                if not isinstance(node, ast.Call):
                    continue
                why = f"{mod.path}:{node.lineno}"
                fn_args: List[ast.AST] = []
                tail = call_tail(node)
                if self._is_checkpoint(mod, node.func) and node.args:
                    fn_args = [node.args[0]]
                    why += " checkpoint()"
                elif (tail == "partial" and len(node.args) >= 2
                      and self._is_checkpoint(mod, node.args[0])):
                    fn_args = [node.args[1]]
                    why += " partial(checkpoint, ...)"
                elif tail in _LIBRARY_CALLS and isinstance(node.func,
                                                           ast.Attribute):
                    fn_args = [a for a in node.args
                               if isinstance(a, (ast.Name, ast.Lambda,
                                                 ast.Attribute))]
                    fn_args += [k.value for k in node.keywords
                                if k.arg in _LIBRARY_KEYWORDS]
                    why += f" {tail}()"
                for arg in fn_args:
                    for info in self._resolve_fn_expr(mod, arg):
                        out.append((info, why))
        return out

    def _scope_callees(self, mod: ModuleInfo, node: ast.With
                       ) -> List[FunctionInfo]:
        """What the calls in a ``with`` body resolve to (a function
        defined inside the body excluded), as a function body's callees."""
        body = ast.FunctionDef(name="<scope>", args=None, body=node.body,
                               decorator_list=[], lineno=node.lineno)
        return self._callees(FunctionInfo(mod.path, "<scope>", "<scope>",
                                          body, node.lineno))

    def _resolve_fn_expr(self, mod: ModuleInfo, expr: ast.AST,
                         depth: int = 0) -> List[FunctionInfo]:
        """Resolve a function-valued expression to candidate definitions."""
        if depth > 4:
            return []
        if isinstance(expr, ast.Lambda):
            for info in self.modules[mod.path].functions:
                if info.node is expr:
                    return [info]
            return []
        if isinstance(expr, ast.Call):
            # adapter idiom: functools.partial(fn, x)
            out: List[FunctionInfo] = []
            for arg in list(expr.args) + [k.value for k in expr.keywords]:
                out.extend(self._resolve_fn_expr(mod, arg, depth + 1))
            # factory idiom: the step is the factory's nested defs
            dn = dotted_name(expr.func)
            if dn is not None:
                for target in self._resolve_name(mod, dn.split(".")[-1],
                                                 prefer_module=True):
                    out.extend(self._nested_of(target))
            return out
        if isinstance(expr, ast.Name):
            assigned = mod.assigned_calls.get(expr.id)
            if assigned is not None:
                got = self._resolve_fn_expr(mod, assigned, depth + 1)
                if got:
                    return got
            return self._resolve_bare(mod, expr.id)
        if isinstance(expr, ast.Attribute):
            base = dotted_name(expr.value)
            if base and self._is_external_base(mod, base.split(".")[0]):
                return []
            return self._resolve_attr(mod, base, expr.attr)
        return []

    def _resolve_name(self, mod: ModuleInfo, name: str,
                      prefer_module: bool) -> List[FunctionInfo]:
        candidates = self.by_name.get(name, [])
        if prefer_module:
            local = [c for c in candidates if c.path == mod.path]
            if local:
                return local
        return candidates

    def _internal_module(self, mod: ModuleInfo, alias: str
                         ) -> Optional[Tuple[str, str]]:
        """(path prefix of the module, imported name) an alias of the
        package was imported as, or None for anything else."""
        target = mod.imports.get(alias)
        if target is None or target.split(".")[0] != PACKAGE_ROOT:
            return None
        src = os.path.dirname(self.package_dir)
        return (os.path.join(src, *target.split(".")),
                target.split(".")[-1])

    def _in_module(self, name: str, prefix: str) -> List[FunctionInfo]:
        """Defs named ``name`` in the module (or package) at ``prefix``."""
        return [c for c in self.by_name.get(name, [])
                if c.path == prefix + ".py"
                or c.path.startswith(prefix + os.sep)]

    def _resolve_bare(self, mod: ModuleInfo, name: str
                      ) -> List[FunctionInfo]:
        """A bare name, as Python binds it: a def of this module, else a
        def imported from the package; a parameter or local variable (or
        a builtin) resolves to nothing."""
        local = [c for c in self.by_name.get(name, []) if c.path == mod.path]
        if local:
            return local
        imported = self._internal_module(mod, name)
        if imported is None:
            return []
        prefix, real = imported
        return (self._in_module(real, os.path.dirname(prefix))
                or self.by_name.get(real, []))

    def _resolve_attr(self, mod: ModuleInfo, base: Optional[str],
                      attr: str) -> List[FunctionInfo]:
        """``base.attr``: a package module's def when ``base`` is one;
        ``self.attr`` this module's defs first; anything else every def of
        that name (the receiver's type is unknown)."""
        if base and "." not in base:
            imported = self._internal_module(mod, base)
            if imported is not None:
                got = self._in_module(attr, imported[0])
                if got:
                    return got
        if base == "self":
            return self._resolve_name(mod, attr, prefer_module=True)
        return self._resolve_name(mod, attr, prefer_module=False)

    def _nested_of(self, info: FunctionInfo) -> List[FunctionInfo]:
        prefix = info.qualname + ".<locals>."
        return [c for c in self.modules[info.path].functions
                if c.qualname.startswith(prefix)]

    def _mark_traced(self):
        queue = self._roots()
        queue.reverse()
        while queue:
            info, why = queue.pop()
            if info.key in self.traced:
                continue
            self.traced[info.key] = info
            self.traced_via[info.key] = why
            for callee in self._callees(info):
                queue.append((callee, f"called from {info.key}"))

    def _callees(self, info: FunctionInfo) -> List[FunctionInfo]:
        mod = self.modules[info.path]
        out: List[FunctionInfo] = []
        for node in _body_without_nested(info.node):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Name):
                assigned = mod.assigned_calls.get(func.id)
                if assigned is not None:
                    out.extend(self._resolve_fn_expr(mod, assigned, 1))
                out.extend(self._resolve_bare(mod, func.id))
            elif isinstance(func, ast.Attribute):
                base = dotted_name(func.value)
                base_head = base.split(".")[0] if base else None
                if base_head and self._is_external_base(mod, base_head):
                    pass
                elif base != "self" and func.attr in GENERIC_METHOD_NAMES:
                    pass
                else:
                    out.extend(self._resolve_attr(mod, base, func.attr))
            # function-valued arguments, only of calls known to be higher
            # order: resolving every Name argument would drag in unrelated
            # defs that share a variable's name
            tail = call_tail(node)
            if tail in _HIGHER_ORDER_TAILS:
                for arg in node.args:
                    if isinstance(arg, (ast.Lambda, ast.Name)):
                        out.extend(self._resolve_fn_expr(mod, arg, 3))
            else:
                for arg in node.args:
                    if isinstance(arg, ast.Lambda):
                        out.extend(self._resolve_fn_expr(mod, arg, 3))
        return out

    # -- public queries ----------------------------------------------------

    def is_traced(self, info: FunctionInfo) -> bool:
        return info.key in self.traced

    def traced_functions(self) -> List[FunctionInfo]:
        return sorted(self.traced.values(), key=lambda i: (i.path, i.lineno))

    def host_functions(self, path_prefixes: Sequence[str]
                       ) -> List[FunctionInfo]:
        """Functions outside step code in the given subtrees (the serve
        and train drivers)."""
        out = []
        for mod in self.modules.values():
            if not any(mod.path.startswith(p) for p in path_prefixes):
                continue
            out.extend(i for i in mod.functions if i.key not in self.traced)
        return sorted(out, key=lambda i: (i.path, i.lineno))
