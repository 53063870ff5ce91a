"""Trace one :class:`~repro_torch.analysis.ir.matrix.IRCase` and distill
each entry point's program into a check-ready :class:`EntrySummary`.

The reference lowers and compiles each jitted entry through XLA and reads
the jaxpr and the compiled HLO.  The port runs eagerly, so its "program"
is the sequence of ATen ops an entry dispatches: the tracer builds a
*real* engine (tiny ``.reduced()`` params on CPU tensors, so a host pays
seconds) and runs each entry once under ``launch.step_stats``'s
``TorchDispatchMode`` counter (``count_step(..., program=True)``).  K1,
the einsums and K2 are counted as one unit each, as the card launches
them; what their plain versions do inside on the CPU is not part of the
program.

* wave: the prefill (``Engine._prefill_wave``), one decode loop
  (``Engine._decode_loop``; entry ``decode_loop``) and the train step,
  built as ``launch/dryrun.py::lower_cell`` builds it, on fake tensors;
* continuous: one admission (``Engine._admit_batch``) and one decode
  chunk (``Engine._run_chunk``).

The prompt bucket is 16, the decode chunk's width 16 and the wave's 8, as
in the reference.  A mesh case runs as rank 0 of a fake process group
(``launch.mesh.make_fake_mesh``): its collectives move no data, so its
values are garbage while its shapes and op sequence are the rank's.

Everything the checks need is extracted here into a JSON-serializable
summary: the op-sequence hash and histogram (IR005), dtype conversions
and product dtypes (IR002), argument and peak bytes (IR003), and the
collectives, those of the decode steps apart (IR001; the port's only
program loop is the serve loop, which runs ``Engine._decode_step`` once a
token).  The summary lands in the ``.ir_cache/`` disk cache, keyed on
(source tree digest, torch version, case id), so checks re-run instantly
while nothing changed.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import time
from typing import Dict, List, Optional

import torch

from repro_torch.analysis.ir.matrix import SERVE_KW, IRCase
from repro_torch.launch.step_stats import count_step, loop_body
from repro_torch.serve.engine import Engine

#: bump when the summary extraction changes shape: invalidates .ir_cache
SUMMARY_SCHEMA_VERSION = 1

#: params leaves at least this many elements wide (and >= 2-d) count as
#: "weights" for the weight-sized-collective and weight-upcast checks
WEIGHT_NUMEL_MIN = 1024

#: the traced prompt bucket, and the decode widths of a chunk and a wave
PLEN = 16
CHUNK_WIDTH = 16
WAVE_WIDTH = 8


@dataclasses.dataclass
class EntrySummary:
    """Check-ready distillation of one traced entry point."""
    entry: str
    program_hash: str
    prim_histogram: Dict[str, int]
    # dtype conversions: {"src", "dst", "numel", "dims"}
    converts: List[dict]
    # products: {"lhs", "rhs", "out"}
    dots: List[dict]
    f64_avals: int
    # argument_bytes and peak_bytes of the traced run (StepStats)
    memory: Dict[str, Optional[int]]
    # collectives inside the decode steps: {"op", "numel", "bytes", "dims"}
    while_collectives: List[dict]
    # every collective of the entry (same record shape)
    collectives: List[dict]
    seconds: float = 0.0

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, blob: dict) -> "EntrySummary":
        return cls(**blob)


@dataclasses.dataclass
class CaseResult:
    """All entry summaries of one case plus the case-level context the
    checks key on (weight sizes, resolved hardware, failures)."""
    case_id: str
    entries: Dict[str, EntrySummary]
    # >=2-d, >=WEIGHT_NUMEL_MIN-element params leaf shapes, plus their
    # leading-dim-sliced variants (one layer of a stacked (L, ...) leaf):
    # the identity "weight-sized" checks match on
    weight_shapes: List[List[int]]
    params_bytes: int
    hardware: str
    torch_version: str
    # entry -> "ExcType: message" for entries that failed to trace
    errors: Dict[str, str] = dataclasses.field(default_factory=dict)
    cached: bool = False
    seconds: float = 0.0

    def to_json(self) -> dict:
        blob = dataclasses.asdict(self)
        blob["schema_version"] = SUMMARY_SCHEMA_VERSION
        return blob

    @classmethod
    def from_json(cls, blob: dict) -> "CaseResult":
        blob = dict(blob)
        blob.pop("schema_version", None)
        blob["entries"] = {k: EntrySummary.from_json(v)
                           for k, v in blob["entries"].items()}
        return cls(**blob)


def summarize(entry: str, stats, seconds: float) -> EntrySummary:
    """An :class:`EntrySummary` of one entry's ``StepStats`` (counted with
    ``program=True``)."""
    prog = stats.program
    return EntrySummary(
        entry=entry, program_hash=prog.program_hash,
        prim_histogram=dict(prog.prim_histogram), converts=prog.converts,
        dots=prog.dots, f64_avals=prog.f64_values,
        memory={"argument_bytes": stats.argument_bytes,
                "peak_bytes": stats.peak_bytes},
        while_collectives=prog.loop_collectives,
        collectives=prog.collectives, seconds=round(seconds, 2))


# ---------------------------------------------------------------------------
# case tracing
# ---------------------------------------------------------------------------

def _leaves(params) -> List[torch.Tensor]:
    from repro_torch.models.params import tree_leaves
    return [x for x in tree_leaves(params) if isinstance(x, torch.Tensor)]


def _weight_shapes(params) -> List[List[int]]:
    """Exact shapes that identify "a weight" in the traced programs: every
    >=2-d, >=WEIGHT_NUMEL_MIN-element params leaf (a DTensor by its global
    shape), plus the leading-dim slice of stacked (L, ...) leaves: one
    layer's weight.  Matching on full shape (not numel) keeps activations
    whose element count happens to collide with a weight's out of
    IR001/IR002."""
    out = set()
    for leaf in _leaves(params):
        if leaf.dim() >= 2 and leaf.numel() >= WEIGHT_NUMEL_MIN:
            shape = tuple(int(d) for d in leaf.shape)
            out.add(shape)
            if len(shape) >= 3:
                sliced = shape[1:]
                n = 1
                for d in sliced:
                    n *= d
                if n >= WEIGHT_NUMEL_MIN:
                    out.add(sliced)
    return sorted(list(s) for s in out)


def _params_bytes(params) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in _leaves(params))


def _extras(model, b: int, device) -> Dict[str, torch.Tensor]:
    """Zero-filled extra model inputs (image embeddings, audio frames)
    shaped as the engine pads them: the vlm / audio towers are part of the
    trace."""
    return {name: torch.zeros(spec.shape, dtype=spec.dtype, device=device)
            for name, spec in model.extra_inputs(b).items()}


def _prompts(n: int, length: int, vocab: int,
             salt: int = 0) -> List[List[int]]:
    return [[(3 * i + j + salt) % vocab for j in range(length)]
            for i in range(n)]


class TracedEngine(Engine):
    """The port's ``Engine`` with each decode step marked as one iteration
    of the serve loop (``step_stats.loop_body``), what the reference's
    fused while body is."""

    def _decode_step(self, *args):
        with loop_body():
            return super()._decode_step(*args)


@contextlib.contextmanager
def serving(eng):
    """What ``Engine.run`` enters around a drain."""
    from repro_torch.core.gemm_api import execution_context
    from repro_torch.distributed import ctx as dctx
    with torch.no_grad(), execution_context(hardware=eng.hardware), \
            dctx.on_mesh(eng.mesh, eng.rules):
        yield


def run_entry(entry: str, args, fn) -> EntrySummary:
    """Run ``fn()`` once under the counter (``args``: its argument trees,
    live from the start) -> its :class:`EntrySummary`."""
    t0 = time.time()
    with count_step(*args, program=True) as stats:
        fn()
    return summarize(entry, stats, time.time() - t0)


def _run_entry(entry: str, out: Dict[str, EntrySummary],
               errors: Dict[str, str], args, fn) -> None:
    """:func:`run_entry` into ``out[entry]``, or its failure into
    ``errors[entry]``."""
    try:
        out[entry] = run_entry(entry, args, fn)
    except Exception as e:
        errors[entry] = f"{type(e).__name__}: {e}"


def _trace_wave_entries(eng, out, errors) -> None:
    model, b = eng.model, eng.cfg.max_batch
    need = WAVE_WIDTH
    dev = eng.device
    tokens = torch.tensor(_prompts(b, PLEN, model.cfg.vocab_size),
                          dtype=torch.int32, device=dev)
    kv_start = torch.zeros((b,), dtype=torch.int32, device=dev)
    budget = torch.full((b,), need, dtype=torch.int32, device=dev)
    batch = {"tokens": tokens, "kv_start": kv_start,
             **_extras(model, b, dev)}
    got = {}
    with serving(eng):
        cache = eng._ensure_cache()
        _run_entry("prefill", out, errors, (eng.params, batch, cache),
                   lambda: got.update(zip(("logits0", "cache"),
                                          eng._prefill_wave(batch, cache))))
        if "logits0" not in got:
            errors["decode_loop"] = "RuntimeError: prefill failed"
            return
        _run_entry("decode_loop", out, errors,
                   (eng.params, got["cache"], got["logits0"]),
                   lambda: eng._decode_loop(got["logits0"], got["cache"],
                                            kv_start, budget, PLEN,
                                            WAVE_WIDTH, need))


def _trace_train_entry(model, mesh, out, errors) -> None:
    """The train step as the dry run traces it: state and batch on fake
    tensors, the state placed by the training (FSDP) rules on a mesh."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.dryrun import lower_cell
    t0 = time.time()
    try:
        shape = ShapeSpec("ir_train", 32, 8 if mesh is not None else 4,
                          "train")
        stats, _meta = lower_cell(model.cfg, shape, mesh, program=True)
        out["train_step"] = summarize("train_step", stats, time.time() - t0)
    except Exception as e:
        errors["train_step"] = f"{type(e).__name__}: {e}"


def trace_continuous(eng, admit: List[List[int]],
                     chunk: Optional[List[List[int]]] = None,
                     extras: Optional[Dict[str, torch.Tensor]] = None,
                     around=None):
    """One admission of the prompts ``admit`` (entry ``admit``) and one
    decode chunk (entry ``decode_chunk``), each run once under the counter
    on ``eng`` -> (summaries, errors).  The chunk decodes the admitted
    rows, or, given ``chunk``, the rows of those prompts, admitted
    untraced once the first ones are evicted.  Every request asks for one
    chunk of tokens; every row is evicted at the end.  ``around(entry)``,
    a context manager, wraps each traced entry (the card's launch
    counts)."""
    from repro_torch.serve import api
    around = around or (lambda _entry: contextlib.nullcontext())
    out: Dict[str, EntrySummary] = {}
    errors: Dict[str, str] = {}
    active: dict = {}

    def submit(prompts) -> None:
        for i, p in enumerate(prompts):
            eng.submit(api.Request(prompt=p, max_new_tokens=eng._chunk,
                                   row=i))

    def evict() -> None:
        for slot, req in list(active.items()):
            eng._csched.evict(eng._csched.rows[slot])
            eng._sched.evict(req)
            del active[slot]

    with serving(eng):
        eng._ensure_pool()
        try:
            submit(admit)
            with around("admit"):
                _run_entry("admit", out, errors,
                           (eng.params, eng._pools, eng._fixed, eng._cur),
                           lambda: eng._admit_batch(active, extras))
            if chunk is not None:
                evict()
                eng._queue.clear()
                submit(chunk)
                eng._admit_batch(active, extras)
            eng._csched.ensure_chunk_pages(eng._chunk)
            with around("decode_chunk"):
                _run_entry("decode_chunk", out, errors,
                           (eng.params, eng._pools, eng._fixed, eng._cur),
                           eng._run_chunk)
        finally:
            evict()
            eng._queue.clear()
    return out, errors


def _trace_continuous_entries(eng, out, errors) -> None:
    """One admission of ``max_batch`` prompts of ``PLEN`` tokens, then one
    decode chunk over ``max_batch`` rows of 8 tokens: width
    ``CHUNK_WIDTH`` at the default chunk of 8."""
    b, vocab = eng.cfg.max_batch, eng.model.cfg.vocab_size
    try:
        got, errs = trace_continuous(
            eng, _prompts(b, PLEN, vocab),
            _prompts(b, CHUNK_WIDTH - eng._chunk, vocab, salt=1),
            _extras(eng.model, b, eng.device) or None)
    except Exception as e:
        got, errs = {}, {"decode_chunk": f"{type(e).__name__}: {e}"}
    out.update(got)
    errors.update(errs)


def case_result(eng, case_id: str, entries: Dict[str, EntrySummary],
                errors: Dict[str, str], seconds: float) -> CaseResult:
    """The :class:`CaseResult` of entries traced on ``eng``: its weights,
    and the hardware profile it resolved (IR003's budget)."""
    return CaseResult(
        case_id=case_id, entries=entries,
        weight_shapes=_weight_shapes(eng.params),
        params_bytes=_params_bytes(eng.params), hardware=eng.hardware,
        torch_version=torch.__version__, errors=errors,
        seconds=round(seconds, 2))


def trace_case(case: IRCase, rules_override=None) -> CaseResult:
    """Trace every entry point of one case.

    ``rules_override`` installs explicit ambient sharding rules (through
    ``distributed.ctx.use_mesh``) instead of the engine's own inference-TP
    rules: how the seeded-regression test re-creates the bug IR001 exists
    for (``fsdp=True`` rules putting weight all-gathers inside the decode
    loop) without editing engine code.  A mesh case runs on a fake
    process group of its own, ended when the trace is done.
    """
    from repro_torch.configs.catalog import ARCHITECTURES
    from repro_torch.distributed import ctx as dctx
    from repro_torch.launch.mesh import end_fake_world, make_fake_mesh
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeConfig

    t0 = time.time()
    cfg = dataclasses.replace(ARCHITECTURES[case.family].reduced(),
                              dtype=case.dtype)
    model = build_model(cfg)
    mesh = make_fake_mesh(case.mesh_spec) if case.mesh_spec else None
    try:
        params = model.init(0, device="cpu")
        scope = (dctx.use_mesh(mesh, rules_override)
                 if rules_override is not None and mesh is not None
                 else contextlib.nullcontext())
        with scope:
            eng = TracedEngine(model, params, ServeConfig(
                scheduler=case.scheduler, device="cpu",
                mesh=None if rules_override is not None else mesh,
                **SERVE_KW))
        out: Dict[str, EntrySummary] = {}
        errors: Dict[str, str] = {}
        if case.scheduler == "wave":
            _trace_wave_entries(eng, out, errors)
            _trace_train_entry(model, mesh, out, errors)
        elif eng._scheduler != "continuous":
            errors["admit"] = (f"RuntimeError: engine forced scheduler "
                               f"{eng._scheduler!r} "
                               f"({eng._scheduler_forced})")
        else:
            _trace_continuous_entries(eng, out, errors)
        return case_result(eng, case.case_id, out, errors,
                           time.time() - t0)
    finally:
        if mesh is not None:
            end_fake_world()


# ---------------------------------------------------------------------------
# disk cache
# ---------------------------------------------------------------------------

def repo_root() -> str:
    # this file is src/repro_torch/analysis/ir/trace.py
    here = os.path.abspath(os.path.dirname(__file__))
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(here))))


def source_digest(root: Optional[str] = None) -> str:
    """Digest of every ``src/repro_torch/**/*.py``: the cache invalidation
    key.  Any source edit retraces everything; a docs edit retraces
    nothing."""
    root = root or repo_root()
    src = os.path.join(root, "src", "repro_torch")
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(src)):
        dirnames.sort()
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            h.update(os.path.relpath(path, src).encode())
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def default_cache_dir() -> str:
    return os.path.join(repo_root(), ".ir_cache")


def cache_key(case: IRCase, src_digest: str) -> str:
    raw = (f"torch-v{SUMMARY_SCHEMA_VERSION}:{src_digest}:"
           f"{torch.__version__}:{case.case_id}:{sorted(SERVE_KW.items())}")
    return hashlib.sha256(raw.encode()).hexdigest()[:32]


def traced_case_cached(case: IRCase, *, cache_dir: Optional[str] = None,
                       src_digest: Optional[str] = None,
                       use_cache: bool = True) -> CaseResult:
    """:func:`trace_case` behind the ``.ir_cache/`` summary cache."""
    cache_dir = cache_dir or default_cache_dir()
    src_digest = src_digest or source_digest()
    path = os.path.join(cache_dir, f"{cache_key(case, src_digest)}.json")
    if use_cache and os.path.exists(path):
        try:
            with open(path) as f:
                result = CaseResult.from_json(json.load(f))
            result.cached = True
            return result
        except Exception:
            pass                          # corrupt entry: retrace
    result = trace_case(case)
    if use_cache:
        os.makedirs(cache_dir, exist_ok=True)
        with open(path, "w") as f:
            json.dump(result.to_json(), f, indent=1, sort_keys=True)
    return result
