"""Trace post-processing: ``torch.profiler`` Chrome trace -> PROFILE_*.json.

:func:`repro_torch.profiling.trace` writes each capture into a directory
of its own, ``<dir>/<capture>/<host>_<pid>.<ts>.pt.trace.json`` (the
profiler's ``tensorboard_trace_handler``; a gzipped one is read too).
Everything here parses that with the stdlib (json, gzip) and rolls time
up into the reference's op
families, on its schema (``PROFILE_SCHEMA_VERSION`` 1):

* **collective** — NCCL kernels;
* **gemm** — the port's GEMM kernels (``gemm_*_kernel``), cuBLAS and
  CUTLASS kernels (``nvjet``, ``xmma``, ``cutlass``, gemv); on the CPU,
  ``aten::mm`` / ``bmm`` / ``addmm`` and the like;
* **attention** — the flash kernels, softmax;
* **host_transfer** — host<->device copies (``Memcpy DtoH`` / ``HtoD``);
  the count of the device-to-host ones, the copies a host waits for, is
  ``host_syncs``;
* **other** — everything else (elementwise, copies on the device, ...).

**What counts as time.** On the card the device's own events (categories
``kernel``, ``gpu_memcpy`` and ``gpu_memset``) are the op universe, the
role the reference's ``hlo_op`` events play.  A trace that holds none and
no CUDA runtime event either (a capture on the CPU) counts each ``cpu_op``
by its self time, its duration less that of the ops it encloses, so
nothing is counted twice, as the reference drops its container ops.  The
blob's ``timeline`` says which: ``"device"`` or ``"host"``.

``annotate(...)`` markers (``serve.*`` / ``train.*``, the host-side
``user_annotation`` events) are collected apart: they partition wall time
where the families partition device time.  ``device_us_by_launching_op``
names the PyTorch op (``cpu_op``) each device event was launched under,
joined through the trace's ``External id``: it names what a step spends
outside the port's kernels.  An event launched under no op (the port's
own kernels outside autograd, launched through ctypes) is named by
itself, ``gemm_decode_kernel`` say.
"""
from __future__ import annotations

import glob
import gzip
import json
import os
import re
from typing import Dict, List, Optional, Sequence

#: op families of the breakdown, in render order
FAMILIES = ("collective", "gemm", "attention", "host_transfer", "other")

#: bump on any incompatible PROFILE_*.json layout change
PROFILE_SCHEMA_VERSION = 1

#: categories of the device's own events (on the card)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# host-side CUDA events: a trace that has them was taken with the card's
# activity on, so its time is the device events' even where there are none
_CUDA_HOST_CATEGORIES = ("cuda_runtime", "cuda_driver")

#: NCCL kernels on the card; on the CPU the c10d ops (DTensor's functional
#: collectives and their waits, gloo's)
_COLLECTIVE_RE = re.compile(
    r"nccl|c10d(_functional)?::|all_?reduce|all_?gather|reduce_?scatter|"
    r"all_?to_?all")
_ATTENTION_RE = re.compile(
    r"flash|fmha|softmax|attention|scaled_dot_product")
_GEMM_RE = re.compile(
    r"gemm|gemv|cublas|cutlass|nvjet|xmma|"
    r"^aten::(mm|bmm|addmm|baddbmm|addbmm|addmv|mv|dot|matmul|einsum|"
    r"linear|_scaled_mm)$")
_TRANSFER_RE = re.compile(r"^Memcpy (DtoH|HtoD)")
_SYNC_RE = re.compile(r"^Memcpy DtoH")
#: markers produced by repro_torch.profiling.annotate in the serve/train paths
_ANNOTATION_RE = re.compile(r"^(serve|train)\.[\w.]+$")
#: a capture's trace files
_TRACE_GLOBS = ("*.pt.trace.json.gz", "*.pt.trace.json")
TOP = 12


def classify_event_name(name: str) -> str:
    """Family of one kernel or op name (``host_transfer`` never comes from
    here: transfers are ``gpu_memcpy`` events, told apart by category)."""
    low = name.lower()
    if _COLLECTIVE_RE.search(low):
        return "collective"
    if _ATTENTION_RE.search(low):
        return "attention"
    if _GEMM_RE.search(low):
        return "gemm"
    return "other"


def base_op(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters (``void gemm_wgmma_kernel<128, 256, 4>(...)`` ->
    ``gemm_wgmma_kernel``), so its instantiations fold into one."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                 "")
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def capture_files(capture: str) -> List[str]:
    """The trace files of one capture directory."""
    return sorted(f for g in _TRACE_GLOBS
                  for f in glob.glob(os.path.join(capture, g)))


def find_capture_dirs(trace_dir: str) -> List[str]:
    """Capture directories under a trace dir (its subdirectories and the
    dir itself, each where it holds trace files), newest first."""
    cands = [trace_dir] + [d for d in glob.glob(os.path.join(trace_dir, "*"))
                           if os.path.isdir(d)]
    dirs = [d for d in cands if capture_files(d)]
    return sorted(dirs, key=lambda d: (os.path.getmtime(d), d), reverse=True)


def load_trace_events(trace_dir: str, capture: str = "latest") -> List[dict]:
    """Parse the Chrome-trace events of one capture (default: the newest).

    Raises ``FileNotFoundError`` when the directory holds no capture: "the
    profiler actually ran" is checked, not assumed.
    """
    captures = find_capture_dirs(trace_dir)
    if not captures:
        raise FileNotFoundError(
            f"no profiler capture under {trace_dir!r} (expected "
            "<capture>/*.pt.trace.json)")
    chosen = captures[0] if capture == "latest" else capture
    events: List[dict] = []
    for path in capture_files(chosen):
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as f:
            events.extend(json.load(f).get("traceEvents", []))
    return events


def _self_times(ops: Sequence[dict]):
    """(event, self us) of each ``cpu_op``: its duration less that of the
    ops it directly encloses on its thread."""
    out = []
    by_thread: Dict[tuple, list] = {}
    for ev in ops:
        by_thread.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
        stack: List[list] = []          # [event, end, self us]
        for ev in evs:
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            while stack and ts >= stack[-1][1]:
                out.append(tuple(stack.pop()[::2]))
            if stack:
                stack[-1][2] -= dur
            stack.append([ev, ts + dur, dur])
        out.extend(tuple(s[::2]) for s in stack)
    return out


def summarize_events(events: Sequence[dict]) -> Dict[str, object]:
    """Roll Chrome-trace events up into the breakdown core.

    Returns ``totals`` (op/family/wall microseconds), per-family
    us/count/fraction, ``top_ops`` (by time, instantiations folded),
    ``annotations`` (the ``serve.*`` / ``train.*`` markers),
    ``host_syncs``, ``device_us_by_launching_op`` (top 12) and
    ``timeline`` (``"device"`` or ``"host"``).
    """
    spans = [e for e in events
             if e.get("ph") == "X" and e.get("cat") != "Trace"]
    device = any(e.get("cat") in DEVICE_CATEGORIES + _CUDA_HOST_CATEGORIES
                 for e in spans)
    op_by_ext: Dict[object, str] = {}
    ann_us: Dict[str, float] = {}
    ann_n: Dict[str, int] = {}
    t_min, t_max = None, None
    for ev in spans:
        cat, name = ev.get("cat"), ev.get("name", "")
        args = ev.get("args") or {}
        ts, dur = ev.get("ts"), float(ev.get("dur", 0.0))
        if ts is not None:
            ts = float(ts)
            t_min = ts if t_min is None else min(t_min, ts)
            t_max = ts + dur if t_max is None else max(t_max, ts + dur)
        if cat == "cpu_op":
            op_by_ext[args.get("External id")] = name
        elif cat == "user_annotation" and _ANNOTATION_RE.match(name):
            ann_us[name] = ann_us.get(name, 0.0) + dur
            ann_n[name] = ann_n.get(name, 0) + 1
    if device:
        universe = [(e, float(e.get("dur", 0.0))) for e in spans
                    if e.get("cat") in DEVICE_CATEGORIES]
    else:
        universe = _self_times([e for e in spans if e.get("cat") == "cpu_op"])

    fam_us = {f: 0.0 for f in FAMILIES}
    fam_n = {f: 0 for f in FAMILIES}
    op_us: Dict[str, float] = {}
    op_n: Dict[str, int] = {}
    by_launcher: Dict[str, float] = {}
    syncs = 0
    for ev, us in universe:
        name = ev.get("name", "")
        args = ev.get("args") or {}
        if ev.get("cat") == "gpu_memcpy" and _TRANSFER_RE.match(name):
            fam = "host_transfer"
            syncs += bool(_SYNC_RE.match(name))
        else:
            fam = classify_event_name(name)
        fam_us[fam] += us
        fam_n[fam] += 1
        base = base_op(name)
        op_us[base] = op_us.get(base, 0.0) + us
        op_n[base] = op_n.get(base, 0) + 1
        launcher = (op_by_ext.get(args.get("External id"), base) if device
                    else name)
        by_launcher[launcher] = by_launcher.get(launcher, 0.0) + us
    total_us = sum(fam_us.values())
    families = {
        f: {"us": round(fam_us[f], 3), "count": fam_n[f],
            "fraction": round(fam_us[f] / total_us, 6) if total_us else 0.0}
        for f in FAMILIES}
    top = sorted(op_us, key=op_us.get, reverse=True)[:TOP]
    launchers = sorted(by_launcher, key=by_launcher.get, reverse=True)[:TOP]
    return {
        "totals": {
            "op_us": round(sum(fam_us[f] for f in FAMILIES
                               if f != "host_transfer"), 3),
            "family_us": round(total_us, 3),
            "wall_us": round((t_max - t_min), 3) if t_min is not None else 0.0,
        },
        "families": families,
        "top_ops": [{"name": o, "us": round(op_us[o], 3), "count": op_n[o]}
                    for o in top],
        "annotations": {a: {"us": round(ann_us[a], 3), "count": ann_n[a]}
                        for a in sorted(ann_us)},
        "host_syncs": syncs,
        "device_us_by_launching_op": {o: round(by_launcher[o], 3)
                                      for o in launchers},
        "timeline": "device" if device else "host",
    }


def build_profile(kind: str, *,
                  trace_dir: Optional[str] = None,
                  events: Optional[Sequence[dict]] = None,
                  hardware: Optional[str] = None,
                  mesh: Optional[str] = None,
                  roofline: Optional[dict] = None,
                  extra: Optional[dict] = None) -> Dict[str, object]:
    """Assemble the ``PROFILE_*.json`` blob from a trace dir or raw events."""
    if events is None:
        if trace_dir is None:
            raise ValueError("build_profile needs trace_dir or events")
        events = load_trace_events(trace_dir)
    blob: Dict[str, object] = {
        "schema_version": PROFILE_SCHEMA_VERSION,
        "kind": kind,
        "hardware": hardware,
        "mesh": mesh,
    }
    blob.update(summarize_events(events))
    if roofline is not None:
        blob["roofline"] = roofline
    if extra:
        blob.update(extra)
    return blob


def validate_profile(blob: dict) -> dict:
    """Schema check for PROFILE_*.json.

    Raises ``ValueError`` listing every violation; returns the blob so the
    call nests in expressions.  "Valid" = versioned, kind-tagged, all op
    families present with consistent numbers, and *nonzero* totals: a
    trace that captured nothing fails here rather than passing empty.
    """
    problems: List[str] = []
    if blob.get("schema_version") != PROFILE_SCHEMA_VERSION:
        problems.append(
            f"schema_version {blob.get('schema_version')!r} != "
            f"{PROFILE_SCHEMA_VERSION}")
    if not isinstance(blob.get("kind"), str) or not blob.get("kind"):
        problems.append("missing kind")
    fams = blob.get("families")
    if not isinstance(fams, dict):
        problems.append("missing families")
    else:
        for f in FAMILIES:
            entry = fams.get(f)
            if not isinstance(entry, dict):
                problems.append(f"families[{f!r}] missing")
                continue
            for field in ("us", "count", "fraction"):
                v = entry.get(field)
                if not isinstance(v, (int, float)) or v < 0:
                    problems.append(f"families[{f!r}].{field} bad: {v!r}")
    totals = blob.get("totals")
    if not isinstance(totals, dict):
        problems.append("missing totals")
    else:
        for field in ("op_us", "wall_us"):
            v = totals.get(field)
            if not isinstance(v, (int, float)):
                problems.append(f"totals.{field} bad: {v!r}")
            elif v <= 0:
                problems.append(f"totals.{field} must be > 0, got {v!r}")
    hs = blob.get("host_syncs")
    if not isinstance(hs, int) or hs < 0:
        problems.append(f"host_syncs bad: {hs!r}")
    if not isinstance(blob.get("annotations"), dict):
        problems.append("missing annotations")
    if not isinstance(blob.get("top_ops"), list):
        problems.append("missing top_ops")
    if problems:
        raise ValueError("invalid PROFILE blob: " + "; ".join(problems))
    return blob
