"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with ``nvcc`` into ``build/repro_torch_kernels/lib<name>_<hash>.so`` at the
repository root (``build/`` is git-ignored), then loaded with ``ctypes``.
The file name carries a hash of the source, of every ``csrc/*.cuh`` header
it includes and of the flags, so an edited source or header is rebuilt and
an unchanged one is loaded as it is.  No PyTorch
headers are involved, which keeps a build to tens of seconds.

``build_all()`` starts one ``nvcc`` per source at once and waits for all of
them; ``load(name)`` builds (if needed) and returns one library.  Nothing
here runs at import time: the CPU tests import every module of the package
on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_kernels"
SOURCES = ("gemm", "flash_attention")
#: ``-split-compile=0`` runs the optimiser and ptxas over a source's kernels
#: on every core: ``gemm.cu``'s unrolled f32 ``simt`` instantiations would
#: otherwise take most of a minute one after another
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-split-compile=0", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
#: per-source ptxas report (registers, shared memory, spills) of the last build
PTXAS_LOG: Dict[str, str] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH; "
                       "the CUDA kernels are built from source at first use")


def includes(name: str) -> List[str]:
    """The ``csrc/`` headers that ``csrc/<name>.cu`` includes by name."""
    src = (CSRC / f"{name}.cu").read_text()
    return sorted(set(re.findall(r'^#include "(\w+\.cuh)"', src, re.M)))


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in includes(name):
        h.update((CSRC / header).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source, or return None when its library exists."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True), tmp, out)


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    PTXAS_LOG[name] = log
    os.replace(tmp, out)


def build_all(names: List[str] = SOURCES) -> None:
    """Compile every named source in parallel (one nvcc each) and load them."""
    with _LOCK:
        todo = [n for n in names if n not in _LIBS]
        jobs = {n: _start(n) for n in todo}
        try:
            for n in todo:
                _finish(n, jobs[n])
        finally:
            for job in jobs.values():
                if job is not None and job[0].poll() is None:
                    job[0].kill()
                    job[0].wait()
        for n in todo:
            _LIBS[n] = ctypes.CDLL(str(_target(n)))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _LIBS[name]
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
