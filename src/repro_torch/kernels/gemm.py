"""Python wrapper of the CUDA GEMM kernels (``csrc/gemm.cu``).

``gemm_cuda`` checks its operands, allocates the output, and launches the
kernel its ``TileConfig`` names on PyTorch's current stream through the
``ctypes`` binding (a split-K ``decode`` launch sums its partials in a
per-stream f32 workspace).  It takes CUDA tensors only: a build or launch failure raises, and
nothing falls back to the plain version (``ref.gemm_ref``), which
``ops.gemm`` runs for CPU tensors.

One decision is the wrapper's, taken from the strides before the launch:
bf16 operands that the ``decode`` (cp.async) and ``wgmma`` (TMA) kernels
cannot take -- a base address or row stride that is not a multiple of 16
bytes -- go to the ``wmma`` kernel with the table's tile for them.

``gemm_cuda.launches_by_path`` counts launches by kernel; their sum is the
GEMM's launch count.  ``instantiated_schedules`` reads the schedules
``csrc/gemm.cu`` instantiates from its source text.
"""
from __future__ import annotations

import ctypes
import functools
import re
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ACTIVATION_CODES

#: gemm_launch_packed's argument array: gemm_launch's arguments but alpha
#: and beta, in gemm_launch's order, as 64-bit integers (pointers as
#: addresses, absent ones as 0); alpha and beta follow as floats.
_PACKED = ("A", "lda", "B", "sbk", "sbn", "C", "ldc", "bias", "D", "ldd",
           "M", "N", "K", "act", "in_f32", "out_f32", "b_kmajor",
           "bm", "bk", "bn", "kernel", "stages", "k_chunk", "group_m",
           "workspace", "counters", "stream")
_TLS = threading.local()

_SUPPORTED = (torch.bfloat16, torch.float32)
#: TileConfig.kernel -> the C side's kernel code
KERNEL_CODES = {"wmma": 0, "fma": 1, "decode": 2, "wgmma": 3}
#: largest M the decode kernel takes (two 8-token MMA fragments)
DECODE_MAX_M = 16

#: per (device, stream): the split-K workspace and zeroed counters, grown on
#: demand.  Launches on one stream run one after another, so they can share
#: them: the last block of each column tile has summed the partials and set
#: its counter back to 0 before the next launch starts.
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _lib():
    lib = _build.load("gemm")
    if lib.gemm_launch_packed.argtypes is None:
        lib.gemm_launch_packed.argtypes = [ctypes.c_void_p, ctypes.c_float,
                                           ctypes.c_float]
        lib.gemm_launch_packed.restype = ctypes.c_int
        lib.gemm_error_string.argtypes = [ctypes.c_int]
        lib.gemm_error_string.restype = ctypes.c_char_p
    return lib


def _packed():
    """This thread's argument array for gemm_launch_packed, and its address."""
    buf = getattr(_TLS, "buf", None)
    if buf is None:
        arr = (ctypes.c_longlong * len(_PACKED))()
        buf = _TLS.buf = (arr, ctypes.addressof(arr))
    return buf


def _scratch(device: torch.device, stream: int, ws_floats: int,
             col_tiles: int) -> Tuple[int, int]:
    """Pointers to a workspace of at least ``ws_floats`` f32 and to at
    least ``col_tiles`` zeroed int32 counters for ``stream``."""
    key = (device.index or 0, stream)
    ws, counters = _SCRATCH.get(key, (None, None))
    if ws is None or ws.numel() < ws_floats:
        ws = torch.empty(max(ws_floats, 1 << 20), dtype=torch.float32,
                         device=device)
    if counters is None or counters.numel() < col_tiles:
        counters = torch.zeros(max(col_tiles, 4096), dtype=torch.int32,
                               device=device)
    _SCRATCH[key] = (ws, counters)
    return ws.data_ptr(), counters.data_ptr()


@functools.lru_cache(maxsize=1024)
def _decode_split(config, k: int) -> Tuple[int, int]:
    """(K elements per split, number of splits) of a decode launch."""
    chunk = config.k_chunk(k)
    return chunk, -(-k // chunk)


def _aligned(kernel: str, a_ptr: int, lda: int, b_ptr: int, sbk: int,
             sbn: int, b_kmajor: int, k: int, n: int) -> bool:
    """Whether ``decode`` (16-byte cp.async) or ``wgmma`` (TMA) can take the
    operands: 16-byte aligned bases, row strides of a multiple of 8 bf16 no
    shorter than a row, K a multiple of 8 (and N, for row-major B in
    ``decode``, whose 16-byte chunks run along N)."""
    if k == 0 or k % 8 or (a_ptr | b_ptr) % 16 or lda % 8 or lda < k:
        return False
    if b_kmajor:
        return sbn % 8 == 0 and sbn >= k
    if kernel == "decode" and n % 8:
        return False
    return sbk % 8 == 0 and sbk >= n


def gemm_cuda(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None,
              *, config, alpha: float = 1.0, beta: float = 0.0,
              bias: Optional[torch.Tensor] = None,
              activation: Optional[str] = None,
              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``act(alpha * a @ b + beta * c + bias)`` on the card.

    a: (M, K) with unit stride over K (made so if it is not).  b: (K, N)
    read through its strides when either is 1, e.g. ``embedding.t()``.
    ``config`` is a ``TileConfig`` from the port's tile table.  ``c`` and
    ``bias`` are applied in f32 inside the kernel's epilogue.
    """
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm_cuda: bad operands {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if not (a.is_cuda and b.is_cuda):
        raise ValueError("gemm_cuda takes CUDA tensors")
    if a.dtype != b.dtype or a.dtype not in _SUPPORTED:
        raise TypeError(f"gemm_cuda: operands must share one of {_SUPPORTED}, "
                        f"got {a.dtype} and {b.dtype}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in _SUPPORTED:
        raise TypeError(f"gemm_cuda: unsupported out_dtype {out_dtype}")
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"unknown activation {activation!r}")
    m, k = a.shape
    n = b.shape[1]
    if a.stride(1) != 1:
        a = a.contiguous()
    sbk, sbn = b.stride()
    if sbn == 1 and n > 1:
        b_kmajor = 0
    elif sbk == 1:
        b_kmajor = 1
    else:
        b = b.contiguous()
        sbk, sbn = b.stride()
        b_kmajor = 0
    a_ptr, lda, b_ptr = a.data_ptr(), a.stride(0), b.data_ptr()
    kernel = config.kernel
    if (a.dtype == torch.float32) != (kernel == "fma"):
        raise ValueError(f"gemm_cuda: schedule {config.schedule} does not "
                         f"take {a.dtype} operands")
    if kernel == "decode" and m > DECODE_MAX_M:
        raise ValueError(f"gemm_cuda: the decode kernel takes M <= "
                         f"{DECODE_MAX_M}, got {m}")
    if kernel in ("decode", "wgmma") and not _aligned(
            kernel, a_ptr, lda, b_ptr, sbk, sbn, b_kmajor, k, n):
        from repro_torch.core.tile_config import gemm_tiles
        config = gemm_tiles(a.dtype, m, k, n, aligned=False)
        kernel = config.kernel
    c_ptr = bias_ptr = 0
    if c is not None:
        if tuple(c.shape) != (m, n):
            raise ValueError(f"gemm_cuda: C shape {tuple(c.shape)} != {(m, n)}")
        c = c.to(device=a.device, dtype=torch.float32).contiguous()
        c_ptr = c.data_ptr()
    if bias is not None:
        if tuple(bias.shape) != (n,):
            raise ValueError(f"gemm_cuda: bias shape {tuple(bias.shape)} != {(n,)}")
        bias = bias.to(device=a.device, dtype=torch.float32).contiguous()
        bias_ptr = bias.data_ptr()
    out = torch.empty((m, n), device=a.device, dtype=out_dtype)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    k_chunk, ws, counters = 0, 0, 0
    if kernel == "decode":
        k_chunk, splits = _decode_split(config, k)
        if splits > 1:
            ws, counters = _scratch(a.device, stream, splits * m * n,
                                    -(-n // config.bn))
    lib = _lib()
    buf, addr = _packed()
    buf[:] = (a_ptr, lda, b_ptr, sbk, sbn, c_ptr, n, bias_ptr, out.data_ptr(),
              n, m, n, k, ACTIVATION_CODES[activation],
              a.dtype == torch.float32, out_dtype == torch.float32, b_kmajor,
              config.bm, config.bk, config.bn, KERNEL_CODES[kernel],
              config.stages, k_chunk, config.group_m, ws, counters,
              stream or 0)
    err = lib.gemm_launch_packed(addr, alpha, beta)
    if err == -1:
        raise ValueError(f"gemm_cuda: schedule {config.schedule} has no kernel "
                         f"instantiation for {a.dtype}")
    if err != 0:
        raise RuntimeError(f"gemm_cuda launch failed ({config.schedule}): "
                           f"{lib.gemm_error_string(err).decode()}")
    gemm_cuda.launches_by_path[kernel] += 1
    return out


gemm_cuda.launches_by_path = dict.fromkeys(KERNEL_CODES, 0)


def instantiated_schedules() -> Dict[str, set]:
    """``{kernel: {(bm, bk, bn, stages)}}`` read from the ``dispatch_<kernel>``
    functions of ``csrc/gemm.cu`` (stages 1 where the kernel has no ring):
    the schedules a ``TileConfig`` may name."""
    src = (Path(__file__).parent / "csrc" / "gemm.cu").read_text()
    found = {}
    for kernel, body in re.findall(
            r"int dispatch_(\w+)\(const Args& a[^)]*\) \{(.*?)\n\}", src, re.S):
        found[kernel] = {
            (int(bm), int(bk), int(bn), int(st or 1)) for bm, bk, bn, st in
            re.findall(r"bm == (\d+) && bk == (\d+) && bn == (\d+)"
                       r"(?: && stages == (\d+))?\)", body)}
    return found
