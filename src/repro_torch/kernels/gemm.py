"""Python wrapper of the CUDA GEMM kernel (``csrc/gemm.cu``).

``gemm_cuda`` checks its operands, allocates the output, and launches the
kernel on PyTorch's current stream through the ``ctypes`` binding.  It takes
CUDA tensors only: a build or launch failure raises, and nothing falls back
to the plain version (``ref.gemm_ref``), which ``ops.gemm`` runs for CPU
tensors.  ``gemm_cuda.launches`` counts launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ACTIVATION_CODES

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong,                      # A, lda
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,   # B, sbk, sbn
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,     # C, ldc, bias
     ctypes.c_void_p, ctypes.c_longlong,                      # D, ldd
     ctypes.c_int, ctypes.c_int, ctypes.c_int,                # M, N, K
     ctypes.c_float, ctypes.c_float, ctypes.c_int,            # alpha, beta, act
     ctypes.c_int, ctypes.c_int, ctypes.c_int,                # in_f32, out_f32, b_kmajor
     ctypes.c_int, ctypes.c_int, ctypes.c_int,                # bm, bk, bn
     ctypes.c_void_p])                                        # stream

_SUPPORTED = (torch.bfloat16, torch.float32)


def _lib():
    lib = _build.load("gemm")
    if lib.gemm_launch.argtypes is None:
        lib.gemm_launch.argtypes = _ARGTYPES
        lib.gemm_launch.restype = ctypes.c_int
        lib.gemm_error_string.argtypes = [ctypes.c_int]
        lib.gemm_error_string.restype = ctypes.c_char_p
    return lib


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
    if b.stride(1) == 1 and n > 1:
        b_kmajor = 0
    elif b.stride(0) == 1:
        b_kmajor = 1
    else:
        b = b.contiguous()
        b_kmajor = 0
    if c is not None:
        if tuple(c.shape) != (m, n):
            raise ValueError(f"gemm_cuda: C shape {tuple(c.shape)} != {(m, n)}")
        c = c.to(device=a.device, dtype=torch.float32).contiguous()
    if bias is not None:
        if tuple(bias.shape) != (n,):
            raise ValueError(f"gemm_cuda: bias shape {tuple(bias.shape)} != {(n,)}")
        bias = bias.to(device=a.device, dtype=torch.float32).contiguous()
    out = torch.empty((m, n), device=a.device, dtype=out_dtype)
    lib = _lib()
    err = lib.gemm_launch(
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), b.stride(1),
        c.data_ptr() if c is not None else None, n,
        bias.data_ptr() if bias is not None else None,
        out.data_ptr(), n, m, n, k, float(alpha), float(beta),
        ACTIVATION_CODES[activation], int(a.dtype == torch.float32),
        int(out_dtype == torch.float32), b_kmajor,
        config.bm, config.bk, config.bn,
        torch.cuda.current_stream(a.device).cuda_stream)
    if err == -1:
        raise ValueError(f"gemm_cuda: tile {config.label} has no kernel "
                         f"instantiation for {a.dtype}")
    if err != 0:
        raise RuntimeError(f"gemm_cuda launch failed: "
                           f"{lib.gemm_error_string(err).decode()}")
    gemm_cuda.launches += 1
    return out


gemm_cuda.launches = 0
