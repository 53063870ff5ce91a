"""Python wrapper of the CUDA flash-attention kernel
(``csrc/flash_attention.cu``) and the GQA front end.

``flash_attention`` runs the plain version (``ref.flash_attention_ref``) for
CPU tensors and the kernel for CUDA tensors; a build or launch failure
raises and never falls back.  ``flash_attention_cuda.launches`` counts
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,        # q, k, v
     ctypes.c_void_p, ctypes.c_void_p,                         # kv_start, o
     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # batch strides
     ctypes.c_int, ctypes.c_int, ctypes.c_int,                 # B, S, Skv
     ctypes.c_int, ctypes.c_int, ctypes.c_int,                 # H, KVH, D
     ctypes.c_float, ctypes.c_int, ctypes.c_int,               # scale, causal, is_f32
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p])             # bq, bk, stream


def _lib():
    lib = _build.load("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = _ARGTYPES
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _inner_contiguous(x: torch.Tensor) -> torch.Tensor:
    """Unit-stride (S, H, d) inside each batch row; the batch stride is free."""
    _, s, h, d = x.shape
    if x.stride(3) == 1 and x.stride(2) == d and (s == 1 or x.stride(1) == h * d):
        return x
    return x.contiguous()


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         bq: int, bk: int, causal: bool = True,
                         kv_start: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention on the card: q (B, S, H, d); k, v (B, S_kv, KV, d)."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention_cuda: bad shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention_cuda takes CUDA tensors")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention_cuda: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; expected one of bfloat16 / float32")
    b, sq, h, d = q.shape
    _, skv, kvh, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or h % kvh:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)} vs kv "
                         f"{tuple(k.shape)}")
    q, k, v = _inner_contiguous(q), _inner_contiguous(k), _inner_contiguous(v)
    if kv_start is not None:
        kv_start = kv_start.to(device=q.device, dtype=torch.int32).contiguous()
        if tuple(kv_start.shape) != (b,):
            raise ValueError(f"kv_start shape {tuple(kv_start.shape)} != {(b,)}")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, sq, h, d), device=q.device, dtype=q.dtype)
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_start.data_ptr() if kv_start is not None else None, out.data_ptr(),
        q.stride(0), k.stride(0), v.stride(0), b, sq, skv, h, kvh, d,
        float(scale), int(causal), int(q.dtype == torch.float32), bq, bk,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err == -1:
        raise ValueError(f"flash_attention_cuda: blocks ({bq}, {bk}) with "
                         f"head dim {d} have no kernel instantiation")
    if err != 0:
        raise RuntimeError(
            "flash_attention_cuda launch failed: "
            f"{lib.flash_attention_error_string(err).decode()}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0


def flash_attention(q, k, v, *, bq: int, bk: int, causal: bool = True,
                    kv_start: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """GQA front end: q (B, S, H, d); k, v (B, S_kv, KV, d) -> (B, S, H, d).

    CUDA tensors launch the kernel; CPU tensors run the plain version.
    """
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, bq=bq, bk=bk, causal=causal,
                                    kv_start=kv_start, scale=scale)
    return flash_attention_ref(q, k, v, causal=causal, kv_start=kv_start,
                               scale=scale)
