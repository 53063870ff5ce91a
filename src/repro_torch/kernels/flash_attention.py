"""Python wrapper of the CUDA flash-attention kernels
(``csrc/flash_attention.cu``) and the GQA front end.

``flash_attention`` runs the plain version (``ref.flash_attention_ref``) for
CPU tensors and a kernel for CUDA tensors; a build or launch failure raises
and never falls back.

One decision is the wrapper's, taken from the operands before the launch:
a ``wgmma`` schedule runs only on operands that kernel takes
(``wgmma_takes``); others run the ``fma`` kernel with the table's float32
schedule.  ``flash_attention_cuda.launches_by_path`` counts launches by
kernel.  ``instantiated_schedules`` reads the schedules the source
instantiates from its text.
"""
from __future__ import annotations

import ctypes
import re
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

#: FlashAttentionConfig.kernel -> the C side's kernel code
KERNEL_CODES = {"fma": 0, "wgmma": 1}
#: query rows of one consumer warpgroup of the wgmma kernel: H / KV divides it
WGMMA_GROUP_ROWS = 64

_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,        # q, k, v
     ctypes.c_void_p, ctypes.c_void_p,                         # kv_start, o
     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,  # batch strides
     ctypes.c_int, ctypes.c_int, ctypes.c_int,                 # B, S, Skv
     ctypes.c_int, ctypes.c_int, ctypes.c_int,                 # H, KVH, D
     ctypes.c_float, ctypes.c_int, ctypes.c_int,               # scale, causal, is_f32
     ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,   # kernel, bq, bk, stages
     ctypes.c_void_p])                                         # stream


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


def _batch_stride(x: torch.Tensor) -> int:
    """The batch stride in elements (the packed one when there is one row)."""
    _, s, h, d = x.shape
    return x.stride(0) if x.shape[0] > 1 else s * h * d


def wgmma_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float) -> bool:
    """Whether the ``wgmma`` kernel takes these (inner-contiguous) operands:
    bf16, head dim 64 or 128, H / KV dividing a warpgroup's 64 rows, a
    positive scale, and 16-byte aligned bases and batch strides (TMA)."""
    _, _, h, d = q.shape
    kvh = k.shape[2]
    if q.dtype != torch.bfloat16 or d not in (64, 128) or scale <= 0:
        return False
    if h % kvh or WGMMA_GROUP_ROWS % (h // kvh):
        return False
    return all(x.data_ptr() % 16 == 0 and _batch_stride(x) % 8 == 0
               for x in (q, k, v))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         config, causal: bool = True,
                         kv_start: Optional[torch.Tensor] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention on the card: q (B, S, H, d); k, v (B, S_kv, KV, d).

    ``config`` is a ``FlashAttentionConfig`` from the port's tile table.
    """
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
    if config.kernel not in KERNEL_CODES:
        raise ValueError(f"flash_attention_cuda: unknown kernel {config.kernel!r}")
    if q.dtype == torch.float32 and config.kernel == "wgmma":
        raise ValueError(f"flash_attention_cuda: schedule {config.schedule} "
                         f"does not take float32 operands")
    q, k, v = _inner_contiguous(q), _inner_contiguous(k), _inner_contiguous(v)
    if kv_start is not None:
        kv_start = kv_start.to(device=q.device, dtype=torch.int32).contiguous()
        if tuple(kv_start.shape) != (b,):
            raise ValueError(f"kv_start shape {tuple(kv_start.shape)} != {(b,)}")
    scale = d ** -0.5 if scale is None else scale
    if config.kernel == "wgmma" and not wgmma_takes(q, k, v, scale):
        from repro_torch.core.tile_config import flash_tiles
        config = flash_tiles(torch.float32, sq, skv, d)
    out = torch.empty((b, sq, h, d), device=q.device, dtype=q.dtype)
    lib = _lib()
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_start.data_ptr() if kv_start is not None else None, out.data_ptr(),
        _batch_stride(q), _batch_stride(k), _batch_stride(v), b, sq, skv, h,
        kvh, d, float(scale), int(causal), int(q.dtype == torch.float32),
        KERNEL_CODES[config.kernel], config.bq, config.bk, config.stages,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err == -1:
        raise ValueError(f"flash_attention_cuda: schedule {config.schedule} "
                         f"with head dim {d} has no kernel instantiation")
    if err != 0:
        raise RuntimeError(
            f"flash_attention_cuda launch failed ({config.schedule}): "
            f"{lib.flash_attention_error_string(err).decode()}")
    flash_attention_cuda.launches_by_path[config.kernel] += 1
    return out


flash_attention_cuda.launches_by_path = dict.fromkeys(KERNEL_CODES, 0)


def instantiated_schedules() -> Dict[str, set]:
    """``{kernel: {(bq, bk, stages)}}`` read from the ``dispatch_<kernel>``
    functions of ``csrc/flash_attention.cu`` (stages 1 where the kernel has
    no ring): the schedules a ``FlashAttentionConfig`` may name."""
    src = (Path(__file__).parent / "csrc" / "flash_attention.cu").read_text()
    found = {}
    for kernel, body in re.findall(
            r"int dispatch_(\w+)\(const Args& a[^)]*\) \{(.*?)\n\}", src, re.S):
        found[kernel] = {
            (int(bq), int(bk), int(st or 1)) for bq, bk, st in re.findall(
                r"bq == (\d+) && bk == (\d+)(?: && stages == (\d+))?\)", body)}
    return found


def flash_attention(q, k, v, *, config, causal: bool = True,
                    kv_start: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """GQA front end: q (B, S, H, d); k, v (B, S_kv, KV, d) -> (B, S, H, d).

    CUDA tensors launch the kernel ``config`` names (or, for operands the
    ``wgmma`` kernel does not take, ``fma``); CPU tensors run the plain
    version.
    """
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, config=config, causal=causal,
                                    kv_start=kv_start, scale=scale)
    return flash_attention_ref(q, k, v, causal=causal, kv_start=kv_start,
                               scale=scale)
