"""The ``gemm`` front end over the CUDA kernel and its plain version.

The device of the operands picks the path: CUDA tensors go to the kernel
(``gemm.gemm_cuda``, tiles from ``config``), CPU tensors to
``ref.gemm_ref``.  Ragged edges are masked inside the kernel, so nothing is
padded here.  Batching over leading dims is ``core.gemm_api.matmul``'s job.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels.gemm import gemm_cuda


def gemm(a: torch.Tensor, b: torch.Tensor, c: Optional[torch.Tensor] = None, *,
         config=None, alpha: float = 1.0, beta: float = 0.0,
         bias: Optional[torch.Tensor] = None, activation: Optional[str] = None,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """2-D ``act(alpha * a @ b + beta * c + bias)``, f32 accumulation.

    ``config`` (a ``core.tile_config.TileConfig``) is required for CUDA
    tensors and ignored on the CPU, where the plain version has no tiles.
    """
    if a.is_cuda:
        if config is None:
            raise ValueError("gemm on CUDA tensors needs a TileConfig "
                             "(core.tile_config.gemm_tiles)")
        return gemm_cuda(a, b, c, config=config, alpha=alpha, beta=beta,
                         bias=bias, activation=activation, out_dtype=out_dtype)
    return _ref.gemm_ref(a, b, c, alpha=alpha, beta=beta, bias=bias,
                         activation=activation, out_dtype=out_dtype)
