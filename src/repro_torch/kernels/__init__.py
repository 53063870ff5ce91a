"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions.

Each wrapper counts its launches where it launches its kernel: the flash
wrapper in a plain integer attribute, the GEMM's by kernel (``decode``,
``wgmma``, ``wmma``, ``fma``).  ``launch_counts`` reads them (the GEMM's
summed), ``gemm_launches_by_path`` reads the GEMM's by kernel, and
``reset_launch_counts`` sets them all to 0.
"""
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.gemm import gemm_cuda


def launch_counts() -> dict:
    return {"gemm": sum(gemm_cuda.launches_by_path.values()),
            "flash_attention": flash_attention_cuda.launches}


def gemm_launches_by_path() -> dict:
    return dict(gemm_cuda.launches_by_path)


def reset_launch_counts() -> None:
    flash_attention_cuda.launches = 0
    for path in gemm_cuda.launches_by_path:
        gemm_cuda.launches_by_path[path] = 0
