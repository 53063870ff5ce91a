"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions.

Each wrapper counts its launches by kernel where it launches it: the GEMM's
(``decode``, ``wgmma``, ``wmma``, ``fma``) and the flash attention's
(``wgmma``, ``fma``).  ``launch_counts`` reads each wrapper's sum,
``gemm_launches_by_path`` and ``flash_launches_by_path`` read them by
kernel, and ``reset_launch_counts`` sets them all to 0.
"""
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.gemm import gemm_cuda


def launch_counts() -> dict:
    return {"gemm": sum(gemm_cuda.launches_by_path.values()),
            "flash_attention": sum(flash_attention_cuda.launches_by_path.values())}


def gemm_launches_by_path() -> dict:
    return dict(gemm_cuda.launches_by_path)


def flash_launches_by_path() -> dict:
    return dict(flash_attention_cuda.launches_by_path)


def reset_launch_counts() -> None:
    for counts in (gemm_cuda.launches_by_path,
                   flash_attention_cuda.launches_by_path):
        for path in counts:
            counts[path] = 0
