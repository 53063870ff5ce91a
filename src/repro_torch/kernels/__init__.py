"""Hand-written CUDA kernels (``csrc/``), their wrappers and plain versions.

Each wrapper counts its launches in a plain integer attribute;
``launch_counts`` reads them and ``reset_launch_counts`` sets them to 0.
"""
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.gemm import gemm_cuda

_WRAPPERS = {"gemm": gemm_cuda, "flash_attention": flash_attention_cuda}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
