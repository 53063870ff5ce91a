"""PyTorch / CUDA port of the ``repro`` package for NVIDIA Hopper (H100).

The JAX package (``src/repro``) is the reference; this package imports
nothing from it and nothing of JAX.  Its two TPU kernels are CUDA C++ for
``sm_90a`` under ``kernels/csrc``, built at first use.  Entry points run on
the card unless the caller passes ``device="cpu"``, where the kernels'
plain PyTorch versions run instead.
"""
