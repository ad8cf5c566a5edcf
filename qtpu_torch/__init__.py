"""qtpu_torch — the PyTorch/CUDA port of ``qtpu`` for one NVIDIA H100.

The JAX package ``qtpu`` stays the numerical reference.  This package mirrors
its layout (``ops/``, ``serve/``, ``models/``, ``nn/``, ``calib/``,
``transform/``, ``utils/``) with the same function names and the same public
layouts (NHWC activations, HWIO weights, qtpu's frozen-tree leaf names), so a
reader can find each counterpart.  It imports torch, numpy and the standard
library only.

The int8 GEMM and conv kernels are hand-written CUDA C++ for ``sm_90a``
(``qtpu_torch/csrc``), built with ``nvcc`` at first use.  Every kernel has a
plain PyTorch version beside it, taken only for tensors on the CPU.
"""
