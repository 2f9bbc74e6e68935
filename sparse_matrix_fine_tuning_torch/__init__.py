"""PyTorch and CUDA port of ``sparse_matrix_fine_tuning_tpu`` for NVIDIA
Hopper (H100).

The JAX package stays the reference; each module here has a counterpart of
the same name there and is held against it by ``tests/test_torch_*.py``.
This package imports ``torch`` and never JAX.  Its CUDA kernels are built
from ``kernels/csrc/`` at their first use, never at import.
"""
