"""kernels of the PyTorch port; see the JAX package's kernels/ for the reference."""
