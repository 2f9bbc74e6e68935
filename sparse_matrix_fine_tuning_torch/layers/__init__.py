"""layers of the PyTorch port; see the JAX package's layers/ for the reference."""
