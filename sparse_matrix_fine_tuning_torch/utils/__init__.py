"""utils of the PyTorch port; see the JAX package's utils/ for the reference."""
