"""models of the PyTorch port; see the JAX package's models/ for the reference."""
