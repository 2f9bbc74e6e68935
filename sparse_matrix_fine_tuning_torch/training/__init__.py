"""training of the PyTorch port; see the JAX package's training/ for the reference."""
