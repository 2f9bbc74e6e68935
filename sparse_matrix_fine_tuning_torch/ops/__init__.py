"""ops of the PyTorch port; see the JAX package's ops/ for the reference."""
