"""peft of the PyTorch port; see the JAX package's peft/ for the reference."""
