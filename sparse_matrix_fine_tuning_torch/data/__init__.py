"""data of the PyTorch port; see the JAX package's data/ for the reference.

The modules here are numpy-only copies of the JAX package's (the port never
imports that package); ``tests/test_torch_alpaca_data.py`` holds each copy's
arrays against the original bit for bit.
"""

from sparse_matrix_fine_tuning_torch.data.tokenizer import SimpleTokenizer, get_tokenizer

__all__ = ["SimpleTokenizer", "get_tokenizer"]
