"""Scripts of the port that run on the card, as ``python -m
sparse_matrix_fine_tuning_torch.scripts.<name>``."""
