"""layers of the PyTorch port; see the JAX package's layers/ for the reference."""

from sparse_matrix_fine_tuning_torch.layers.blocksparse import (
    BlockSparseLinear,
    FlatBlockButterflySparsityConfig,
)
from sparse_matrix_fine_tuning_torch.layers.monarch_linear import (
    DEFAULT_PEFT_CONFIG,
    MonarchFactor,
    MonarchLinear,
    Scaler,
)
from sparse_matrix_fine_tuning_torch.layers.spectral import SpectralConv1d, SpectralConv2d
from sparse_matrix_fine_tuning_torch.layers.structured import (
    BlockdiagLinear,
    ButterflyFFT,
    ButterflyFFT2,
)

__all__ = [
    "DEFAULT_PEFT_CONFIG",
    "MonarchFactor",
    "MonarchLinear",
    "Scaler",
    "BlockdiagLinear",
    "ButterflyFFT",
    "ButterflyFFT2",
    "BlockSparseLinear",
    "FlatBlockButterflySparsityConfig",
    "SpectralConv1d",
    "SpectralConv2d",
]
