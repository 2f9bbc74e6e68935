"""ops of the PyTorch port; see the JAX package's ops/ for the reference.

The names the JAX ``ops/__init__.py`` exports, from the port's modules of
the same names; ``ops/butterfly.py`` is imported as a module, as there."""

from sparse_matrix_fine_tuning_torch.ops.blockdiag import (
    blockdiag_multiply,
    blockdiag_weight_to_dense_weight,
)
from sparse_matrix_fine_tuning_torch.ops.monarch import (
    blockdiag_butterfly_multiply,
    blockdiag_butterfly_multiply_reference,
    monarch_dense_equivalent,
)
from sparse_matrix_fine_tuning_torch.ops.projection import (
    blockdiag_butterfly_project,
    blockdiag_butterfly_project_einsum_rank,
    blockdiag_butterfly_project_einsum_simple,
    butterfly_fft_factors,
    low_rank_project,
)

__all__ = [
    "blockdiag_multiply",
    "blockdiag_weight_to_dense_weight",
    "blockdiag_butterfly_multiply",
    "blockdiag_butterfly_multiply_reference",
    "monarch_dense_equivalent",
    "blockdiag_butterfly_project",
    "blockdiag_butterfly_project_einsum_rank",
    "blockdiag_butterfly_project_einsum_simple",
    "butterfly_fft_factors",
    "low_rank_project",
]
