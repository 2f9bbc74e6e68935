"""Data, FSDP and tensor parallelism of the port (``torch.distributed``,
FSDP2 and DTensor): the counterpart of ``sparse_matrix_fine_tuning_tpu/
parallel/``."""

from sparse_matrix_fine_tuning_torch.parallel import multihost
from sparse_matrix_fine_tuning_torch.parallel.annotate import (
    activation_mesh,
    get_activation_mesh,
    set_activation_mesh,
    shard_tokens,
)
from sparse_matrix_fine_tuning_torch.parallel.mesh import make_mesh
from sparse_matrix_fine_tuning_torch.parallel.sharding import param_spec, shard_model

__all__ = ["make_mesh", "param_spec", "shard_model", "activation_mesh", "get_activation_mesh",
           "set_activation_mesh", "shard_tokens", "multihost"]
