"""Block-sparse linear with butterfly sparsity layouts, PyTorch.

Counterpart of ``sparse_matrix_fine_tuning_tpu/layers/blocksparse.py``: a
linear layer whose weight is stored as the ``nnz`` active (block x block)
blocks of a block-level layout, in ``np.nonzero``'s row-major order, with
``FlatBlockButterflySparsityConfig``'s flat-butterfly layouts.

  * Features that are no multiple of the block are padded to it
    (``in_features_extended``, ``out_features_extended``): the input gets
    zero columns and the output is cut back to ``out_features``.
  * Init: Kaiming-uniform over the extended dense weight, each block row
    scaled by sqrt(ncols / nnz_cols) to restore the dense fan-in variance,
    then cut to the active blocks; bias uniform in +-1/sqrt(fan_in).  Drawn
    from a CPU generator and moved (another stream than JAX's: parity runs
    through bridged weights).
  * Forward: the active blocks are scattered into the dense (out_ext,
    in_ext) operand, then one ``F.linear``, as the JAX layer's one
    ``dot_general``.
  * State: ``weight`` (nnz, block, block), ``bias``, and the layout
    (``layout``, int64) and the blocks' flat indices (``_flat_idx``, int32)
    as persistent buffers of the JAX state's dtypes, so ``load_jax_state``
    carries ``nnx.state`` of a JAX layer across as it is.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sparse_matrix_fine_tuning_torch.layers.structured import CPU, uniform
from sparse_matrix_fine_tuning_torch.ops.butterfly import butterfly_factor_to_matrix
from sparse_matrix_fine_tuning_torch.utils.device import resolve_device, seeded_generator


class FlatBlockButterflySparsityConfig:
    """Block-level butterfly support: the union of the first ``n_factors``
    butterfly factors' supports of size ``butterfly_size``, tiled up to the
    feature sizes, with an optional ShuffleNet column shuffle and
    ``global_size`` dense leading rows and columns."""

    def __init__(self, butterfly_size: int, n_factors: int, block: int = 32,
                 global_size: int = 0, shuffle: bool = False):
        log_n = int(math.log2(butterfly_size))
        if butterfly_size != 2 ** log_n or butterfly_size < 2:
            raise NotImplementedError("butterfly_size must be a power of 2")
        if not 1 <= n_factors <= log_n:
            raise NotImplementedError("n_factors must be between 1 and log2(butterfly_size)")
        self.block = block
        self.butterfly_size = butterfly_size
        self.n_factors = n_factors
        self.global_size = global_size
        self.shuffle = shuffle

    def make_layout(self, out_features: int, in_features: int) -> np.ndarray:
        """(out_features // block, in_features // block) 0/1 int64 array."""
        if out_features % self.block or in_features % self.block:
            raise ValueError(f"{out_features} x {in_features} is no multiple of the block "
                             f"{self.block}")
        bs = self.butterfly_size
        twiddle = torch.ones(bs // 2, 2, 2)
        support = sum(butterfly_factor_to_matrix(twiddle, i).numpy()
                      for i in range(self.n_factors))
        layout = (support > 0).astype(np.int64)                  # (bs, bs)
        if self.shuffle:
            ngroups = 2 ** (int(math.log2(bs)) - self.n_factors)
            # (m, group * c_per_group) -> (m, c_per_group * group)
            layout = layout.reshape(bs, ngroups, bs // ngroups).transpose(0, 2, 1).reshape(bs, bs)
        f, f1 = out_features // bs, in_features // bs
        layout = np.repeat(np.repeat(layout, f, axis=0), f1, axis=1)
        if self.global_size > 0:
            layout[: self.global_size] = 1
            layout[:, : self.global_size] = 1
        p, r = out_features // self.block, in_features // self.block
        layout = layout.reshape(p, self.block, r, self.block)
        return (layout.sum(axis=(1, 3)) > 0).astype(np.int64)


class BlockSparseLinear(nn.Module):
    """y = x @ W^T + b, W's support a block-level layout, only its ``nnz``
    active blocks stored and trained.

    ``sparsity_config``: an object with ``.block`` and
    ``.make_layout(out_ext, in_ext)``; or else an explicit 0/1 ``layout``
    of shape (out_ext // block_size, in_ext // block_size) with
    ``block_size``."""

    def __init__(self, in_features: int, out_features: int, sparsity_config=None, *,
                 layout: Optional[np.ndarray] = None, block_size: Optional[int] = None,
                 bias: bool = True, param_dtype: torch.dtype = torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(CPU, generator)
        self.in_features, self.out_features = in_features, out_features
        if sparsity_config is not None:
            block_size = sparsity_config.block
        if block_size is None:
            raise ValueError("need sparsity_config or block_size")
        self.block_size = block_size
        self.in_features_extended = -(-in_features // block_size) * block_size
        self.out_features_extended = -(-out_features // block_size) * block_size
        if sparsity_config is not None:
            layout = sparsity_config.make_layout(self.out_features_extended,
                                                 self.in_features_extended)
        layout = np.asarray(layout, np.int64)
        p, r = self.out_features_extended // block_size, self.in_features_extended // block_size
        if layout.shape != (p, r):
            raise ValueError(f"layout {layout.shape} does not tile {self.out_features_extended} x "
                             f"{self.in_features_extended} by {block_size}")
        ob, ib = np.nonzero(layout)                              # active blocks, row-major
        self.nnz_blocks = int(len(ob))
        self.register_buffer("layout", torch.from_numpy(layout).to(device))
        self.register_buffer("_flat_idx", torch.from_numpy(ob * r + ib).to(torch.int32).to(device))

        fan_in = self.in_features_extended
        bound = math.sqrt(3.0) * math.sqrt(2.0 / (1 + 5)) / math.sqrt(fan_in)
        dense = uniform((self.out_features_extended, fan_in), bound, torch.float32, CPU,
                        generator)
        scaling = torch.from_numpy(np.sqrt(r / layout.sum(axis=1))).float()   # (p,)
        dense = dense * scaling.repeat_interleave(block_size)[:, None]
        blocks = dense.reshape(p, block_size, r, block_size).permute(0, 2, 1, 3)
        blocks = blocks[torch.from_numpy(ob), torch.from_numpy(ib)]         # (nnz, bs, bs)
        self.weight = nn.Parameter(blocks.to(device=device, dtype=param_dtype))
        self.bias = nn.Parameter(uniform((out_features,), 1 / math.sqrt(fan_in), torch.float32,
                                         device, generator).to(param_dtype)) if bias else None

    @property
    def saving(self) -> float:
        return self.nnz_blocks * self.block_size ** 2 / (self.in_features * self.out_features)

    def dense_weight(self) -> torch.Tensor:
        """The (out_ext, in_ext) dense weight, zero off the active blocks."""
        p, r = self.layout.shape
        bsz = self.block_size
        flat = self.weight.new_zeros(p * r, bsz, bsz)
        flat = flat.index_put((self._flat_idx.long(),), self.weight)
        return flat.reshape(p, r, bsz, bsz).permute(0, 2, 1, 3).reshape(p * bsz, r * bsz)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pad = self.in_features_extended - x.shape[-1]
        if pad:
            x = F.pad(x, (0, pad))
        out = F.linear(x, self.dense_weight().to(x.dtype))[..., : self.out_features]
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out
