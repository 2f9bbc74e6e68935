"""The tiled bf16 matrix product on the card (K15) and its plain version.

Counterpart of ``make_mm`` in ``scripts/exp_matmul_tiles.py`` (the Pallas
kernel at :20, launched at :40), a bench-only kernel that only
``scripts/exp_matmul_tiles`` drives:

  tiled_matmul(x, w, tile) = round_bf16(x @ w),  x (M, K), w (K, N), bf16,
                                                 the sum in fp32

``tiled_matmul`` launches the hand-written CUDA kernel of
``csrc/tiled_matmul.cu`` (wgmma fed by TMA through a ring of shared-memory
stages) at one of ``TILES``: (BM, BN, S), BM x BN outputs a CTA and S
stages of a k step of 64.  It takes CUDA bfloat16 tensors only, with K and
N multiples of 8, and raises for anything else (the device here, the rest
in the binding, ``csrc/ops.cpp``).  ``tiled_matmul_reference``
is its plain version, which the CPU tests use and the card's checks hold
the kernel against.

``LAUNCHES`` counts the kernel's launches: the wrapper adds one where it
launches, and nowhere else.
"""

from __future__ import annotations

import torch

from sparse_matrix_fine_tuning_torch.kernels.experimental.more_linear import _aligned
from sparse_matrix_fine_tuning_torch.kernels.monarch_cuda import load_ops

# (BM, BN, stages): the tiles csrc/tiled_matmul.cu instantiates
TILES = [(64, 128, 4), (64, 256, 4), (128, 128, 4), (128, 128, 5), (128, 256, 3),
         (128, 256, 4)]
BK = 64  # k a stage
SMEM_LIMIT = 232448  # bytes of shared memory a CTA may use on an H100 (227 KB)

LAUNCHES = {"tiled_matmul": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def tile_smem_bytes(bm: int, bn: int, stages: int) -> int:
    """Shared memory a CTA of the tile takes: the stages of x's (bm, 64) and
    w's (64, bn) bf16 tiles, a full and an empty barrier a stage, and 1 KB
    of slack to align the tiles on the 128-byte swizzle's period (as
    ``Tile::kSmem`` in the kernel)."""
    return stages * (bm + bn) * BK * 2 + 2 * stages * 8 + 1024


def tiled_matmul_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K15: the product in fp32, rounded once to x's
    dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def tiled_matmul(x: torch.Tensor, w: torch.Tensor, tile=TILES[-1]) -> torch.Tensor:
    """K15: ``x @ w`` in bf16 with an fp32 sum, at ``tile`` = (BM, BN,
    stages), one of ``TILES``.  x (M, K) and w (K, N) CUDA bfloat16."""
    for t in (x, w):
        if not t.is_cuda:
            raise ValueError(f"the tiled matmul CUDA kernel takes CUDA tensors, got one on "
                             f"{t.device}")
    y = load_ops().tiled_matmul(_aligned(x), _aligned(w), *tile)
    LAUNCHES["tiled_matmul"] += 1
    return y
