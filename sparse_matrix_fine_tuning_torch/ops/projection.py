"""SVD projection of dense matrices onto Monarch factors, plain PyTorch.

Counterpart of ``sparse_matrix_fine_tuning_tpu/ops/projection.py``.  Given a
dense M (m, n), the block-diagonal factors (w1, w2) whose Monarch product is
closest to M in Frobenius norm: under the butterfly permutations the problem
splits into independent low-rank approximations of the (l, i) slices of M,
each solved by a truncated SVD.

  M viewed as blocks: M[(l j), (k i)] -> slice[k, j] of shape (l, i)
  slice[k, j] ~= U[k, j] @ Vt[k, j]   (rank-r truncated SVD, sqrt(S) split)
  w1 = Vt laid out as (k, (r j), i)
  w2 = U  laid out as (j, l, (k r))

so that ``blockdiag_butterfly_multiply(x, w1, w2) == x @ M^T`` up to the
truncation (exact where the rank reaches min(l, i)).  The module is
orientation-agnostic: it approximates M (``MonarchLinear`` decides which
matrix to project).

The SVD (``torch.linalg.svd``, a library call as ``jnp.linalg.svd`` is in
JAX) runs in float32 on the input's device: the card's cuSOLVER there, the
CPU's LAPACK here.  Each singular pair is defined up to its sign, so the
factors can differ from JAX's by a sign per pair while their product does
not.

``blockdiag_butterfly_project`` and ``butterfly_fft_factors``, which serve
only ``layers/structured.ButterflyFFT`` and complex inputs, are not ported
(ROADMAP.md queue A items 26 and 8).
"""

from __future__ import annotations

import math

import torch


def factors(n: int) -> list[tuple[int, int]]:
    """All factor pairs (i, n // i) with i <= sqrt(n), ascending in i."""
    return [(i, n // i) for i in range(1, math.floor(math.sqrt(n)) + 1) if n % i == 0]


def low_rank_project(M: torch.Tensor, rank: int, reverse: bool = False):
    """Batched rank-``rank`` truncation of M by SVD, sqrt(S) split into both
    factors: (U (..., l, rank), Vt (..., rank, i)); with ``reverse`` also the
    pair built from the trailing singular vectors.  float32 throughout."""
    U, S, Vt = torch.linalg.svd(M.float(), full_matrices=False)
    s_sqrt = S[..., :rank].sqrt()
    U_r = U[..., :rank] * s_sqrt[..., None, :]
    Vt_r = s_sqrt[..., :, None] * Vt[..., :rank, :]
    if not reverse:
        return U_r, Vt_r
    s_rev = S[..., rank:].sqrt()
    return U_r, Vt_r, U[..., rank:] * s_rev[..., None, :], s_rev[..., :, None] * Vt[..., rank:, :]


def _split_blocks(M: torch.Tensor, nblocks1: int, nblocks2: int) -> torch.Tensor:
    """rearrange(M, "(l j) (k i) -> k j l i")."""
    m, n = M.shape
    k, j = nblocks1, nblocks2
    l, i = m // j, n // k
    if l * j != m or k * i != n:
        raise ValueError(f"M {tuple(M.shape)} not divisible by ({nblocks1}, {nblocks2})")
    return M.reshape(l, j, k, i).permute(2, 1, 0, 3)


def _factor_layout(U: torch.Tensor, Vt: torch.Tensor):
    """(w1, w2) of the blocks' (U, Vt): k j r i -> k (r j) i and
    k j l r -> j l (k r)."""
    k, j, r, _ = Vt.shape
    w1 = Vt.permute(0, 2, 1, 3).reshape(k, r * j, -1)
    w2 = U.permute(1, 2, 0, 3).reshape(j, -1, k * r)
    return w1, w2


def blockdiag_butterfly_project_einsum_rank(M: torch.Tensor, nblocks1: int, nblocks2: int,
                                            rank: int, reverse: bool = False):
    """Rank-``rank`` Monarch projection of a (possibly rectangular) M (m, n):
    w1 (nblocks1, rank * nblocks2, n // nblocks1) and w2 (nblocks2,
    m // nblocks2, nblocks1 * rank), float32; with ``reverse`` also the pair
    from the residual (least significant) singular directions."""
    blocks = _split_blocks(M, nblocks1, nblocks2)
    if not reverse:
        return _factor_layout(*low_rank_project(blocks, rank))
    U, Vt, U_rev, Vt_rev = low_rank_project(blocks, rank, reverse=True)
    return (*_factor_layout(U, Vt), *_factor_layout(U_rev, Vt_rev))


def blockdiag_butterfly_project_einsum_simple(M: torch.Tensor, nblocks1: int, nblocks2: int):
    """The rank-1 case."""
    return blockdiag_butterfly_project_einsum_rank(M, nblocks1, nblocks2, rank=1)


def blockdiag_butterfly_multiply_einsum_rank(x: torch.Tensor, w1: torch.Tensor,
                                             w2: torch.Tensor) -> torch.Tensor:
    """Einsum oracle of the projected factors' layouts, output flat index
    (l j); equal to ``blockdiag_butterfly_multiply(x, w1, w2)``."""
    *batch, n = x.shape
    k, jr, i = w1.shape
    j, l, kr = w2.shape
    r = jr // j
    if jr != j * r or kr != k * r or k * i != n:
        raise ValueError(f"factors {tuple(w1.shape)}, {tuple(w2.shape)} do not fit input {n}")
    out = torch.einsum("bki,krji,jlkr->blj", x.reshape(-1, k, i), w1.reshape(k, r, j, i),
                       w2.reshape(j, l, k, r))
    return out.reshape(*batch, l * j)
