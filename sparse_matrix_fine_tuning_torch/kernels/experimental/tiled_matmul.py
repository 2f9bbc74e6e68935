"""The tiled bf16 matrix product on the card (K15) and its plain version.

Counterpart of ``make_mm`` in ``scripts/exp_matmul_tiles.py`` (the Pallas
kernel at :20, launched at :40), a bench-only kernel that only
``scripts/exp_matmul_tiles`` drives:

  tiled_matmul(x, w, tile) = round_bf16(x @ w),  x (M, K), w (K, N), bf16,
                                                 the sum in fp32

``tiled_matmul`` launches the hand-written CUDA kernel of
``csrc/tiled_matmul.cu`` at one of ``TILES``: (BM, BN, S), BM x BN outputs a
tile and S stages of a k step of 64.  The kernel is persistent: clusters of
two CTAs, as many as the card holds at once, walk a static schedule of
units (two neighbouring row tiles by a column tile, w's tile shared by
multicast; ``tiled_matmul_schedule`` mirrors it), with one ring of
shared-memory stages running on from unit to unit and the output leaving by
TMA stores.  It takes CUDA bfloat16 tensors only, with K and N multiples of
8, and raises for anything else (the device here, the rest in the binding,
``csrc/ops.cpp``).  ``tiled_matmul_reference`` is its plain version, which
the CPU tests use and the card's checks hold the kernel against.

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
GROUP_ROWS = 16  # the schedule's rasterisation: units walk 16 row tiles, then the next columns
CLUSTER = 2  # CTAs a cluster: neighbouring row tiles that share w's tile
# tiled_matmul_plan's fields, as smft_tiled_matmul_plan writes them
PLAN_KEYS = ("resident", "grid", "cluster", "m_tiles", "n_tiles", "k_steps", "units", "out_cols",
             "smem")

LAUNCHES = {"tiled_matmul": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tile_out_cols(bm: int, bn: int, stages: int) -> int:
    """Columns of the output tile the epilogue stages at once in shared
    memory: all ``bn`` where the whole tile fits beside the ring, else half
    (stored in two passes), as ``Tile::kOutCols`` in the kernel."""
    ring = stages * (bm + bn) * BK * 2
    return bn if ring + bm * bn * 2 + 2 * stages * 8 + 1024 <= SMEM_LIMIT else bn // 2


def tile_smem_bytes(bm: int, bn: int, stages: int) -> int:
    """Shared memory a CTA of the tile takes: the stages of x's (bm, 64) and
    w's (64, bn) bf16 tiles, the epilogue's staging of ``tile_out_cols``
    columns of the output tile, a full and an empty barrier a stage, and 1
    KB of slack to align the tiles on the 128-byte swizzle's period (as
    ``Tile::kSmem`` in the kernel)."""
    return (stages * (bm + bn) * BK * 2 + bm * tile_out_cols(bm, bn, stages) * 2
            + 2 * stages * 8 + 1024)


def schedule_plan(m: int, n: int, k: int, tile, resident: int, cluster: int = CLUSTER) -> dict:
    """The plan the kernel's host code makes for a call (``PLAN_KEYS``) on a
    card that holds ``resident`` CTAs of the tile at once (a multiple of
    ``cluster``): the tile counts, the units (``cluster`` row tiles by a
    column tile) and the grid, a cluster a unit up to every resident one."""
    bm, bn, stages = tile
    m_tiles, n_tiles = cdiv(m, bm), cdiv(n, bn)
    units = cdiv(m_tiles, cluster) * n_tiles
    return {"resident": resident, "grid": min(units, resident // cluster) * cluster,
            "cluster": cluster, "m_tiles": m_tiles, "n_tiles": n_tiles, "k_steps": cdiv(k, BK),
            "units": units, "out_cols": tile_out_cols(bm, bn, stages),
            "smem": tile_smem_bytes(bm, bn, stages)}


def unit_coords(u: int, m_units: int, n_tiles: int, cluster: int = CLUSTER) -> tuple[int, int]:
    """(unit row, column tile) of unit ``u`` of the schedule: groups of
    ``GROUP_ROWS`` row tiles, column after column within a group, so that
    clusters working at once share w's columns.  CTA ``rank`` of a cluster
    takes row tile unit row * ``cluster`` + rank."""
    group = GROUP_ROWS // cluster
    per_group = group * n_tiles
    g, within = divmod(u, per_group)
    first = g * group
    rows = min(m_units - first, group)
    return first + within % rows, within // rows


def tiled_matmul_schedule(m: int, n: int, k: int, tile, resident: int,
                          cluster: int = CLUSTER) -> list[list[dict]]:
    """The kernel's static schedule, computed from the shape, the tile, the
    resident CTAs and the cluster size alone (``schedule_plan``): for each
    CTA of the grid (cluster c, rank r is CTA c * cluster + r), the tiles it
    computes, in order, each with all its k steps.  Cluster c takes units
    c, c + clusters, ...: ``cluster`` neighbouring row tiles by one column
    tile (``unit``; ``m`` and ``n`` the CTA's tile), one row tile a CTA,
    sharing w's tile.  A row tile past the last (``m`` = ``m_tiles``, where
    the row tiles are odd) reads zeros and stores nothing."""
    plan = schedule_plan(m, n, k, tile, resident, cluster)
    m_units = cdiv(plan["m_tiles"], cluster)
    clusters = plan["grid"] // cluster
    schedule = []
    for c in range(clusters):
        coords = [(u, *unit_coords(u, m_units, plan["n_tiles"], cluster))
                  for u in range(c, plan["units"], clusters)]
        for rank in range(cluster):
            schedule.append([{"unit": u, "m": um * cluster + rank, "n": nt} for u, um, nt in coords])
    return schedule


def tiled_matmul_plan(m: int, n: int, k: int, tile) -> dict:
    """The plan of a call on the current card (``PLAN_KEYS``), as the
    kernel's host code makes it (``schedule_plan`` mirrors it): the CTAs
    the card holds at once, the grid, the cluster, the tile counts and k
    steps, the units, the epilogue's staged columns and the shared memory a
    CTA."""
    return dict(zip(PLAN_KEYS, load_ops().tiled_matmul_plan(m, n, k, *tile)))


def tiled_matmul_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K15: the product in fp32, rounded once to x's
    dtype."""
    return (x.float() @ w.float()).to(x.dtype)


def tiled_matmul(x: torch.Tensor, w: torch.Tensor, tile=TILES[-1]) -> torch.Tensor:
    """K15: ``x @ w`` in bf16 with an fp32 sum, at ``tile`` = (BM, BN,
    stages), one of ``TILES``.  x (M, K) and w (K, N) CUDA bfloat16.  Each
    output's k steps are summed in order by one CTA: a repeated call gives
    the same bits."""
    for t in (x, w):
        if not t.is_cuda:
            raise ValueError(f"the tiled matmul CUDA kernel takes CUDA tensors, got one on "
                             f"{t.device}")
    y = load_ops().tiled_matmul(_aligned(x), _aligned(w), *tile)
    LAUNCHES["tiled_matmul"] += 1
    return y
