"""Monarch kernels on the card (K1-K4), their autograd Functions, and their
plain versions.

``monarch_kernel`` and ``monarch_add`` launch the hand-written CUDA forward
kernels of ``csrc/monarch_fwd.cu``; ``monarch_bwd`` and ``monarch_dw_fused``
the backward kernels of ``csrc/monarch_bwd.cu``.  They replace
``monarch_kernel``, ``monarch_add``, the backward ``_monarch_pallas_bwd_call``
and ``monarch_dw_fused`` of
``sparse_matrix_fine_tuning_tpu/kernels/monarch_pallas.py``.  They take CUDA
tensors only and raise for anything else: nothing here moves work to the
plain path or to the CPU.  ``monarch_mm`` dispatches by device alone: a
CUDA tensor goes to the kernel, a CPU tensor to the plain version (the CPU
tests' mode).

Semantics, for x of dtype T (float32 or bfloat16):
  monarch_kernel(x, w1, w2)      = blockdiag_butterfly_multiply(x, w1, w2)
  monarch_add(base, x, w1, w2)   = round_T(float(base) + monarch_f32(x))
  monarch_bwd(x, w1, w2, dout)   = (dx in T, dw1 fp32, dw2 fp32)
  monarch_dw_fused(x, dout, w1, w2) = (dw1 fp32, dw2 fp32)
where the intermediates are rounded to T and every sum is fp32.  The fused
add rounds once; the unfused ``base + monarch_kernel(x)`` rounds twice, so
the two differ by up to one ulp of T at the output's scale.

Gradients: ``monarch_kernel`` and ``monarch_add`` are autograd Functions
that save (x, w1, w2) only; their backward launches K3, which recomputes
the intermediate from x as the TPU kernel does.  The gradient of
``monarch_add``'s base is dout itself.

``monarch_fwd_tile(x, w1, w2, rows)`` launches K1's kernel at the row tile
``rows`` (one of ``FWD_TILE_ROWS``): K12, the counterpart of ``fwd_call`` in
``scripts/exp_fwd_tile.py``, which only ``scripts/exp_fwd_tile`` drives.  The
kernel's order of sums does not depend on its row tile, so K12 equals K1
bit for bit at every row tile; it has no gradient.  ``monarch_fwd_plan``
reports the plan a launch of K1/K2 (or K12 at ``rows``) takes: its row tile
and column ranges, which the plan picks from the row count.

``monarch_dw_tile(x, dout, w1, w2, rows)`` launches K4's kernel with its row
group set to ``rows`` (a positive multiple of ``DW_ROW_STEP``, the kernel's
16-row mma tile; the sweep is ``DW_TILE_ROWS``): K13, the counterpart of
``dw_kernel_v2`` in ``scripts/exp_dw_kernel.py``, whose sequence tile ts
sets the row groups (11, 6 and 3 at 2664 rows) that the kernel's clusters
walk.  ``monarch_dw_merged`` is K13 at ``MERGED_DW_ROWS``: K14, the
counterpart of ``dw_call_v2`` in ``scripts/exp_merged_v3.py``.  Only the
ports of those scripts drive them.  Their plain version is
``monarch_dw_fused_reference``: the function does not depend on the row
group.  Unlike the two TPU kernels they mask the rows past M.
``monarch_bwd_plan`` reports the design a launch of K3, K4 or K13 takes:
the cluster kernel (nblocks 4, blk_r in ``FAST_BLK_R``; "fast") or the
generic kernel, and its row groups; ``monarch_bwd_plan_fields`` the cluster
kernel's whole plan (``BWD_PLAN_KEYS``).

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one where it
launches its kernel, and nowhere else.
"""

from __future__ import annotations

import torch

from sparse_matrix_fine_tuning_torch.ops.monarch import (
    _monarch_dw_f32,
    blockdiag_butterfly_multiply,
    monarch_dx,
    monarch_forward_f32,
)

LAUNCHES = {"monarch_kernel": 0, "monarch_add": 0, "monarch_bwd": 0, "monarch_dw_fused": 0,
            "monarch_fwd_tile": 0, "monarch_dw_tile": 0, "monarch_dw_merged": 0}
FWD_TILE_ROWS = (8, 16, 32, 64)  # K12's row tiles: csrc/monarch_fwd.cu's kFwdTileRows
FWD_PLAN_KEYS = ("rows", "row_tiles", "ranges", "chunks", "cpl", "ns", "smem")
DW_TILE_ROWS = (256, 512, 1024)  # K13's sweep: scripts/exp_dw_kernel.py:107
MERGED_DW_ROWS = 256  # K14: dw_call_v2's ts, scripts/exp_merged_v3.py:23
DW_ROW_STEP = 16  # a row group is a multiple of the cluster kernel's 16-row mma tile
FAST_BLK_R = (4, 8, 16)  # blk_r (Q = R, nblocks 4) of csrc/monarch_bwd.cu's cluster kernel
# csrc/monarch_bwd.cu's smft_monarch_bwd_plan_fields: whether the cluster
# kernel runs, row groups, clusters, rows a group, rows a tile, stages of the
# copy ring, shared memory bytes a CTA, values of s a CTA's slice of dout,
# whether dw2's sums live in device memory (too wide for shared memory)
BWD_PLAN_KEYS = ("fast", "groups", "clusters", "rows", "tile", "stages", "smem", "slice",
                 "dw2_global")

_ops = None


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def load_ops():
    """Build (at first use) and load the kernel library; ``torch.ops.smft``."""
    global _ops
    if _ops is None:
        from sparse_matrix_fine_tuning_torch.kernels.build import build

        torch.ops.load_library(str(build()))
        _ops = torch.ops.smft
    return _ops


# -- plain versions ----------------------------------------------------------

def monarch_kernel_reference(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K1 (differentiable, plain backward)."""
    return blockdiag_butterfly_multiply(x, w1, w2)


def monarch_add_reference(base: torch.Tensor, x: torch.Tensor, w1: torch.Tensor,
                          w2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: the add in fp32, one rounding."""
    return (base.float() + monarch_forward_f32(x, w1, w2)).to(x.dtype)


def monarch_bwd_reference(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                          dout: torch.Tensor):
    """Plain PyTorch version of K3: ``(dx, dw1, dw2)``, dw in fp32.
    x (M, n), dout (M, m)."""
    dw1, dw2, dout1_kq = _monarch_dw_f32(x, dout, w1, w2)
    return monarch_dx(dout1_kq, w1, x.shape, x.dtype), dw1, dw2


def monarch_dw_fused_reference(x: torch.Tensor, dout: torch.Tensor, w1: torch.Tensor,
                               w2: torch.Tensor):
    """Plain PyTorch version of K4: ``(dw1, dw2)`` in fp32."""
    dw1, dw2, _ = _monarch_dw_f32(x, dout, w1, w2)
    return dw1, dw2


# -- kernels -----------------------------------------------------------------

def _check(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"the Monarch CUDA kernels take CUDA tensors, got one on {t.device}")


def _launch_fwd(x2d, w1, w2, base2d=None):
    if base2d is None:
        out = load_ops().monarch_fwd(x2d, w1, w2)
        LAUNCHES["monarch_kernel"] += 1
    else:
        out = load_ops().monarch_fwd_add(base2d, x2d, w1, w2)
        LAUNCHES["monarch_add"] += 1
    return out


def monarch_bwd(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, dout: torch.Tensor):
    """K3: ``(dx, dw1, dw2)`` of the Monarch multiply in one CUDA kernel (and,
    with more than one cluster or group, a pass that sums their partials).
    x (M, n), dout (M, m); dout is taken in x's dtype; dw1 and dw2 come out
    in fp32."""
    _check(x, w1, w2, dout)
    dx, dw1, dw2 = load_ops().monarch_bwd(x.contiguous(), w1.contiguous(), w2.contiguous(),
                                          dout.to(x.dtype).contiguous())
    LAUNCHES["monarch_bwd"] += 1
    return dx, dw1, dw2


def monarch_dw_fused(x: torch.Tensor, dout: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """K4: ``(dw1, dw2)`` in fp32 from one read of x (M, n) and dout (M, m)."""
    _check(x, dout, w1, w2)
    dw1, dw2 = load_ops().monarch_dw_fused(x.contiguous(), dout.to(x.dtype).contiguous(),
                                           w1.contiguous(), w2.contiguous())
    LAUNCHES["monarch_dw_fused"] += 1
    return dw1, dw2


def _check_rows(rows: int) -> None:
    if not (isinstance(rows, int) and rows > 0 and rows % DW_ROW_STEP == 0):
        raise ValueError(f"monarch_dw_tile: the row group must be a positive multiple of "
                         f"{DW_ROW_STEP} rows, got {rows!r}")


def _dw_tile(x, dout, w1, w2, rows: int):
    return load_ops().monarch_dw_tile(x.contiguous(), dout.to(x.dtype).contiguous(),
                                      w1.contiguous(), w2.contiguous(), rows)


def monarch_dw_tile(x: torch.Tensor, dout: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                    rows: int):
    """K13: K4's function, ``(dw1, dw2)`` in fp32 from x (M, n) and dout
    (M, m), with the kernel's row group set to ``rows``, a positive multiple
    of 16 (``DW_TILE_ROWS`` is the sweep).  Its plain version is
    ``monarch_dw_fused_reference``."""
    _check_rows(rows)
    _check(x, dout, w1, w2)
    dw1, dw2 = _dw_tile(x, dout, w1, w2, rows)
    LAUNCHES["monarch_dw_tile"] += 1
    return dw1, dw2


def monarch_dw_merged(x: torch.Tensor, dout: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """K14: the merged design's factor gradients, K13 at ``MERGED_DW_ROWS``
    rows a group.  Its plain version is ``monarch_dw_fused_reference``."""
    _check(x, dout, w1, w2)
    dw1, dw2 = _dw_tile(x, dout, w1, w2, MERGED_DW_ROWS)
    LAUNCHES["monarch_dw_merged"] += 1
    return dw1, dw2


def monarch_bwd_plan(rows_m: int, w1_shape, w2_shape, rows: int = 0, with_dx: bool = False,
                     dtype: torch.dtype = torch.bfloat16) -> tuple[bool, int]:
    """``(fast, groups)``: whether a launch of K3 (``with_dx``), K4 or K13
    (``rows`` > 0) on ``rows_m`` rows of 16-byte aligned tensors takes the
    cluster kernel ("fast"), and how many row groups it sums.  Reads the
    current card."""
    if rows:
        _check_rows(rows)
    fast, groups = load_ops().monarch_bwd_plan(rows_m, *w1_shape, *w2_shape, rows, with_dx,
                                               dtype.itemsize)
    return bool(fast), int(groups)


def monarch_bwd_plan_fields(rows_m: int, w1_shape, w2_shape, rows: int = 0,
                            with_dx: bool = False, dtype: torch.dtype = torch.bfloat16,
                            tile: int = 0, stages: int = 0) -> dict:
    """The plan of a launch of K3, K4 or K13 as ``BWD_PLAN_KEYS`` (all but
    ``groups`` 0 where it takes the generic kernel); ``tile`` and ``stages``
    > 0 force those.  Reads the current card."""
    if rows:
        _check_rows(rows)
    plan = load_ops().monarch_bwd_plan_fields(rows_m, *w1_shape, *w2_shape, rows, with_dx,
                                              dtype.itemsize, tile, stages)
    return dict(zip(BWD_PLAN_KEYS, (int(v) for v in plan)))


class _MonarchKernelFn(torch.autograd.Function):
    """K1 forward, K3 backward; saves (x, w1, w2) only."""

    @staticmethod
    def forward(ctx, x2d, w1, w2):
        ctx.save_for_backward(x2d, w1, w2)
        return _launch_fwd(x2d, w1, w2)

    @staticmethod
    def backward(ctx, dout):
        x2d, w1, w2 = ctx.saved_tensors
        dx, dw1, dw2 = monarch_bwd(x2d, w1, w2, dout)
        return dx, dw1.to(w1.dtype), dw2.to(w2.dtype)


class _MonarchAddFn(torch.autograd.Function):
    """K2 forward, K3 backward; d_base = dout."""

    @staticmethod
    def forward(ctx, base2d, x2d, w1, w2):
        ctx.save_for_backward(x2d, w1, w2)
        ctx.base_dtype = base2d.dtype
        return _launch_fwd(x2d, w1, w2, base2d)

    @staticmethod
    def backward(ctx, dout):
        x2d, w1, w2 = ctx.saved_tensors
        dx, dw1, dw2 = monarch_bwd(x2d, w1, w2, dout)
        return dout.to(ctx.base_dtype), dx, dw1.to(w1.dtype), dw2.to(w2.dtype)


def monarch_kernel(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """K1: ``x @ Monarch(w1, w2)^T`` in one CUDA kernel.  x (..., n).
    Differentiable: the gradient is K3."""
    _check(x, w1, w2)
    *batch, n = x.shape
    out = _MonarchKernelFn.apply(x.reshape(-1, n).contiguous(), w1.contiguous(),
                                 w2.contiguous())
    return out.reshape(*batch, out.shape[-1])


def monarch_add(base: torch.Tensor, x: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
    """K2: ``base + monarch(x)`` with the add in the kernel's epilogue.
    Differentiable: the gradient of x, w1 and w2 is K3, that of base dout."""
    _check(x, w1, w2, base)
    *batch, n = x.shape
    out = _MonarchAddFn.apply(base.reshape(-1, base.shape[-1]).contiguous(),
                              x.reshape(-1, n).contiguous(), w1.contiguous(), w2.contiguous())
    return out.reshape(base.shape)


def monarch_fwd_tile(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
                     rows: int) -> torch.Tensor:
    """K12: K1's function on x (B, n) with the kernel's row tile set to
    ``rows``, one of ``FWD_TILE_ROWS``.  Its plain version is
    ``monarch_kernel_reference``."""
    _check(x, w1, w2)
    if rows not in FWD_TILE_ROWS:
        raise ValueError(f"monarch_fwd_tile: rows {rows} is not one of {FWD_TILE_ROWS}")
    out = load_ops().monarch_fwd_tile(x.contiguous(), w1.contiguous(), w2.contiguous(), rows)
    LAUNCHES["monarch_fwd_tile"] += 1
    return out


def monarch_fwd_plan(rows_m: int, w1_shape, w2_shape, dtype: torch.dtype = torch.bfloat16,
                     rows: int = 0) -> dict:
    """The plan of a K1/K2 launch on ``rows_m`` rows (K12's at row tile
    ``rows`` > 0), as ``FWD_PLAN_KEYS``: the row tile, row tiles, column
    ranges, output chunks of 16 bytes a CTA, chunks a lane and segments a
    block of stage 1, and shared memory bytes.  The plan
    depends on the shapes alone; the library is loaded (built) first."""
    plan = load_ops().monarch_fwd_plan(rows_m, *w1_shape, *w2_shape, dtype.itemsize, rows)
    return dict(zip(FWD_PLAN_KEYS, (int(v) for v in plan)))


def monarch_mm(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Device dispatch of K1: the kernel on CUDA, the plain version on the CPU."""
    if x.is_cuda:
        return monarch_kernel(x, w1, w2)
    return monarch_kernel_reference(x, w1, w2)


def monarch_dw_any(x: torch.Tensor, dout: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor):
    """Device dispatch of K4: (dw1, dw2) in fp32, the kernel on CUDA, the
    plain version on the CPU."""
    if x.is_cuda:
        return monarch_dw_fused(x, dout, w1, w2)
    return monarch_dw_fused_reference(x, dout, w1, w2)
