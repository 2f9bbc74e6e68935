"""Causal flash attention on the card (K17-K19), its autograd Function and
its device dispatch.

``splash_fwd``, ``splash_dq`` and ``splash_dkv`` launch the hand-written
CUDA kernels of ``csrc/flash_attention.cu``, which replace the three Pallas
kernels that JAX's splash attention runs for ``_splash_attention`` of
``sparse_matrix_fine_tuning_tpu/models/llama.py:57``: the forward
(``flash_attention_kernel``, which also saves the logsumexp), dq
(``_flash_attention_dq_kernel``) and dk/dv (``_flash_attention_dkv_kernel``).
They take CUDA tensors only and raise for anything else.  Their plain
versions are in ``ops/attention.py``.

``splash_attention(q, k, v)`` dispatches by device alone: an autograd
Function whose forward is K17 and whose backward computes
``di = rowsum(o * dout)`` in fp32 in PyTorch, as the JAX backward does
outside its kernels, then launches K18 and K19, on a CUDA tensor; the same
Function on the plain versions for a CPU tensor (the CPU tests' mode).  It
saves q, k, v, o and lse.

Tensors are (b, t, heads, head_dim) with equal heads, q already scaled by
``1/sqrt(head_dim)``; the kernels take float32 or bfloat16 and a head_dim of
64 or 128, at any t; ``splash_attention`` refuses a wider head (Gemma's
256) on either device.  In bfloat16 the forward rounds P to bf16 for the
tensor cores' P.V, where the TPU kernel keeps P in fp32.

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one where it
launches its kernel, and nowhere else.

K17-K19 in bfloat16 are persistent: as many CTAs as the card holds at once
(one an SM) walk the work items, (batch * head, 128-row tile): K17 and K19
longest first (K17 the last q tile first, K19 kv tile 0 first), K18 in
units of two q tiles of one head, the longest and the shortest, head by
head.  ``attention_schedule`` and ``schedule_plan`` mirror the kernels'
schedule and plan in Python, shared memory included (the CPU tests hold
them to their rules); ``attention_plan`` reads the card's plan
(``PLAN_KEYS``), which the card tests hold to the mirror.
"""

from __future__ import annotations

import torch

from sparse_matrix_fine_tuning_torch.kernels.monarch_cuda import load_ops, plain_tensors
from sparse_matrix_fine_tuning_torch.ops.attention import (
    attention_di,
    attention_dkv_reference,
    attention_dq_reference,
    causal_attention_reference,
)

LAUNCHES = {"splash_fwd": 0, "splash_dq": 0, "splash_dkv": 0}
HEAD_DIMS = (64, 128)  # the head widths csrc/flash_attention.cu instantiates
# A head_dim past HEAD_DIMS that the JAX config accepts for splash (a
# multiple of 128: Gemma's 256) raises on either device, citing this entry.
WIDE_HEAD_ITEM = "ROADMAP.md queue B, 'K17-K19 at head_dim 256 (Gemma)'"


# The persistent bf16 K17-K19 (csrc/flash_attention.cu): rows a tile (K17's
# and K18's q tile, K19's kv tile); K17's kv tile rows by head_dim; K18's kv
# tile rows; K19's q rows a step, and its passes over q (dv, then dk, at
# 128); ring stages by kernel and head_dim; the threads of a CTA (two
# consumer warpgroups and a producer warp).
TILE_ROWS = 128
FWD_KV_ROWS = {64: 128, 128: 64}
DQ_KV_ROWS = 64
DKV_Q_ROWS = 64
DKV_PASSES = {64: 1, 128: 2}
STAGES = {("splash_fwd", 64): 3, ("splash_fwd", 128): 3,
          ("splash_dq", 64): 4, ("splash_dq", 128): 2,
          ("splash_dkv", 64): 4, ("splash_dkv", 128): 2}
DKV_KV_BUFS = {64: 2, 128: 1}  # K19's k and v tiles in flight: the next item's beside this one's
THREADS = 288
# The fields of a plan (smft_flash_attn_plan): SMs, CTAs an SM, the grid's
# CTAs, units of work (K17, K19: items; K18: pairs of q tiles), 128-row
# tiles, steps of T (K17, K18: kv tiles; K19: q steps), step rows, passes
# over q, ring stages, threads and shared memory a CTA (bytes).
PLAN_KEYS = ("sms", "per_sm", "ctas", "items", "tiles", "steps", "step_rows", "passes",
             "stages", "threads", "smem")
_WHICH = {"splash_fwd": 0, "splash_dq": 1, "splash_dkv": 2}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _step_rows(kernel: str, head_dim: int) -> int:
    return {"splash_fwd": FWD_KV_ROWS[head_dim], "splash_dq": DQ_KV_ROWS,
            "splash_dkv": DKV_Q_ROWS}[kernel]


def _units(kernel: str, heads_total: int, tiles: int) -> int:
    """The units of work a CTA takes one at a time: K17's and K19's items;
    K18's pairs of q tiles (``dq_units``)."""
    return heads_total * (_cdiv(tiles, 2) if kernel == "splash_dq" else tiles)


def _unit(kernel: str, heads_total: int, tiles: int, w: int) -> list[tuple[int, int]]:
    """The items (batch * head, tile) of unit ``w``: the kernels' ``ws_item``
    and ``dq_unit``.  K17 takes the last q tile (the most kv tiles) first,
    K19 kv tile 0 (the most q steps), an item a unit; K18's unit is q tiles
    tiles - 1 - p and p (the one where they meet alone) of one head, heads
    in order."""
    if kernel == "splash_dq":
        bh, p = divmod(w, _cdiv(tiles, 2))
        hi = tiles - 1 - p
        return [(bh, hi)] + ([(bh, p)] if p < hi else [])
    rank, bh = divmod(w, heads_total)
    return [(bh, rank if kernel == "splash_dkv" else tiles - 1 - rank)]


def item_length(kernel: str, t: int, head_dim: int, tile: int) -> int:
    """The ring steps of an item: K17's and K18's kv tiles up to the q
    tile's diagonal and none past t; K19's q steps from the one that reaches
    the kv tile's first row to the last, once a pass."""
    step = _step_rows(kernel, head_dim)
    if kernel != "splash_dkv":
        return min((tile + 1) * TILE_ROWS // step, _cdiv(t, step))
    return DKV_PASSES[head_dim] * (_cdiv(t, step) - tile * TILE_ROWS // step)


def attention_schedule(kernel: str, b: int, t: int, heads: int, head_dim: int,
                       ctas: int) -> list[list[tuple[int, int, int]]]:
    """The persistent K17 (``"splash_fwd"``), K18 (``"splash_dq"``) or K19
    (``"splash_dkv"``) on ``ctas`` CTAs: for each CTA its items in order, as
    (batch * head, tile, length).  CTA c takes units c, c + ctas, ... of the
    kernel's list (``_unit``)."""
    heads_total, tiles = b * heads, _cdiv(t, TILE_ROWS)
    out = [[] for _ in range(ctas)]
    for w in range(_units(kernel, heads_total, tiles)):
        for bh, tile in _unit(kernel, heads_total, tiles, w):
            out[w % ctas].append((bh, tile, item_length(kernel, t, head_dim, tile)))
    return out


def _round_up(x: int, a: int) -> int:
    return _cdiv(x, a) * a


def schedule_plan(kernel: str, b: int, t: int, heads: int, head_dim: int, sms: int,
                  per_sm: int) -> dict:
    """The plan (``PLAN_KEYS``) the kernel's host code makes for a call on a
    card of ``sms`` SMs holding ``per_sm`` CTAs each."""
    tiles = _cdiv(t, TILE_ROWS)
    items = _units(kernel, b * heads, tiles)
    stages = STAGES[(kernel, head_dim)]
    step = _step_rows(kernel, head_dim)
    tile_bytes = TILE_ROWS * head_dim * 2
    if kernel == "splash_fwd":
        passes = 1
        # two q tiles and o's staging, the ring of k and v; barriers q_full
        # and q_empty two each and three a stage; the swizzle's alignment slack
        smem = 3 * tile_bytes + 2 * stages * step * head_dim * 2 + 8 * (4 + 3 * stages) + 1024
    elif kernel == "splash_dq":
        passes = 1
        # two item buffers of q, dout (dq's staging) and the tile's lse and
        # di rows, the ring of k and v; barriers q_full and q_empty two each
        # and two a stage; the slack
        smem = (2 * (2 * tile_bytes + 2 * TILE_ROWS * 4) + 2 * stages * step * head_dim * 2
                + 8 * (4 + 2 * stages) + 1024)
    else:
        passes, bufs = DKV_PASSES[head_dim], DKV_KV_BUFS[head_dim]
        # the pairs of k and v, the staging of dk and dv, the ring of (q,
        # dout, lse, di); barriers kv_full and kv_empty a pair and two a
        # stage; the slack
        stage = _round_up(2 * step * head_dim * 2 + 2 * step * 4, 1024)
        smem = (2 * bufs + 2) * tile_bytes + stages * stage + 8 * (2 * bufs + 2 * stages) + 1024
    return dict(zip(PLAN_KEYS, (sms, per_sm, min(items, sms * per_sm), items, tiles,
                                _cdiv(t, step), step, passes, stages, THREADS, smem)))


def attention_plan(kernel: str, b: int, t: int, heads: int, head_dim: int) -> dict:
    """The card's plan of a bf16 K17, K18 or K19 call (``PLAN_KEYS``)."""
    return dict(zip(PLAN_KEYS, load_ops().flash_attn_plan(_WHICH[kernel], b, t, heads, head_dim)))


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(*tensors: torch.Tensor) -> None:
    plain_tensors(*tensors)
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"the attention CUDA kernels take CUDA tensors, got one on {t.device}")
    q = tensors[0]
    if q.dim() != 4 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the attention CUDA kernels take (b, t, heads, head_dim) with "
                         f"head_dim in {HEAD_DIMS}, got {tuple(q.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the attention CUDA kernels take float32 or bfloat16, got {q.dtype}")


def splash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K17: ``(o, lse)``, o in q's dtype, lse fp32 (b, heads, t)."""
    _check(q, k, v)
    o, lse = load_ops().flash_attn_fwd(q.contiguous(), k.contiguous(), v.contiguous())
    LAUNCHES["splash_fwd"] += 1
    return o, lse


def splash_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
              lse: torch.Tensor, di: torch.Tensor) -> torch.Tensor:
    """K18: dq in q's dtype; dout is taken in q's dtype."""
    _check(q, k, v, dout, lse, di)
    dq = load_ops().flash_attn_dq(q.contiguous(), k.contiguous(), v.contiguous(),
                                  dout.to(q.dtype).contiguous(), lse.contiguous(),
                                  di.contiguous())
    LAUNCHES["splash_dq"] += 1
    return dq


def splash_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
               lse: torch.Tensor, di: torch.Tensor):
    """K19: ``(dk, dv)`` in k's dtype; dout is taken in q's dtype."""
    _check(q, k, v, dout, lse, di)
    dk, dv = load_ops().flash_attn_dkv(q.contiguous(), k.contiguous(), v.contiguous(),
                                       dout.to(q.dtype).contiguous(), lse.contiguous(),
                                       di.contiguous())
    LAUNCHES["splash_dkv"] += 1
    return dk, dv


class _SplashFn(torch.autograd.Function):
    """K17 forward, K18 and K19 backward on the card; the plain versions on
    the CPU.  Saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = (splash_fwd if q.is_cuda else causal_attention_reference)(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dout = dout.to(q.dtype)
        di = attention_di(o, dout)
        if q.is_cuda:
            dq = splash_dq(q, k, v, dout, lse, di)
            dk, dv = splash_dkv(q, k, v, dout, lse, di)
        else:
            dq = attention_dq_reference(q, k, v, dout, lse, di)
            dk, dv = attention_dkv_reference(q, k, v, dout, lse, di)
        return dq, dk, dv


def splash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of pre-scaled q over k, v, all (b, t, heads,
    head_dim): the kernels on a CUDA tensor, the plain versions on a CPU
    tensor.  Differentiable.  A head_dim past ``HEAD_DIMS`` raises on the
    CPU as on the card (``WIDE_HEAD_ITEM``)."""
    if q.shape[-1] > max(HEAD_DIMS):
        raise NotImplementedError(f"splash attention at head_dim {q.shape[-1]}: K17-K19 "
                                  f"instantiate {HEAD_DIMS}; {WIDE_HEAD_ITEM}")
    plain_tensors(q, k, v)
    if not (q.dtype == k.dtype == v.dtype and q.shape == k.shape == v.shape):
        raise ValueError(f"q, k and v must share shape and dtype, got {tuple(q.shape)} "
                         f"{q.dtype}, {tuple(k.shape)} {k.dtype}, {tuple(v.shape)} {v.dtype}")
    return _SplashFn.apply(q, k, v)
