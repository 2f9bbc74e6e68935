"""Activation sharding: Megatron sequence parallelism and the tensor-parallel
regions' collectives.

Counterpart of ``sparse_matrix_fine_tuning_tpu/parallel/annotate.py``.  In
JAX one ``with_sharding_constraint`` at each block boundary lets XLA turn
the row-parallel all-reduce into a reduce-scatter and put the all-gather
before the next column-parallel product.  Eager PyTorch has no trace to
annotate, so the port moves the data itself, with the same dataflow (Megatron
SP, the tp group doubling as the sequence group):

* the residual stream and the RMSNorms run on the rank's slice of the
  sequence (``shard_tokens``);
* a block's column-parallel products take the full sequence, all-gathered
  before them (``enter_tp`` under SP; backward: a reduce-scatter);
* a block's row-parallel products hand back partial sums, reduce-scattered
  along the sequence (``exit_tp`` under SP; backward: an all-gather).

Without SP the same block boundaries copy the replicated input into the tp
region (backward: an all-reduce of the partial input gradients) and
all-reduce the partial sums (backward: the identity).

``shard_tokens(x)`` is a no-op unless a mesh has been installed
(``activation_mesh``, which the Trainer enters around its steps when
``sequence_parallel`` resolves on), and keeps JAX's guards: no mesh, tp <= 1,
x not 3-D, or a sequence that tp does not divide (decode's one token) leave
x as it is.  ``models/llama.py`` calls it at the four boundaries JAX marks
(llama.py:250, :315, :321, :344): after the embedding it splits the
sequence; after each layer and the final norm, given the full length, it
finds x already in the layout and leaves it; the head then gathers it back
(``gather_tokens``).  The batch axis needs no constraint: each rank already
holds its data rank's rows.

``TensorParallel`` is a module's view of the tp axis (its group, this
rank's index and the axis size), set by ``sharding.shard_model``; the
region functions below are autograd Functions over its group.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

_STATE: dict = {"mesh": None}


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """The tp axis as a module sees it."""

    group: object
    rank: int
    size: int


def tensor_parallel(mesh) -> Optional[TensorParallel]:
    """``mesh``'s tp axis, or None where it has one device."""
    if mesh is None or int(mesh.mesh.shape[-1]) <= 1:
        return None
    sub = mesh["tp"]
    return TensorParallel(sub.get_group(), int(sub.get_local_rank()), int(sub.size()))


def set_activation_mesh(mesh) -> None:
    """Install (or clear, with None) the mesh ``shard_tokens`` follows."""
    _STATE["mesh"] = mesh


def get_activation_mesh():
    return _STATE["mesh"]


@contextlib.contextmanager
def activation_mesh(mesh):
    """Scoped ``set_activation_mesh``."""
    prev = _STATE["mesh"]
    _STATE["mesh"] = mesh
    try:
        yield
    finally:
        _STATE["mesh"] = prev


def sequence_parallel(x: torch.Tensor, seq_len: Optional[int] = None) -> Optional[TensorParallel]:
    """The tp axis the installed mesh shards (batch, seq, hidden) activations
    of full length ``seq_len`` (x's own when None) over, or None where JAX's
    guards leave them whole."""
    tp = tensor_parallel(_STATE["mesh"])
    if tp is None or getattr(x, "ndim", 0) != 3:
        return None
    full = x.shape[1] if seq_len is None else seq_len
    return tp if full % tp.size == 0 else None


def shard_tokens(x: torch.Tensor, seq_len: Optional[int] = None) -> torch.Tensor:
    """x in the SP layout: this rank's slice of the sequence (backward: an
    all-gather), or x itself where ``sequence_parallel`` is None or x, of
    full length ``seq_len``, is in the layout already."""
    tp = sequence_parallel(x, seq_len)
    if tp is None or (seq_len is not None and x.shape[1] != seq_len):
        return x
    return tp_split(x, tp, 1)


def gather_tokens(x: torch.Tensor, tp: Optional[TensorParallel]) -> torch.Tensor:
    """The whole sequence of an SP-layout x, replicated on every tp peer
    (backward: each peer keeps its slice)."""
    return x if tp is None else tp_gather(x, tp, 1)


def enter_tp(x: torch.Tensor, tp: Optional[TensorParallel], sp: bool) -> torch.Tensor:
    """A block's input as its column-parallel products take it: under SP the
    sequence all-gathered, else x (backward: the peers' partial gradients
    reduce-scattered, or all-reduced)."""
    if tp is None:
        return x
    return tp_gather_partial(x, tp, 1) if sp else tp_copy(x, tp)


def exit_tp(y: torch.Tensor, tp: Optional[TensorParallel], sp: bool) -> torch.Tensor:
    """A block's row-parallel partial sums summed over tp: reduce-scattered
    along the sequence under SP, else all-reduced."""
    if tp is None:
        return y
    return tp_reduce_scatter(y, tp, 1) if sp else tp_reduce(y, tp)


# -- the collectives ----------------------------------------------------------------

def _all_reduce(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=tp.group)
    return x


def _all_gather(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x, group=tp.group)
    return torch.cat(parts, dim=dim)


def _split(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    return x.chunk(tp.size, dim)[tp.rank].contiguous()


def _reduce_scatter(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    parts = [c.contiguous() for c in x.chunk(tp.size, dim)]
    out = torch.empty_like(parts[tp.rank])
    dist.reduce_scatter(out, parts, group=tp.group)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.tp), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x, tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _all_gather(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _split(g, ctx.tp, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _split(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.tp, ctx.dim), None, None


class _GatherPartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _all_gather(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.tp, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _reduce_scatter(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.tp, ctx.dim), None, None


def tp_copy(x, tp: TensorParallel):
    """Forward the identity; backward the all-reduce of the peers' partial
    gradients (a replicated input of column-parallel products)."""
    return _Copy.apply(x, tp)


def tp_reduce(x, tp: TensorParallel):
    """Forward the all-reduce of partial sums; backward the identity."""
    return _Reduce.apply(x, tp)


def tp_gather(x, tp: TensorParallel, dim: int):
    """Forward the all-gather along ``dim`` into a replicated tensor; backward
    this rank's slice of its (replicated) gradient."""
    return _Gather.apply(x, tp, dim)


def tp_split(x, tp: TensorParallel, dim: int):
    """Forward this rank's slice along ``dim``; backward the all-gather."""
    return _Split.apply(x, tp, dim)


def tp_gather_partial(x, tp: TensorParallel, dim: int):
    """Forward the all-gather along ``dim``; backward the reduce-scatter of
    the peers' partial gradients."""
    return _GatherPartial.apply(x, tp, dim)


def tp_reduce_scatter(x, tp: TensorParallel, dim: int):
    """Forward the reduce-scatter of partial sums along ``dim``; backward the
    all-gather."""
    return _ReduceScatter.apply(x, tp, dim)
