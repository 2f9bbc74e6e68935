"""Multi-process training: the process group, the data ranks and the
per-process batch contract.

Counterpart of ``sparse_matrix_fine_tuning_tpu/parallel/multihost.py``.  One
JAX process drives every device of its host and a global mesh spans the
processes; in PyTorch each device is a process of its own, so every mesh of
the port starts here, from ``torch.distributed``'s process group:

* :func:`initialize` joins the group (idempotent).  It reads the torchrun
  variables ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
  ``LOCAL_RANK``, or takes them as arguments, as the JAX ``initialize``
  reads its coordinator's.  On the card it joins NCCL with ``cuda:LOCAL_RANK``;
  gloo only where the caller asks for the CPU (``device_type="cpu"``, the
  tests' worlds).  Without a card and without that request it raises: there
  is no fallback.
* :func:`shard_data_for_process` gives this process its contiguous rows of a
  host-resident dataset, in both remainder modes of the JAX function.
* :func:`global_batch` gathers the per-process rows of a batch back into
  the global batch (the JAX function's global arrays, as numpy).
* :func:`is_primary` guards filesystem side effects (checkpoints, results,
  logs) to rank 0.

The split is by *data rank*.  A JAX process spans its tensor-parallel
devices, so the JAX function splits rows by process; a torch process is one
tp peer, and the tp peers of a data rank hold the same rows.  A rank's data
rank is its index over the mesh's ("dp", "fsdp") axes (:func:`data_coords`):
with tp = 1 it is the rank itself and the split is the JAX one.

Contract with the Trainer (JAX multihost.py:30-34): under a mesh, construct
the Trainer with this rank's rows and the per-rank batch size; the global
micro-batch is ``per_device_train_batch_size`` times the data ranks, and the
step counts and epoch boundaries agree with the single-process view because
the data and the batches shrink by the same factor.

The trainer's reductions over ranks (``Trainer``, ``training/checkpoint.py``)
are here too: :func:`barrier`, :func:`all_max`, :func:`agree` (rank 0's view
broadcast and compared) and :func:`loss_denominator`, with its scope
:func:`data_parallel_loss`, which makes a loss normalised on one rank's rows
average over the data ranks to the global mean, as the JAX mesh computes it.
"""

from __future__ import annotations

import contextlib
import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_rank: Optional[int] = None,
               device_type: Optional[str] = None) -> None:
    """Join (or create) the process group.  Idempotent.

    ``coordinator_address`` is "host:port" (default ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``num_processes`` the world size (``WORLD_SIZE``, 1
    when unset), ``process_id`` this rank (``RANK``, 0 when unset) and
    ``local_rank`` this rank's card on its host (``LOCAL_RANK``, default
    ``process_id``).  ``device_type`` None or "cuda": NCCL on
    ``cuda:local_rank``, which must exist; "cpu": gloo.
    """
    if dist.is_available() and dist.is_initialized():
        return
    device_type = resolve_device_type(device_type)
    env = os.environ
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    addr = coordinator_address or (f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                                   f"{env.get('MASTER_PORT', '29500')}")
    if device_type == "cuda":
        torch.cuda.set_device(local_rank)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=world, rank=rank)


def resolve_device_type(device_type: Optional[str] = None) -> str:
    """"cuda" unless the caller asks for "cpu"; "cuda" needs a card."""
    device_type = device_type or "cuda"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a mesh runs on the card unless the caller asks for "
                           "the CPU (device_type='cpu', gloo)")
    return device_type


def shutdown() -> None:
    """Leave the process group, where one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns filesystem side effects (rank 0)."""
    return process_index() == 0


def data_coords(coord: Sequence[int], shape: Sequence[int]) -> tuple[int, int]:
    """(data ranks, data rank) of the rank at ``coord`` (dp, fsdp, tp) on a
    mesh of ``shape``: its index over (dp, fsdp), which its tp peers share."""
    d, f, _ = coord
    dp, fsdp, _ = shape
    return dp * fsdp, d * fsdp + f


def split_rows(data: Mapping[str, np.ndarray], parts: int, part: int, *,
               drop_remainder: bool = True) -> dict:
    """Part ``part`` of ``parts`` contiguous equal parts of a dict-of-arrays
    dataset (the JAX ``shard_data_for_process`` with ``parts`` processes).

    Every part has the same number of rows.  With ``drop_remainder`` that is
    ``n // parts`` (at most ``parts - 1`` tail rows dropped); without, it is
    ``ceil(n / parts)`` and the last part's short tail repeats the dataset's
    last row."""
    if parts == 1:
        return dict(data)
    n = min(len(v) for v in data.values())
    if drop_remainder:
        per = n // parts
        lo = part * per
        return {k: v[lo:lo + per] for k, v in data.items()}
    per = -(-n // parts)
    lo, hi = part * per, min((part + 1) * per, n)
    pad = per - (hi - lo)
    out = {}
    for k, v in data.items():
        shard = v[lo:hi]
        if pad:
            shard = np.concatenate([shard, np.repeat(v[-1:], pad, axis=0)])
        out[k] = shard
    return out


def data_rank(mesh=None) -> tuple[int, int]:
    """(data ranks, this rank's data rank): over the mesh's ("dp", "fsdp")
    axes, or every process of the world when ``mesh`` is None (tp = 1)."""
    if mesh is None:
        return process_count(), process_index()
    return data_coords([int(c) for c in mesh.get_coordinate()],
                       [int(n) for n in mesh.mesh.shape])


def shard_data_for_process(data: Mapping[str, np.ndarray], *, drop_remainder: bool = True,
                           mesh=None) -> dict:
    """This rank's contiguous rows of a dataset: ``split_rows`` by data rank
    (see the module docstring)."""
    parts, part = data_rank(mesh)
    return split_rows(data, parts, part, drop_remainder=drop_remainder)


def global_batch(batch: Mapping[str, np.ndarray], mesh, *, macro: bool = False) -> dict:
    """The global batch of which ``batch`` holds this rank's rows: every data
    rank's rows in data-rank order along the batch axis (axis 1 for
    ``macro``, gradient-accumulation batches (accum, local_bs, ...)), as the
    JAX function's global arrays; numpy, on every rank.  A collective."""
    _, part = data_rank(mesh)
    gathered = [None] * process_count()
    dist.all_gather_object(gathered, (part, mesh.get_coordinate()[-1],
                                      {k: np.asarray(v) for k, v in batch.items()}))
    # one tp peer of each data rank, in data-rank order
    rows = [r for _, t, r in sorted(gathered, key=lambda g: g[0]) if t == 0]
    axis = 1 if macro else 0
    return {k: np.concatenate([r[k] for r in rows], axis=axis) for k in batch}


def barrier() -> None:
    """Wait for every rank (a no-op in a one-process run)."""
    if process_count() > 1:
        dist.barrier()


def all_max(value: int) -> int:
    """The largest ``value`` over the ranks (the JAX trainer's
    ``process_allgather`` max)."""
    if process_count() == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def agree(values: Sequence[int]) -> tuple[list[int], list[int], bool]:
    """(this rank's ``values``, rank 0's, whether any rank's differ from rank
    0's): rank 0's broadcast to all and the verdict reduced over the world,
    so that every rank takes the same branch on it."""
    local = [int(v) for v in values]
    if process_count() == 1:
        return local, list(local), False
    dev = _collective_device()
    t = torch.tensor(local, dtype=torch.int64, device=dev)
    dist.broadcast(t, src=0)
    root = [int(v) for v in t.tolist()]
    differ = torch.tensor([int(root != local)], dtype=torch.int64, device=dev)
    dist.all_reduce(differ, op=dist.ReduceOp.MAX)
    return local, root, bool(differ.item())


def _collective_device() -> torch.device:
    """Where a collective's tensors live: the current card under NCCL."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


# -- the loss under data parallelism -------------------------------------------------

_LOSS = {"mesh": None}


@contextlib.contextmanager
def data_parallel_loss(mesh):
    """Scope in which ``loss_denominator`` normalises by the global count of
    ``mesh``'s data ranks (the Trainer enters it around its steps and its
    evaluation under a mesh; None leaves the losses local)."""
    prev = _LOSS["mesh"]
    _LOSS["mesh"] = mesh
    try:
        yield
    finally:
        _LOSS["mesh"] = prev


def loss_denominator(count: torch.Tensor) -> torch.Tensor:
    """The denominator of a mean loss over ``count`` positions on this rank's
    rows: ``count`` (at least 1) outside ``data_parallel_loss``; inside it,
    the count over every data rank divided by their number, so that the mean
    of the ranks' losses is the mean over the global batch and the mean of
    their gradients its gradient (the JAX mesh's loss over the global
    batch).  Counting is a collective over the world: tp peers count the
    same rows."""
    mesh = _LOSS["mesh"]
    if mesh is None:
        return count.clamp_min(1.0)
    parts, _ = data_rank(mesh)
    tp = int(mesh.mesh.shape[-1])
    total = count.detach().float().clone()
    dist.all_reduce(total)
    return (total / tp).clamp_min(1.0) / parts
