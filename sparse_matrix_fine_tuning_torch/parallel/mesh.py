"""Device mesh construction.

Counterpart of ``sparse_matrix_fine_tuning_tpu/parallel/mesh.py``: a
("dp", "fsdp", "tp") mesh, here a ``torch.distributed`` ``DeviceMesh`` over
the ranks of the process group (``multihost.initialize``), one rank a
device.  The frozen base is FSDP2-sharded over "fsdp", Megatron
tensor-parallel over "tp" (column-parallel q/k/v/gate/up and lm_head,
row-parallel o/down: ``sharding.py``), and batches are split over ("dp",
"fsdp") by data rank (``multihost.py``).  The ranks are laid out row-major,
so a rank's tp peers are neighbours.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sparse_matrix_fine_tuning_torch.parallel.multihost import resolve_device_type

AXES = ("dp", "fsdp", "tp")


def mesh_shape(n: int, dp: Optional[int] = None, fsdp: Optional[int] = None,
               tp: Optional[int] = None) -> tuple[int, int, int]:
    """(dp, fsdp, tp) of a mesh over ``n`` devices, with the JAX
    ``make_mesh``'s defaults and assertions: tp 1 unless given; with neither
    dp nor fsdp given, every device left goes to fsdp; one of them given, the
    other takes the rest."""
    if tp is None:
        tp = 1
    rest = n // tp
    assert tp * rest == n, f"tp({tp}) does not divide devices({n})"
    if dp is None and fsdp is None:
        dp, fsdp = 1, rest
    elif dp is None:
        dp = rest // fsdp
    elif fsdp is None:
        fsdp = rest // dp
    assert dp * fsdp * tp == n, \
        f"dp({dp}) * fsdp({fsdp}) * tp({tp}) != devices({n})"
    return dp, fsdp, tp


def make_mesh(dp: Optional[int] = None, fsdp: Optional[int] = None,
              tp: Optional[int] = None, devices: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """Create a ("dp", "fsdp", "tp") ``DeviceMesh``.

    ``devices``: the ranks to lay out (every rank of the world when None);
    the process group must be joined (``multihost.initialize``).
    ``device_type``: "cuda" unless the caller asks for "cpu".  Defaults: all
    devices on the fsdp axis (pure FSDP, tp = 1), as the JAX ``make_mesh``.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "parallel.multihost.initialize() first")
    device_type = resolve_device_type(device_type)
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    shape = mesh_shape(len(ranks), dp, fsdp, tp)
    layout = torch.tensor(ranks, dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, layout, mesh_dim_names=AXES)
