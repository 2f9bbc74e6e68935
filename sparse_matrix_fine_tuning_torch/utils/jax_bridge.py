"""Carry the JAX model's parameters into the port's module of the same shape.

``load_jax_state(model, flat)`` takes ``{path_tuple: np.ndarray}``, with
paths as the JAX package's NNX state names them, e.g.
``('model', 'layers', 0, 'mlp', 'down_proj', 'blkdiag1')``, and copies each
array into the port's parameter of the same dotted name.  Where the layouts
differ:

  ``nnx.Linear.kernel`` (in, out)   -> ``nn.Linear.weight`` (out, in), transposed
  ``nnx.Embed.embedding``           -> ``nn.Embedding.weight``
  norm ``scale``                    -> norm ``weight``
  ``MonarchLinear`` ``dense`` (out, in), ``blkdiag1``, ``blkdiag2``, ``bias``,
  ``blkdiag_mult``, Scaler ``scaler``  -> the same names, as they are

Every path must find a parameter of the matching shape, and every
parameter of the port must be given, or it raises.  Values take the dtype
of the port's parameter.  This module needs numpy only, never JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_RENAMED = {"kernel": "weight", "embedding": "weight", "scale": "weight"}


def _port_name(path: tuple) -> tuple[str, bool]:
    """(dotted port name, whether to transpose)."""
    *head, leaf = (str(p) for p in path)
    return ".".join([*head, _RENAMED.get(leaf, leaf)]), leaf == "kernel"


@torch.no_grad()
def load_jax_state(model: nn.Module, flat: Mapping[tuple, np.ndarray]) -> None:
    params = dict(model.named_parameters())
    seen = set()
    for path, value in flat.items():
        name, transpose = _port_name(tuple(path))
        if name not in params:
            raise KeyError(f"JAX parameter {path} has no port parameter {name!r}")
        arr = np.array(value, copy=True)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)  # exact; numpy has no bfloat16 for torch
        if transpose:
            arr = arr.T
        param = params[name]
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{path}: shape {arr.shape} does not fit {name} {tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(param.dtype))
        seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"port parameters not given by the JAX state: {missing}")
