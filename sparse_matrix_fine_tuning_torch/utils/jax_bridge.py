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

A quantized base (``quant/``) loads into a port model quantized the same
way first (``quantize_frozen_base`` with the same bits and group,
``quantize_lm_head``): ``dense`` int8 (in, out) or uint8 (in/2, out) codes,
``dense_scales`` f32, ``lm_head/kernel_q`` (in, vocab) int8 and
``lm_head/scales`` (1, vocab) f32 are copied bit for bit, untransposed, into
the parameter or persistent buffer of the same name.

Every path must find a parameter or persistent buffer of the matching
shape, and every one of the port's must be given, or it raises.  Float
values take the dtype of the port's tensor; integer codes must have its
dtype exactly.

``write_jax_trainable`` and ``read_jax_trainable`` write and read a JAX
``trainable.npz`` (``training/checkpoint.py`` of either package): the
trainable parameters keyed by their JAX path joined with "/" plus
``/value``, e.g. ``model/layers/0/mlp/down_proj/blkdiag1/value`` or
``lm_head/kernel/value`` (transposed).  bfloat16 parameters are written as
float32, which the JAX loader casts back exactly.

This module needs numpy only, never JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_RENAMED = {"kernel": "weight", "embedding": "weight", "scale": "weight"}
_VALUE = "/value"


def _port_name(path: tuple) -> tuple[str, bool]:
    """(dotted port name, whether to transpose)."""
    *head, leaf = (str(p) for p in path)
    return ".".join([*head, _RENAMED.get(leaf, leaf)]), leaf == "kernel"


@torch.no_grad()
def load_jax_state(model: nn.Module, flat: Mapping[tuple, np.ndarray]) -> None:
    params = model.state_dict(keep_vars=True)  # parameters and persistent buffers
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
        value = torch.from_numpy(np.ascontiguousarray(arr))
        if not (value.is_floating_point() and param.is_floating_point()) \
                and value.dtype != param.dtype:
            raise ValueError(f"{path}: {value.dtype} codes do not fit {name} ({param.dtype}); "
                             "quantize the port model as the JAX one first")
        param.copy_(value.to(param.dtype))
        seen.add(name)
    missing = sorted(set(params) - seen)
    if missing:
        raise KeyError(f"port parameters or buffers not given by the JAX state: {missing}")


def _as_float_array(arr: np.ndarray) -> np.ndarray:
    """numpy array of a JAX parameter, with bfloat16 read as float32."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:  # bfloat16 bits, no ml_dtypes
        bits = arr.view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)
    if arr.dtype.name == "bfloat16":
        return arr.astype(np.float32)
    return arr


def _jax_key(model: nn.Module, name: str) -> tuple[str, bool]:
    """(JAX trainable.npz key, whether to transpose) of a port parameter."""
    *head, leaf = name.split(".")
    owner = model.get_submodule(".".join(head)) if head else model
    if leaf == "weight":
        if isinstance(owner, nn.Linear):
            leaf = "kernel"
        elif isinstance(owner, nn.Embedding):
            leaf = "embedding"
        else:  # RMSNorm, LayerNorm
            leaf = "scale"
    return "/".join([*head, leaf]) + _VALUE, leaf == "kernel"


def write_jax_trainable(path: str, model: nn.Module) -> list[str]:
    """Write the parameters with ``requires_grad`` as a JAX ``trainable.npz``;
    returns the keys written."""
    arrays = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        key, transpose = _jax_key(model, name)
        arr = p.detach().float().cpu().numpy() if p.dtype == torch.bfloat16 \
            else p.detach().cpu().numpy()
        arrays[key] = np.array(arr.T if transpose else arr, copy=True)
    np.savez(path, **arrays)
    return sorted(arrays)


@torch.no_grad()
def read_jax_trainable(path: str, model: nn.Module, *, strict: bool = True) -> list[str]:
    """Copy a JAX ``trainable.npz`` into the port's parameters of the same
    names.  Every key must find a parameter of the matching shape; with
    ``strict``, every parameter with ``requires_grad`` must be given.
    Returns the port names loaded."""
    params = dict(model.named_parameters())
    loaded = []
    with np.load(path, allow_pickle=False) as data:
        for key in data.files:
            if not key.endswith(_VALUE):
                raise KeyError(f"{path}: {key!r} is not a JAX parameter path")
            name, transpose = _port_name(tuple(key[:-len(_VALUE)].split("/")))
            if name not in params:
                raise KeyError(f"{path}: {key!r} has no port parameter {name!r}")
            arr = _as_float_array(np.array(data[key], copy=True))
            if transpose:
                arr = arr.T
            param = params[name]
            if tuple(arr.shape) != tuple(param.shape):
                raise ValueError(f"{path}: {key!r} has shape {arr.shape}, "
                                 f"{name} {tuple(param.shape)}")
            param.copy_(torch.from_numpy(np.ascontiguousarray(arr)).to(param.dtype))
            loaded.append(name)
    if strict:
        missing = sorted(n for n, p in params.items() if p.requires_grad and n not in loaded)
        if missing:
            raise KeyError(f"{path} is missing trainable parameters: {missing}")
    return sorted(loaded)
