"""Trainable-parameters-only checkpoints.

Counterpart of ``sparse_matrix_fine_tuning_tpu/training/checkpoint.py``: a
checkpoint is a directory ``checkpoint-<step>`` (or ``checkpoint-<tag>``)
with

  trainable.npz    the trainable parameters, keyed by path in the JAX
                   package's format (``model/layers/0/mlp/down_proj/
                   blkdiag1/value``; ``utils/jax_bridge.py``), so that either
                   package loads the other's;
  opt_state.npz    the optimizer's state in the port's own format, keyed by
                   parameter name (``training/optim.py``);
  rng_state.npz    the torch random number generators' states (dropout);
  meta.json        the step and the run's bookkeeping,

a ``log_history.json`` beside the checkpoints, a ``completed`` marker once
the run has finished, and at most ``save_total_limit`` numbered
checkpoints.  In a run of more than one process (``parallel/multihost.py``)
only rank 0 writes: the trainable state is replicated, so its checkpoint is
the run's; the others wait at a barrier until the write is done and return
the same path, and every rank passes a barrier before it reads one (JAX
checkpoint.py:88-96, :118-128).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np
import torch
from torch import nn

from sparse_matrix_fine_tuning_torch.parallel import multihost
from sparse_matrix_fine_tuning_torch.utils.jax_bridge import (
    read_jax_trainable,
    write_jax_trainable,
)
from sparse_matrix_fine_tuning_torch.utils.testing import to_numpy


def _save_arrays(path: str, arrays: dict) -> None:
    np.savez(path, **{k: to_numpy(torch.as_tensor(v)) for k, v in arrays.items()})


def _rng_arrays() -> dict:
    out = {"torch_cpu": torch.get_rng_state()}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i, state in enumerate(torch.cuda.get_rng_state_all()):
            out[f"torch_cuda/{i}"] = state
    return out


def _set_rng(arrays) -> None:
    torch.set_rng_state(torch.as_tensor(arrays["torch_cpu"], dtype=torch.uint8))
    cuda = sorted(k for k in arrays.files if k.startswith("torch_cuda/"))
    if cuda and torch.cuda.is_available():
        torch.cuda.set_rng_state_all(
            [torch.as_tensor(arrays[k], dtype=torch.uint8) for k in cuda])


def save(output_dir: str, step: int, model: nn.Module, optimizer, *,
         tag: Optional[str] = None, save_total_limit: int = 0,
         log_history: Optional[list] = None, final: bool = False,
         extra_meta: Optional[dict] = None) -> str:
    """Write one checkpoint of ``model``'s trainable parameters (those with
    ``requires_grad``) and of ``optimizer`` (a ``GroupedAdamW``); returns
    its path."""
    name = f"checkpoint-{tag}" if tag else f"checkpoint-{step}"
    path = os.path.join(output_dir, name)
    if not multihost.is_primary():
        multihost.barrier()  # released once rank 0 has written
        return path
    os.makedirs(path, exist_ok=True)
    write_jax_trainable(os.path.join(path, "trainable.npz"), model)
    _save_arrays(os.path.join(path, "opt_state.npz"), optimizer.state_arrays())
    _save_arrays(os.path.join(path, "rng_state.npz"), _rng_arrays())
    meta = {"step": step}
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f)
    if log_history is not None:
        with open(os.path.join(output_dir, "log_history.json"), "w") as f:
            json.dump(log_history, f, indent=1)
    if final:
        open(os.path.join(output_dir, "completed"), "w").close()
    if save_total_limit:
        _prune(output_dir, save_total_limit)
    multihost.barrier()
    return path


def _prune(output_dir: str, limit: int) -> None:
    if limit <= 0:
        return
    ckpts = []
    for d in os.listdir(output_dir):
        suffix = d[len("checkpoint-"):] if d.startswith("checkpoint-") else ""
        if suffix.isdigit():
            ckpts.append((int(suffix), d))
    ckpts.sort()
    for _, d in ckpts[:-limit]:
        shutil.rmtree(os.path.join(output_dir, d), ignore_errors=True)


def load(path: str, model: nn.Module, optimizer=None) -> dict:
    """Restore a checkpoint into ``model`` (every trainable parameter must be
    in it) and ``optimizer`` where given; returns its meta."""
    multihost.barrier()  # no rank reads a checkpoint still being written
    read_jax_trainable(os.path.join(path, "trainable.npz"), model, strict=True)
    opt_path = os.path.join(path, "opt_state.npz")
    if optimizer is not None and os.path.exists(opt_path):
        with np.load(opt_path, allow_pickle=False) as data:
            optimizer.load_state_arrays({k: data[k] for k in data.files})
    rng_path = os.path.join(path, "rng_state.npz")
    if os.path.exists(rng_path):
        with np.load(rng_path, allow_pickle=False) as data:
            _set_rng(data)
    meta_path = os.path.join(path, "meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def get_last_checkpoint(output_dir: str, *, even_if_completed: bool = False):
    """(path of the last numbered checkpoint or None, completed)."""
    if not os.path.isdir(output_dir):
        return None, False
    completed = os.path.exists(os.path.join(output_dir, "completed"))
    if completed and not even_if_completed:
        return None, True
    max_step, best = 0, None
    for d in os.listdir(output_dir):
        if d.startswith("checkpoint-") and d[len("checkpoint-"):].isdigit():
            s = int(d[len("checkpoint-"):])
            if s > max_step:
                max_step, best = s, os.path.join(output_dir, d)
    return best, completed
