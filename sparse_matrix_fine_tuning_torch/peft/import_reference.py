"""Adapter checkpoints in the reference's format, in and out.

Counterpart of ``sparse_matrix_fine_tuning_tpu/peft/import_reference.py``.
The reference's trainers save only the trainable parameters
(``MyAwesomeTrainer.save_model`` filters ``requires_grad``, reference
train_utils.py:297-307): the Monarch factors (``blkdiag1``, ``blkdiag2``,
``blkdiag_mult``), the Scaler's parameters and the task head, under the HF
torch modules' paths.  The port's modules carry those names and layouts
already (factors ``(nblocks, blk_r, in_blksz)`` and ``(nblocks,
out_blksz, blk_r)``, ``nn.Linear`` heads (out, in), the Scaler's
``scaler.scaler`` and ``scaler.norm.{weight,bias}``); only the encoders'
layer stacks sit one level higher: HF's ``roberta.encoder.layer.N`` and
``deberta.encoder.layer.N`` are the port's ``roberta.layer.N`` and
``deberta.layer.N``.  ``export_reference_adapters`` gives what the JAX
package's does, key for key and value for value.

Caveat carried over from the reference (qlora_monarch.py:828-833): a
checkpoint written after ``model.eval()`` holds the adapter merged into the
(unsaved) dense weights while the saved factors are the unmerged ones, so
reloading is exact only for checkpoints saved in train mode, as in the
reference.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch
from torch import nn

from sparse_matrix_fine_tuning_torch.models.hf_convert import load_state_dict, write_safetensors
from sparse_matrix_fine_tuning_torch.peft.surgery import DEFAULT_TRAINABLE_PATHS, _trainable_names

__all__ = ["load_reference_adapters", "export_reference_adapters", "save_reference_adapters"]

_ENCODERS = ("roberta", "deberta")


def port_name(key: str) -> str:
    """The port's parameter name of a reference key."""
    key = key.removeprefix("module.")
    for enc in _ENCODERS:
        key = key.replace(f"{enc}.encoder.layer.", f"{enc}.layer.")
    return key


def reference_name(name: str) -> str:
    """The reference's key of a port parameter name."""
    for enc in _ENCODERS:
        if name.startswith(f"{enc}.layer."):
            return f"{enc}.encoder.{name[len(enc) + 1:]}"
    return name


@torch.no_grad()
def load_reference_adapters(model: nn.Module, state_dict, *,
                            strict: bool = True) -> tuple[list[str], list[str]]:
    """Load a reference trainable-only checkpoint into a model adapted with
    the same ``peft_config`` (``peft/surgery.init_monarch``).

    state_dict: {key: tensor or ndarray}, or a ``.bin`` / ``.safetensors``
    path.  strict: raise on a key that names no parameter of the model
    (False: skip it).  A shape that does not fit raises either way.
    Returns (loaded keys, skipped keys)."""
    if isinstance(state_dict, str):
        state_dict = load_state_dict(state_dict)
    params = dict(model.named_parameters())
    loaded, skipped = [], []
    for key, value in state_dict.items():
        name = port_name(key)
        if name not in params:
            if strict:
                raise KeyError(f"cannot import {key!r}: the model has no parameter {name!r}.  "
                               "Pass strict=False to skip unplaceable keys.")
            skipped.append(key)
            continue
        value = torch.as_tensor(np.asarray(value) if not torch.is_tensor(value) else value)
        param = params[name]
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(
                f"shape mismatch for {key!r}: checkpoint {tuple(value.shape)} vs model "
                f"{tuple(param.shape)} -- was the model adapted with the same peft_config "
                "(nblocks/blk_r/target_modules)?")
        param.copy_(value.to(param.dtype))
        loaded.append(key)
    return loaded, skipped


def export_reference_adapters(model: nn.Module,
                              extra_paths: Optional[Iterable[str]] = None
                              ) -> Dict[str, np.ndarray]:
    """The trainable state (``peft/surgery.trainable_filter``'s selection:
    the adapters and ``extra_paths``, the heads by default) under the
    reference's keys, as float32 numpy arrays (bfloat16 widened)."""
    names = _trainable_names(model, tuple(extra_paths) if extra_paths is not None
                             else DEFAULT_TRAINABLE_PATHS)
    return {reference_name(n): p.detach().float().cpu().numpy().copy()
            if p.dtype == torch.bfloat16 else p.detach().cpu().numpy().copy()
            for n, p in model.named_parameters() if n in names}


def save_reference_adapters(model: nn.Module, path: str, extra_paths=None) -> None:
    """``export_reference_adapters`` as a torch ``.bin``, or a
    ``.safetensors`` file where the path says so, that the reference loads."""
    sd = {k: torch.from_numpy(v) for k, v in export_reference_adapters(model, extra_paths).items()}
    if path.endswith(".safetensors"):
        write_safetensors(path, sd)
    else:
        torch.save(sd, path)
