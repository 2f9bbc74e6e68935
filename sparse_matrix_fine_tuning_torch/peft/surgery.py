"""Model surgery: put Monarch adapters on a model's linears, in place.

Counterpart of ``sparse_matrix_fine_tuning_tpu/peft/surgery.py`` (the
Monarch part): ``init_monarch`` replaces every ``nn.Linear`` child whose
attribute name is in ``peft_config["target_modules"]`` with a
``MonarchLinear`` built on its weights, which become the frozen base.

Training: ``trainable_filter`` is the JAX filter as ``requires_grad``: the
adapter parameters (a ``MonarchLinear``'s factors, multiplicative factor
and Scaler) and every parameter under one of the extra paths train, and
everything else is frozen.  ``enable_merged_training``, ``refresh_merged``
and ``disable_merged_training`` act on every eligible adapter (quantized
layers are not: their codes cannot absorb the adapter).

A quantized base (``quant/``): the codes are integer parameters and never
train, whatever the extra paths (the JAX package's ``"lm_head"`` path
would take ``Int8LMHead``'s codes; here they are buffers); the scales are
buffers.  ``param_stats`` counts the codes and the scales in the total, as
the JAX package counts every variable of its state.
"""

from __future__ import annotations

import math
from typing import Iterable, Iterator, Optional

import torch
from torch import nn

from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear

# Paths that train alongside the adapters (classification and LM heads).
DEFAULT_TRAINABLE_PATHS = ("classifier", "score", "pooler", "lm_head")


def _sqrt_factor(n: int) -> int:
    """The factor of n closest below sqrt(n)."""
    return [i for i in range(1, math.floor(math.sqrt(n)) + 1) if n % i == 0][-1]


def _iter_parents(module: nn.Module) -> Iterator[tuple[nn.Module, str, nn.Module]]:
    """(parent, attribute name, child) over the module tree, depth first."""
    for name, child in module.named_children():
        yield module, name, child
        yield from _iter_parents(child)


def init_monarch(model: nn.Module, peft_config: dict, *,
                 generator: Optional[torch.Generator] = None, dtype=None,
                 param_dtype=torch.float32) -> list[tuple[str, tuple, tuple, tuple]]:
    """Replace the target linears with Monarch adapters, in place.

    Args:
      peft_config: reference-format dict: ``monarch``, ``target_modules``,
        ``nblocks`` (an int or "sqrt(n)"), ``blk_r``, ``adapter``, ...
      generator: ``torch.Generator`` on the model's device for the factors'
        init; a fresh one seeded with 0 when None.
    Returns:
      (name, dense_shape, blkdiag1_shape, blkdiag2_shape) per adapted layer.
    """
    if not peft_config.get("monarch", True):
        return []
    targets = set(peft_config["target_modules"])
    cfg_nblocks = peft_config.get("nblocks", 4)
    adapted = []
    for parent, name, child in list(_iter_parents(model)):
        if name not in targets or not isinstance(child, nn.Linear):
            continue
        w = child.weight.detach()  # (out, in)
        out_f, in_f = w.shape
        if generator is None:
            generator = torch.Generator(device=w.device).manual_seed(0)
        if peft_config.get("adapter", True) and cfg_nblocks != "sqrt(n)":
            nblocks = cfg_nblocks
        else:
            nblocks = _sqrt_factor(in_f)
        layer = MonarchLinear(
            in_f, out_f, peft_config=peft_config, weights=w,
            bias=child.bias.detach() if child.bias is not None else None,
            nblocks=nblocks, dtype=dtype, param_dtype=param_dtype, device=w.device,
            generator=generator)
        setattr(parent, name, layer)
        adapted.append((name, (out_f, in_f), tuple(layer.blkdiag1.shape),
                        tuple(layer.blkdiag2.shape)))
    return adapted


# A MonarchLinear's frozen parameters; all its others are adapter parameters.
_FROZEN_IN_ADAPTER = ("dense", "bias")


def _trainable_names(model: nn.Module, extra_paths: Iterable[str]) -> set[str]:
    """Adapter parameters and every parameter with one of ``extra_paths`` as
    a component of its name (the JAX ``nnx.PathContains``); every parameter
    for ``"__all__"``."""
    extra = tuple(extra_paths)
    floats = {name for name, p in model.named_parameters() if p.is_floating_point()}
    if "__all__" in extra:
        return floats
    names = set()
    for prefix, module in model.named_modules():
        if isinstance(module, MonarchLinear):
            for pname, _ in module.named_parameters():
                if pname not in _FROZEN_IN_ADAPTER:
                    names.add(f"{prefix}.{pname}" if prefix else pname)
    for name in floats:
        if any(e in name.split(".") for e in extra):
            names.add(name)
    return names & floats


def trainable_filter(model: nn.Module,
                     extra_paths: Iterable[str] = DEFAULT_TRAINABLE_PATHS) -> list[str]:
    """Set ``requires_grad`` on the trainable parameters (adapters and
    ``extra_paths``) and clear it on every other; returns their names,
    sorted."""
    names = _trainable_names(model, extra_paths)
    for name, p in model.named_parameters():
        p.requires_grad_(name in names)
    return sorted(names)


def param_stats(model: nn.Module, *, training: bool = True,
                extra_paths: Iterable[str] = DEFAULT_TRAINABLE_PATHS,
                skip_cls: bool = True, verbose: bool = True) -> tuple[int, int]:
    """(total, trainable) parameter counts, the total over the parameters
    and the persistent buffers (a quantized base's scales); trainable > 0 is
    required when ``training``."""
    trainable = _trainable_names(model, extra_paths)
    n_total = sum(t.numel() for t in model.state_dict().values())
    n_train = 0
    for name, p in model.named_parameters():
        if name in trainable and not (skip_cls and "classifier" in name):
            n_train += p.numel()
    if verbose:
        pct = 100 * n_train / max(n_total, 1)
        print(f"Total parameters: {n_total / 1024**2:.3f}M, "
              f"trainable: {n_train / 1024**2:.3f}M ({pct:.3f}%)")
    if training and n_train == 0:
        raise ValueError("There's a bug: you're training nothing!")
    return n_total, n_train


def merge_all_adapters(model: nn.Module) -> int:
    """Fold every MonarchLinear adapter into its dense weights (inference).
    Raises on a quantized base (``MonarchLinear._check_mergeable``); its
    serving merge is ``quant.requantize_merge_adapters``."""
    n = 0
    for module in model.modules():
        if isinstance(module, MonarchLinear) and module.as_adapter and not module.merged:
            module.merge_adapter()
            n += 1
    return n


def unmerge_all_adapters(model: nn.Module) -> int:
    n = 0
    for module in model.modules():
        if isinstance(module, MonarchLinear) and module.as_adapter and module.merged:
            module.unmerge_adapter()
            n += 1
    return n


def find_all_linear_names(model: nn.Module, exclude: tuple = ("lm_head",)) -> list[str]:
    """Attribute names of all ``nn.Linear`` layers, for extending
    ``target_modules`` to every linear."""
    names = {name for _, name, child in _iter_parents(model) if isinstance(child, nn.Linear)}
    return sorted(names - set(exclude))


def enable_merged_training(model: nn.Module, min_dim: int = 0) -> int:
    """Enable merge-during-training (``kernels/merged.py``) on every eligible
    MonarchLinear with min(in, out) >= ``min_dim``; returns how many."""
    count = 0
    for module in model.modules():
        if (isinstance(module, MonarchLinear) and module.can_merge_train()
                and min(module.in_features, module.out_features) >= min_dim):
            module.enable_merged_training()
            count += 1
    return count


def refresh_merged(model: nn.Module) -> int:
    """Rebuild every merged-training operand from the current factors."""
    count = 0
    for module in model.modules():
        if isinstance(module, MonarchLinear) and module.wm_cache is not None:
            module.refresh_merged()
            count += 1
    return count


def disable_merged_training(model: nn.Module) -> int:
    count = 0
    for module in model.modules():
        if isinstance(module, MonarchLinear) and module.wm_cache is not None:
            module.disable_merged_training()
            count += 1
    return count
