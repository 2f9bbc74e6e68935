"""Optimizer: AdamW over three parameter groups, clipping by global norm.

Counterpart of ``sparse_matrix_fine_tuning_tpu/training/optim.py``:
  "decay":    the base learning rate, weight decay;
  "no_decay": the base learning rate, no decay (biases and norms);
  "large_lr": ``new_lr`` for ``blkdiag2``/``blkdiag_mult`` (or ``scaler``
              with a Scaler), no decay with a Scaler.
The schedules are those of optax as the JAX package builds them (linear
warmup, then constant, linear or cosine decay), evaluated at the number of
updates made so far.  Clipping follows ``optax.clip_by_global_norm``: the
gradients are scaled by ``max_norm / norm`` when the global norm is at
least ``max_norm`` (``torch.nn.utils.clip_grad_norm_`` would add 1e-6).
``optim="adamw"`` takes ``torch.optim.AdamW``, which decays with the
parameter's value before the step as ``optax.adamw`` does;
``optim="adamw8bit"`` takes ``training/adam8bit.AdamW8bit`` (8-bit moments)
over the same three groups, as the JAX package's ``adamw8bit`` in each
group's place.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping, Optional

import torch

from sparse_matrix_fine_tuning_torch.training.adam8bit import AdamW8bit

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    def f(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps if steps > 0 else 0.0
        return (init - end) * frac + end
    return f


def _cosine(init: float, steps: int) -> Schedule:
    def f(count: int) -> float:
        count = min(max(count, 0), steps)
        return init * 0.5 * (1.0 + math.cos(math.pi * count / steps))
    return f


def _join(first: Schedule, then: Schedule, boundary: int) -> Schedule:
    return lambda count: first(count) if count < boundary else then(count - boundary)


def build_schedule(lr: float, total_steps: int, warmup_ratio: float = 0.06,
                   kind: str = "linear") -> Schedule:
    """Warmup then decay: a function of the update count."""
    warmup = max(int(total_steps * warmup_ratio), 0)
    if kind == "constant":
        if warmup == 0:
            return lambda count: lr
        return _join(_linear(0.0, lr, warmup), lambda count: lr, warmup)
    decay_steps = max(total_steps - warmup, 1)
    if kind == "cosine":
        decay = _cosine(lr, decay_steps)
    elif kind == "linear":
        decay = _linear(lr, 0.0, decay_steps)
    else:
        raise ValueError(f"unknown schedule {kind}")
    if warmup == 0:
        return decay
    return _join(_linear(0.0, lr, warmup), decay, warmup)


_NO_DECAY_MARKERS = ("bias", "layernorm", "layer_norm", "norm", "scale")


def param_group_label(name: str, *, use_scaler: bool = False) -> str:
    """Group label of one parameter, by its (dotted) name."""
    p = name.lower()
    large = ("scaler",) if use_scaler else ("blkdiag2", "blkdiag_mult")
    if any(m in p for m in large):
        return "large_lr"
    if any(m in p for m in _NO_DECAY_MARKERS):
        return "no_decay"
    return "decay"


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by ``max_norm / norm`` when their global
    norm is at least ``max_norm``; returns the norm (fp32)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return norm


class GroupedAdamW:
    """The 3-group AdamW (or 8-bit AdamW) with its schedules and
    global-norm clipping.

    ``step()`` clips the ``.grad`` of every parameter, sets each group's
    learning rate from its schedule at the current update count, and takes
    one AdamW step.  ``state_arrays``/``load_state_arrays`` give the state
    as flat arrays keyed by parameter name (``training/checkpoint.py``).
    ``jax_paths``: {name: JAX state path} (``adam8bit.jax_paths``), which
    the 8-bit optimizer's fp32 predicate tests; the names with "/" for "."
    where None.
    """

    def __init__(self, named_params: Iterable[tuple[str, torch.Tensor]], *,
                 learning_rate: float, total_steps: int, warmup_ratio: float = 0.06,
                 lr_scheduler_type: str = "linear", weight_decay: float = 0.0,
                 large_lr: bool = False, new_lr: float = 5e-3, use_scaler: bool = False,
                 adam_b1: float = 0.9, adam_b2: float = 0.999, adam_eps: float = 1e-8,
                 max_grad_norm: Optional[float] = 1.0, optim: str = "adamw",
                 jax_paths: Optional[Mapping[str, str]] = None):
        if optim not in ("adamw", "adamw8bit"):
            raise ValueError(f"unknown optim {optim!r} (adamw | adamw8bit)")
        sched = build_schedule(learning_rate, total_steps, warmup_ratio, lr_scheduler_type)
        if large_lr:
            big_sched = build_schedule(new_lr, total_steps, warmup_ratio, lr_scheduler_type)
            big_wd = 0.0 if use_scaler else weight_decay
        else:
            big_sched, big_wd = sched, weight_decay
        self.schedules = {"decay": sched, "no_decay": sched, "large_lr": big_sched}
        decays = {"decay": weight_decay, "no_decay": 0.0, "large_lr": big_wd}
        members: dict[str, list] = {"decay": [], "no_decay": [], "large_lr": []}
        self.named_params = list(named_params)
        for name, p in self.named_params:
            members[param_group_label(name, use_scaler=use_scaler)].append(name)
        params = dict(self.named_params)
        groups = [{"params": [params[n] for n in names], "weight_decay": decays[label], "lr": 0.0,
                   "label": label} for label, names in members.items() if names]
        self.params = [p for g in groups for p in g["params"]]
        self.max_grad_norm = max_grad_norm
        betas = (adam_b1, adam_b2)
        if optim == "adamw8bit":
            paths = jax_paths or {}
            for group, names in zip(groups, [n for n in members.values() if n]):
                group["paths"] = [paths.get(n, n.replace(".", "/").lower()) for n in names]
            self.opt = AdamW8bit(groups, lr=0.0, betas=betas, eps=adam_eps)
        else:
            self.opt = torch.optim.AdamW(groups, lr=0.0, betas=betas, eps=adam_eps)
        self.count = 0

    def step(self) -> None:
        if self.max_grad_norm:
            clip_by_global_norm_(self.params, self.max_grad_norm)
        for group in self.opt.param_groups:
            group["lr"] = self.schedules[group["label"]](self.count)
        self.opt.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def _fresh_state(self, p: torch.Tensor) -> dict:
        if isinstance(self.opt, AdamW8bit):
            return self.opt.fresh_state(p)
        return {"step": torch.tensor(0.0), "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}

    def state_bytes(self) -> int:
        """Bytes of the optimizer's state tensors."""
        return sum(t.numel() * t.element_size() for s in self.opt.state.values()
                   for t in s.values() if isinstance(t, torch.Tensor))

    def state_arrays(self) -> dict[str, torch.Tensor]:
        """``{"count": ..., "<param name>/<key>": ...}``: the update count
        and each parameter's state (AdamW's ``step``, ``exp_avg``,
        ``exp_avg_sq``; the 8-bit optimizer's ``count`` and codes and scales
        or float32 moments)."""
        out = {"count": torch.tensor(self.count)}
        for name, p in self.named_params:
            for key, value in self.opt.state.get(p, {}).items():
                out[f"{name}/{key}"] = value.detach()
        return out

    @torch.no_grad()
    def load_state_arrays(self, arrays) -> None:
        """Restore what ``state_arrays`` gave; every trainable parameter's
        state must be there once any is, each tensor of the shape and dtype
        the optimizer keeps."""
        self.count = int(arrays["count"])
        for name, p in self.named_params:
            fresh = self._fresh_state(p)
            keys = [k for k in fresh if f"{name}/{k}" in arrays]
            if not keys:
                continue
            if len(keys) != len(fresh):
                raise KeyError(f"optimizer state of {name!r} is incomplete: {keys}")
            state = self.opt.state[p]
            for k in keys:
                value = torch.as_tensor(arrays[f"{name}/{k}"])
                if tuple(value.shape) != tuple(fresh[k].shape):
                    raise ValueError(f"optimizer state {name}/{k} has shape "
                                     f"{tuple(value.shape)}, the optimizer keeps "
                                     f"{tuple(fresh[k].shape)}")
                like = state.get(k)
                state[k] = value.to(device=fresh[k].device, dtype=fresh[k].dtype).clone() \
                    if like is None else like.copy_(value)


def build_optimizer(named_params: Iterable[tuple[str, torch.Tensor]], **kwargs) -> GroupedAdamW:
    """The 3-group AdamW (or 8-bit AdamW) over ``named_params``; keywords as
    ``GroupedAdamW``.  Gradient accumulation is the trainer's."""
    return GroupedAdamW(named_params, **kwargs)
