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
The AdamW update is ``torch.optim.AdamW``, which decays with the
parameter's value before the step as ``optax.adamw`` does.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

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
    """The 3-group AdamW with its schedules and global-norm clipping.

    ``step()`` clips the ``.grad`` of every parameter, sets each group's
    learning rate from its schedule at the current update count, and takes
    one AdamW step.  ``state_arrays``/``load_state_arrays`` give the state
    as flat arrays keyed by parameter name (``training/checkpoint.py``).
    """

    def __init__(self, named_params: Iterable[tuple[str, torch.Tensor]], *,
                 learning_rate: float, total_steps: int, warmup_ratio: float = 0.06,
                 lr_scheduler_type: str = "linear", weight_decay: float = 0.0,
                 large_lr: bool = False, new_lr: float = 5e-3, use_scaler: bool = False,
                 adam_b1: float = 0.9, adam_b2: float = 0.999, adam_eps: float = 1e-8,
                 max_grad_norm: Optional[float] = 1.0, optim: str = "adamw"):
        if optim == "adamw8bit":
            raise NotImplementedError(
                "optim='adamw8bit': ROADMAP.md queue A item 27, 'training/adam8bit.py'")
        if optim != "adamw":
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
            members[param_group_label(name, use_scaler=use_scaler)].append(p)
        groups = [{"params": ps, "weight_decay": decays[label], "lr": 0.0, "label": label}
                  for label, ps in members.items() if ps]
        self.params = [p for g in groups for p in g["params"]]
        self.max_grad_norm = max_grad_norm
        self.opt = torch.optim.AdamW(groups, lr=0.0, betas=(adam_b1, adam_b2), eps=adam_eps)
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

    def state_arrays(self) -> dict[str, torch.Tensor]:
        """``{"count": ..., "<param name>/<moment>": ...}``: the update count
        and each parameter's AdamW state (``step``, ``exp_avg``,
        ``exp_avg_sq``)."""
        out = {"count": torch.tensor(self.count)}
        for name, p in self.named_params:
            for key, value in self.opt.state.get(p, {}).items():
                out[f"{name}/{key}"] = value.detach()
        return out

    @torch.no_grad()
    def load_state_arrays(self, arrays) -> None:
        """Restore what ``state_arrays`` gave; every trainable parameter's
        state must be there once any is."""
        self.count = int(arrays["count"])
        for name, p in self.named_params:
            keys = [k for k in ("step", "exp_avg", "exp_avg_sq") if f"{name}/{k}" in arrays]
            if not keys:
                continue
            if len(keys) != 3:
                raise KeyError(f"optimizer state of {name!r} is incomplete: {keys}")
            state = self.opt.state[p]
            for k in keys:
                value = torch.as_tensor(arrays[f"{name}/{k}"])
                like = state.get(k)
                if k == "step":
                    state[k] = value.to(torch.float32)
                else:
                    if tuple(value.shape) != tuple(p.shape):
                        raise ValueError(f"optimizer state {name}/{k} has shape "
                                         f"{tuple(value.shape)}, the parameter {tuple(p.shape)}")
                    state[k] = value.to(device=p.device, dtype=p.dtype).clone() \
                        if like is None else like.copy_(value)


def build_optimizer(named_params: Iterable[tuple[str, torch.Tensor]], **kwargs) -> GroupedAdamW:
    """The 3-group AdamW over ``named_params``; keywords as
    ``GroupedAdamW``.  Gradient accumulation is the trainer's."""
    return GroupedAdamW(named_params, **kwargs)
