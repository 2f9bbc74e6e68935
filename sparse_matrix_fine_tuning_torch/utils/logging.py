"""Run logging: JSONL metrics + optional wandb, run grouping, layer watching.

Counterpart of ``sparse_matrix_fine_tuning_tpu/utils/logging.py`` (the
reference logs everything to wandb: train_utils.py:235-247 run groups,
:521-549 watch_layers).  ``get_run_group``, ``host_tag``,
``persist_run_group`` and ``RunLogger`` are copies, but for one condition:
every metric lands in ``metrics.jsonl`` under the run dir, and it is
mirrored to wandb only where ``WANDB_API_KEY`` is set and wandb imports.
The JAX logger calls ``wandb.init`` whenever wandb imports; on a machine
with wandb installed but no key and no network, that call fails through
wandb's error reporting, which sends to wandb's servers where it is
enabled, and the exception wandb keeps holds the caller's frames, the
trained model among them, for the rest of the process.  ``watch_layers``
reads the port's ``MonarchLinear`` and ``Scaler`` parameters.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Optional

import numpy as np
from torch import nn

from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear, Scaler
from sparse_matrix_fine_tuning_torch.peft.surgery import _iter_parents


def get_run_group(task_name: Optional[str] = None, do_tune: bool = False,
                  group: Optional[str] = None, cur_time: Optional[str] = None,
                  notes: Optional[str] = None) -> str:
    """wandb-style run grouping (reference train_utils.py:235-247)."""
    parts = []
    if do_tune:
        parts.append("tune")
    if task_name:
        parts.append(task_name)
    if notes:
        parts.append(notes)
    if group:
        parts.append(group)
    parts.append(cur_time or time.strftime("%m-%d-%H", time.localtime()))
    return "_".join(parts)


def host_tag() -> str:
    """Host identifier recorded with each run so checkpoints can be located
    (reference uploads hostname.txt as WANDB_HOST, run_glue.py:199-204;
    here the hostname is read directly -- no sidecar file needed)."""
    if os.path.exists("hostname.txt"):
        with open("hostname.txt") as f:
            return f.readline().strip()
    import socket
    return socket.gethostname()


def persist_run_group(output_dir: str, group: str, resume: bool = False) -> str:
    """Persist the run group to ``full_group.txt`` so a resumed HPO sweep or
    training run rejoins the same group (reference run_glue.py:236-246 reads
    it under --resume/--load_group; :571-575 writes it before tuning)."""
    path = os.path.join(output_dir, "full_group.txt")
    if resume:
        if os.path.exists(path):
            with open(path) as f:
                group = f.readline().strip()
            print(f"Loading run group: {group}")
        else:
            print("No full_group.txt in the output dir; starting a new "
                  "run group (won't rejoin a previous sweep).")
    os.makedirs(output_dir, exist_ok=True)
    with open(path, "w") as f:
        f.write(group)
    return group


class RunLogger:
    """JSONL metrics sink, mirrored to wandb where ``WANDB_API_KEY`` is set
    (and ``use_wandb``)."""

    def __init__(self, output_dir: str, *, project: Optional[str] = None,
                 group: Optional[str] = None, name: Optional[str] = None,
                 config: Optional[dict] = None, use_wandb: bool = True):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._fh = open(self.path, "a")
        self.wandb_run = None
        if use_wandb and os.environ.get("WANDB_API_KEY"):
            try:
                import wandb
                os.environ.setdefault("WANDB_HOST", host_tag())
                self.wandb_run = wandb.init(
                    project=project or "sparse_matrix_fine_tuning_torch",
                    group=group, name=name, config=config or {},
                    dir=output_dir)
            except Exception:
                self.wandb_run = None
        if config:
            self.log({"_config": config, "_host": host_tag(), "step": 0})

    def log(self, metrics: dict):
        rec = dict(metrics)
        rec.setdefault("_ts", round(time.time(), 3))
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self.wandb_run is not None:
            clean = {k: v for k, v in rec.items() if not k.startswith("_")}
            self.wandb_run.log(clean)

    def finish(self):
        self._fh.close()
        if self.wandb_run is not None:
            self.wandb_run.finish()


def watch_layers(model, logger: Optional[RunLogger] = None,
                 max_per_module: int = 2) -> dict:
    """Adapter weight statistics (reference train_utils.py:521-549
    wandb.watch equivalent): mean/std/absmax, over float32 numpy copies, for
    a capped number of MonarchLinear/Scaler modules per attribute name."""
    count = defaultdict(int)
    stats = {}
    for _, name, child in _iter_parents(model):
        if isinstance(child, (MonarchLinear, Scaler)):
            if count[(type(child).__name__, name)] >= max_per_module:
                continue
            count[(type(child).__name__, name)] += 1
            for pname in ("blkdiag1", "blkdiag2", "scaler"):
                p = getattr(child, pname, None)
                if not isinstance(p, nn.Parameter):
                    continue
                v = p.detach().float().cpu().numpy()
                key = f"watch/{name}.{pname}"
                stats[f"{key}.mean"] = float(v.mean())
                stats[f"{key}.std"] = float(v.std())
                stats[f"{key}.absmax"] = float(np.abs(v).max())
    if logger is not None and stats:
        logger.log(stats)
    return stats
