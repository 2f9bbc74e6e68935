"""Layered config system.

A copy of ``sparse_matrix_fine_tuning_tpu/utils/config.py``, which
reimplements the reference's three config layers (SURVEY.md section 5.6):
  (a) per-task JSON -> dataclass/dict
  (b) adapter peft_config.json dicts (same keys as the reference)
  (c) free-form --key=value CLI overrides applied across every config object
      with literal_eval typing (reference train_utils.py:184-232)
plus best-HP JSON persistence/re-injection after tuning
(reference train_utils.py:95-109, run_glue.py:681-707).
"""

from __future__ import annotations

import dataclasses
import json
import os
import warnings
from ast import literal_eval
from typing import Any, Dict, List, Union


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def override_config(configs: List[Any], new_args: Union[List[str], Dict, None]):
    """Apply overrides to every config (dict or dataclass) that has the key.

    ``new_args``: dict or a list of "--key=value" / "--key value" strings.
    Returns the dict of keys that matched NO config (extra args).
    """
    if not new_args:
        return {}
    extra: dict = {}
    items = new_args.items() if isinstance(new_args, dict) else None
    if items is None:
        items = []
        for arg in new_args:
            if not isinstance(arg, str) or not arg.startswith("--"):
                raise ValueError(
                    f"wrong format for {arg!r}: extra args must be --key=value")
            body = arg[2:]
            if "=" in body:
                key, val = body.split("=", 1)
            else:
                key, val = body.split(" ", 1)
            items.append((key, val))

    for key, val in items:
        if isinstance(val, str):
            try:
                val = literal_eval(val)
            except (SyntaxError, ValueError):
                pass
        matched = False
        for cfg in configs:
            if dataclasses.is_dataclass(cfg):
                if key in {f.name for f in dataclasses.fields(cfg)}:
                    old = getattr(cfg, key)
                    if old is not None and val is not None and not isinstance(val, type(old)):
                        if isinstance(old, float) and isinstance(val, int):
                            val = float(val)
                        else:
                            warnings.warn(
                                f"type change for {key}: {type(old).__name__} -> "
                                f"{type(val).__name__}")
                    setattr(cfg, key, val)
                    matched = True
            elif isinstance(cfg, dict):
                if key in cfg:
                    cfg[key] = val
                    matched = True
            else:
                if hasattr(cfg, key):
                    setattr(cfg, key, val)
                    matched = True
        if matched:
            print(f"Overriding: {key} = {val}")
        else:
            extra[key] = val
    return extra


def load_best_hp(run_dir: str, task_dir: str = "nonexistent"):
    """Load tuned hyperparameters from the run dir, else the task dir
    (reference train_utils.py:95-109)."""
    for d in (run_dir, task_dir):
        path = os.path.join(d, "best_hyperparams.json")
        if os.path.exists(path):
            hp = load_json(path)
            print(f"Using best hp from {path}: {hp}")
            return hp
    return None


def save_best_hp(hp: dict, run_dir: str, task_dir: str | None = None):
    os.makedirs(run_dir, exist_ok=True)
    with open(os.path.join(run_dir, "best_hyperparams.json"), "w") as f:
        json.dump(hp, f, indent=1)
    if task_dir:
        os.makedirs(task_dir, exist_ok=True)
        with open(os.path.join(task_dir, "best_hyperparams.json"), "w") as f:
            json.dump(hp, f, indent=1)
