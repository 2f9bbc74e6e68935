"""ASHA-style hyperparameter search (successive halving), PyTorch port.

Counterpart of ``sparse_matrix_fine_tuning_tpu/training/hpo.py`` (the
reference wires Ray Tune's ASHAScheduler into every harness): sample N
configurations, train each at the smallest budget, keep the best 1/eta at
each rung and grow the budget by eta.  Each trial is a fresh trainer; a
trial that raises scores worst, as Ray's ``max_failures`` lets a trial
fail.

The samplers and the trial list (``loguniform`` ... ``_build_trials``) are
numpy, copied from the JAX module (the port imports nothing of it): a seed
gives the same trials, bit for bit.  ``hyperparameter_search`` pins a
trial to a card of ``devices`` with ``torch.cuda.device`` where the JAX one
uses ``jax.default_device``.
"""

from __future__ import annotations

import gc
import inspect
import itertools
import json
import math
import os
import queue
import threading
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List

import numpy as np


def loguniform(low: float, high: float):
    return ("loguniform", low, high)


def uniform(low: float, high: float):
    return ("uniform", low, high)


def quniform(low: float, high: float, q: float):
    """Uniform quantised to multiples of q (Ray tune.quniform; the
    reference's monarch/boft lr spaces, run_glue.py:598,619)."""
    return ("quniform", low, high, q)


def choice(options):
    return ("choice", list(options))


def grid(options):
    """Grid-search dimension (Ray tune.grid_search; the reference's full
    fine-tuning space, run_glue.py:630-635).  All grid dimensions expand to
    their cartesian product regardless of n_trials."""
    return ("grid", list(options))


def _sample(space: dict, rng: np.random.Generator) -> dict:
    hp = {}
    for k, spec in space.items():
        if not (isinstance(spec, tuple) and spec and isinstance(spec[0], str)):
            hp[k] = spec  # pinned constant (reference pins seed/wd/blk_r...)
            continue
        kind = spec[0]
        if kind == "loguniform":
            hp[k] = float(np.exp(rng.uniform(np.log(spec[1]), np.log(spec[2]))))
        elif kind == "uniform":
            hp[k] = float(rng.uniform(spec[1], spec[2]))
        elif kind == "quniform":
            v = rng.uniform(spec[1], spec[2])
            hp[k] = float(np.clip(round(v / spec[3]) * spec[3], spec[1], spec[2]))
        elif kind == "choice":
            hp[k] = spec[1][int(rng.integers(len(spec[1])))]
        elif kind == "grid":
            raise ValueError("grid dims are expanded, not sampled")
        else:
            raise ValueError(f"unknown spec {spec}")
    return hp


def _build_trials(space: dict, n_trials: int, rng: np.random.Generator):
    """Trial list: cartesian product over grid dims x n_trials samples of the
    rest (pure grid space => exactly the product, like Ray's grid_search)."""
    grid_keys = [k for k, s in space.items()
                 if isinstance(s, tuple) and s and s[0] == "grid"]
    rest = {k: s for k, s in space.items() if k not in grid_keys}
    if not grid_keys:
        return [{"hp": _sample(space, rng), "id": i} for i in range(n_trials)]
    combos = list(itertools.product(*[space[k][1] for k in grid_keys]))
    # Only a GENUINELY stochastic dim multiplies the grid (Ray num_samples
    # semantics); a choice with one option is a pinned constant, so e.g.
    # the full-FT space (3x2 grid + choice([0.1])) stays its fixed grid
    # even under an explicit --n_trials.
    def _stochastic(s):
        if not (isinstance(s, tuple) and s and isinstance(s[0], str)):
            return False
        return not (s[0] == "choice" and len(s[1]) <= 1)

    n_samples = max(1, n_trials) if any(
        _stochastic(s) for s in rest.values()) else 1
    trials = []
    for _ in range(n_samples):
        for combo in combos:
            hp = _sample(rest, rng)
            hp.update(dict(zip(grid_keys, combo)))
            trials.append({"hp": hp, "id": len(trials)})
    return trials


def hyperparameter_search(
    run_trial: Callable[[dict, float], dict],
    search_space: dict,
    *,
    n_trials: int = 8,
    target_metric: str = "eval_loss",
    mode: str = "min",
    eta: int = 3,
    min_epochs: float = 1.0,
    max_epochs: float = 4.0,
    seed: int = 0,
    state_path: str | None = None,
    parallel_trials: int = 1,
    devices: list | None = None,
) -> dict:
    """Successive-halving search.

    Args:
      run_trial: (hyperparams, num_epochs) -> metrics dict; with a third
        positional parameter it also gets the trial id (for a per-trial
        output directory and ``resume=True``, so that a rung's budget goes on
        from the trial's last checkpoint).  A trial that raises scores worst.
      state_path: optional JSONL file: each finished (trial, budget) is
        appended there and replayed on a restart, so a crashed sweep goes on
        where it stopped.
      parallel_trials: up to this many trials of a rung at once, on threads.
      devices: optional CUDA devices (``torch.device`` or index): each trial
        takes one from a pool and runs under ``torch.cuda.device(d)``,
        releasing it when done; trials beyond the pool wait for a free card.
    Returns {"best_hyperparams", "best_metric", "trials"}.
    """
    rng = np.random.default_rng(seed)
    trials = _build_trials(search_space, n_trials, rng)
    worst = -math.inf if mode == "max" else math.inf
    sign = 1 if mode == "max" else -1
    budget = min_epochs
    history: List[dict] = []
    done: dict = {}
    takes_id = len(inspect.signature(run_trial).parameters) >= 3
    if state_path and os.path.exists(state_path):
        with open(state_path) as f:
            for line in f:
                rec = json.loads(line)
                done[(rec["id"], rec["epochs"])] = rec
        if done:
            print(f"[hpo] resuming: {len(done)} completed trial evaluations")

    state_lock = threading.Lock()
    device_pool = None
    if devices:
        device_pool = queue.Queue()
        for d in devices:
            device_pool.put(d)

    def execute(t):
        device = device_pool.get() if device_pool is not None else None
        try:
            args = (dict(t["hp"]), budget) + ((t["id"],) if takes_id else ())
            if device is not None:
                import torch

                with torch.cuda.device(device):  # this thread's current card
                    metrics = run_trial(*args)
            else:
                metrics = run_trial(*args)
            val = metrics.get(target_metric, worst)
        except Exception as e:
            print(f"[hpo] trial {t['id']} failed: {type(e).__name__}: {e}")
            traceback.print_exc()
            val = worst
        gc.collect()  # free the trial's model and optimizer
        if device is not None:
            device_pool.put(device)  # released only after its buffers are freed
        rec = {"id": t["id"], "hp": t["hp"], "epochs": budget, target_metric: val}
        print(f"[hpo] {json.dumps(rec)}")
        if state_path:
            # recorded at once, so that a crash mid-rung loses only the
            # trials in flight
            with state_lock, open(state_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    alive = trials
    while alive:
        scored = []
        pending = []
        for t in alive:
            key = (t["id"], budget)
            if key in done:
                rec = done[key]
                val = rec.get(target_metric, worst)
                history.append(rec)
                scored.append((sign * (val if val == val else worst), t))
            else:
                pending.append(t)
        if pending:
            if parallel_trials > 1:
                with ThreadPoolExecutor(max_workers=parallel_trials) as ex:
                    recs = list(ex.map(execute, pending))
            else:
                recs = [execute(t) for t in pending]
            for t, rec in zip(pending, recs):
                val = rec[target_metric]
                history.append(rec)
                scored.append((sign * (val if val == val else worst), t))
        scored.sort(key=lambda x: -x[0])
        keep = max(1, len(scored) // eta)
        if len(alive) == 1 or budget >= max_epochs:
            best = scored[0][1]
            return {"best_hyperparams": best["hp"], "best_metric": sign * scored[0][0],
                    "trials": history}
        alive = [t for _, t in scored[:keep]]
        budget = min(budget * eta, max_epochs)
    raise RuntimeError("no trials ran")
