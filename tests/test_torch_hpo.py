"""The port's ASHA search (``training/hpo.py``) against the JAX package's on
the CPU: the samplers and the trial lists bit for bit (numpy's
``default_rng`` under one seed), the successive-halving schedule on a
deterministic ``run_trial`` (which trials run, at which budgets, who
survives each rung, the best), the replay of finished trials through
``state_path``, a raising trial scored worst, and parallel trials on
threads.

The deterministic trial's metric is a smooth function of the sampled lr
and the budget; its values differ between any two trials by far more than
rounding, so that no rung's order can tie (Python's sort is stable, and two
metrics within rounding could rank differently).  Metrics are compared
exactly: both packages compute them by the same Python on the same floats.
"""

import json
import math
import threading

import numpy as np
import pytest

from sparse_matrix_fine_tuning_torch.training import hpo as thpo
from sparse_matrix_fine_tuning_tpu.training import hpo as jhpo

SPACES = {
    "monarch": lambda m: {"seed": 42, "learning_rate": m.quniform(1e-4, 6.6e-4, 2e-5),
                          "per_device_train_batch_size": m.choice([16, 32]),
                          "weight_decay": 0.01, "blk_r": 4},
    "alpaca": lambda m: {"learning_rate": m.loguniform(5e-5, 1e-3),
                         "blk_r": m.choice([4, 8, 16])},
    "uniform": lambda m: {"dropout": m.uniform(0.0, 0.3), "nblocks": m.choice([2, 4])},
    "grid": lambda m: {"learning_rate": m.grid([1e-5, 2e-5, 3e-5]),
                       "per_device_train_batch_size": m.grid([16, 32]),
                       "weight_decay": 0.1, "lr_scheduler_type": m.grid(["cosine"])},
    "grid_sampled": lambda m: {"lr": m.grid([1, 2]), "dropout": m.choice([0.0, 0.1])},
}


@pytest.mark.parametrize("space", list(SPACES))
@pytest.mark.parametrize("n_trials", [1, 7])
def test_torch_hpo_trials_match_jax(space, n_trials):
    for seed in (0, 3):
        got = thpo._build_trials(SPACES[space](thpo), n_trials, np.random.default_rng(seed))
        want = jhpo._build_trials(SPACES[space](jhpo), n_trials, np.random.default_rng(seed))
        assert json.dumps(got) == json.dumps(want)


def test_torch_hpo_samplers_match_jax():
    for name in ("loguniform", "uniform", "choice", "grid"):
        args = ([1, 2, 3],) if name in ("choice", "grid") else (0.1, 0.9)
        assert getattr(thpo, name)(*args) == getattr(jhpo, name)(*args)
    assert thpo.quniform(1, 2, 0.25) == jhpo.quniform(1, 2, 0.25)
    with pytest.raises(ValueError):
        thpo._sample({"x": ("grid", [1])}, np.random.default_rng(0))
    with pytest.raises(ValueError):
        thpo._sample({"x": ("nope", 1)}, np.random.default_rng(0))


def metric(hp: dict, epochs: float) -> float:
    """Deterministic and tie-free: distinct sampled lrs give values apart by
    far more than rounding; a longer budget scores higher."""
    return -abs(math.log(hp["learning_rate"]) - math.log(3e-4)) + 0.01 * epochs


def recorder():
    calls = []

    def run_trial(hp, epochs, trial_id):
        calls.append((trial_id, epochs, hp["learning_rate"]))
        return {"eval_acc": metric(hp, epochs)}
    return calls, run_trial


KW = dict(target_metric="eval_acc", mode="max", min_epochs=1.0, max_epochs=9.0, seed=4)


@pytest.mark.parametrize("n_trials,eta", [(9, 3), (10, 2), (1, 3)])
def test_torch_hpo_schedule_matches_jax(n_trials, eta):
    """The trials run, their budgets and order, the survivors of each rung,
    the history and the best: equal to JAX's."""
    calls_t, run_t = recorder()
    calls_j, run_j = recorder()
    got = thpo.hyperparameter_search(run_t, SPACES["alpaca"](thpo), n_trials=n_trials, eta=eta,
                                     **KW)
    want = jhpo.hyperparameter_search(run_j, SPACES["alpaca"](jhpo), n_trials=n_trials, eta=eta,
                                      **KW)
    assert calls_t == calls_j and json.dumps(got) == json.dumps(want)
    budgets = sorted({e for _, e, _ in calls_t})
    assert budgets[0] == 1.0 and (n_trials == 1 or budgets[-1] == 9.0 or len(budgets) > 1)


def test_torch_hpo_replays_its_state(tmp_path):
    """A sweep cut after its first rung goes on from ``state_path``: the
    finished trials are read back, not run again, and the result equals
    the straight sweep's (and JAX's replay of the same file)."""
    space = SPACES["alpaca"](thpo)
    _, run_straight = recorder()
    straight = thpo.hyperparameter_search(run_straight, space, n_trials=9, **KW)
    state = tmp_path / "hpo_state.jsonl"
    first = []

    def cut(hp, epochs, trial_id):
        if epochs > 1.0:
            raise KeyboardInterrupt  # the sweep dies mid-way
        first.append(trial_id)
        return {"eval_acc": metric(hp, epochs)}

    with pytest.raises(KeyboardInterrupt):
        thpo.hyperparameter_search(cut, space, n_trials=9, state_path=str(state), **KW)
    assert sorted(first) == list(range(9)) and len(state.read_text().splitlines()) == 9
    calls, run_trial = recorder()
    resumed = thpo.hyperparameter_search(run_trial, space, n_trials=9, state_path=str(state),
                                         **KW)
    assert json.dumps(resumed) == json.dumps(straight)
    assert all(e > 1.0 for _, e, _ in calls) and calls
    _, run_j = recorder()
    replayed_j = jhpo.hyperparameter_search(run_j, SPACES["alpaca"](jhpo), n_trials=9,
                                            state_path=str(state), **KW)
    assert json.dumps(replayed_j["best_hyperparams"]) == json.dumps(resumed["best_hyperparams"])


def test_torch_hpo_scores_a_raising_trial_worst():
    """A trial that raises (or returns no target) scores worst and is never
    best; the sweep goes on, as in the JAX package."""
    def run_trial(hp, epochs, trial_id):
        if trial_id in (0, 2):
            raise RuntimeError("a trial's kernel failed")
        if trial_id == 1:
            return {}
        return {"eval_acc": metric(hp, epochs)}

    got = thpo.hyperparameter_search(run_trial, SPACES["alpaca"](thpo), n_trials=6, **KW)
    want = jhpo.hyperparameter_search(run_trial, SPACES["alpaca"](jhpo), n_trials=6, **KW)
    assert json.dumps(got) == json.dumps(want)
    worst = [r for r in got["trials"] if r["id"] in (0, 1, 2)]
    assert len(worst) == 3 and all(r["eval_acc"] == -math.inf for r in worst)
    assert got["best_metric"] > -math.inf
    assert thpo.hyperparameter_search(lambda hp, e: {}, {"x": 1}, n_trials=2, mode="min",
                                      target_metric="loss")["best_metric"] == math.inf


def test_torch_hpo_parallel_trials_match_serial():
    """Threads run a rung's trials at once (up to ``parallel_trials``), and
    the result equals the serial sweep's; two-argument trials work too."""
    live, peak, lock = [0], [0], threading.Lock()
    barrier = threading.Barrier(3, timeout=10)

    def run_trial(hp, epochs):
        with lock:
            live[0] += 1
            peak[0] = max(peak[0], live[0])
        if epochs == 1.0:
            barrier.wait()  # the first rung's three trials meet here
        with lock:
            live[0] -= 1
        return {"eval_acc": metric(hp, epochs)}

    space = SPACES["alpaca"](thpo)
    par = thpo.hyperparameter_search(run_trial, space, n_trials=3, parallel_trials=3, **KW)
    ser = thpo.hyperparameter_search(lambda hp, e: {"eval_acc": metric(hp, e)}, space,
                                     n_trials=3, **KW)
    assert peak[0] == 3 and json.dumps(par) == json.dumps(ser)
