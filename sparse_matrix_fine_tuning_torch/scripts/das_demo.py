"""Distributed Alignment Search walkthrough (the pyvene DAS tutorial on the
port): ``python -m sparse_matrix_fine_tuning_torch.scripts.das_demo
[--platform cpu]``.

Counterpart of ``scripts/das_demo.py``: a high-level ``CausalModel`` (P = X
+ Y, Q = Z + W, O = [P >= Q]), a toy MLP trained on its factual behaviour,
then a rank-4 rotation at layer 1, positions 0 and 1 (X and Y), learned so
that interchanging its coordinates reproduces the causal model's
counterfactuals on P: evidence that P is linearly encoded there.  ``main``
returns the base task's accuracy, the interchange accuracy before and after
and the DAS losses.  On the card unless ``--platform cpu``; on the CPU in
under a minute.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from sparse_matrix_fine_tuning_torch.interventions import (
    CausalModel,
    ReftConfig,
    get_reft_model,
    interchange_accuracy,
    train_das,
)
from sparse_matrix_fine_tuning_torch.models.toy import MLPModel, ToyConfig
from sparse_matrix_fine_tuning_torch.utils.device import resolve_device


def causal_model() -> CausalModel:
    """P = X + Y, Q = Z + W, O = 1[P >= Q] over inputs in {0, 1, 2}."""
    vals = [0, 1, 2]
    return CausalModel(
        variables=["X", "Y", "Z", "W", "P", "Q", "O"],
        values={"X": vals, "Y": vals, "Z": vals, "W": vals,
                "P": [0, 1, 2, 3, 4], "Q": [0, 1, 2, 3, 4], "O": [0, 1]},
        parents={"X": [], "Y": [], "Z": [], "W": [],
                 "P": ["X", "Y"], "Q": ["Z", "W"], "O": ["P", "Q"]},
        functions={"X": lambda: 0, "Y": lambda: 0, "Z": lambda: 0,
                   "W": lambda: 0, "P": lambda x, y: x + y,
                   "Q": lambda z, w: z + w,
                   "O": lambda p, q: int(p >= q)},
        seed=0)


def main(argv=None, *, train_steps: int = 300, das_steps: int = 150) -> dict:
    p = argparse.ArgumentParser(description="DAS walkthrough on a toy MLP")
    p.add_argument("--platform", default=None, choices=[None, "cuda", "cpu"])
    args = p.parse_args(argv)
    device = resolve_device(args.platform)
    cm = causal_model()
    print("causal graph:")
    print(cm.format_structure())

    # the low-level network, trained on the factual task
    cfg = ToyConfig(hidden_size=32, num_hidden_layers=3, num_classes=2, max_positions=4)
    model = MLPModel(cfg, device="cpu", generator=torch.Generator().manual_seed(0)).to(device)
    ds = cm.generate_factual_dataset(512)
    x = torch.from_numpy(ds["input_ids"]).to(device)
    y = torch.from_numpy(ds["labels"][:, 0].astype(np.int64)).to(device)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    for _ in range(train_steps):
        opt.zero_grad()
        loss = model.loss(model(x), y)
        loss.backward()
        opt.step()
    with torch.no_grad():
        acc = float((torch.argmax(model(x), -1) == y).float().mean())
    print(f"\nbase task: loss {float(loss):.4f}, accuracy {acc:.3f}")

    # counterfactual data intervening on the hidden variable P
    cds = cm.generate_counterfactual_dataset(
        256, intervention_id=lambda iv: 0, batch_size=8,
        intervention_sampler=lambda: {"P": cm._rng.choice(cm.values["P"])})
    base = torch.from_numpy(cds["input_ids"]).to(device)
    source = torch.from_numpy(cds["source_input_ids"][:, 0]).to(device)
    labels = torch.from_numpy(cds["labels"][:, 0].astype(np.int64)).to(device)

    # DAS: a rank-4 rotated subspace at layer 1, positions of P's parents
    reft = get_reft_model(model, ReftConfig(representations=[
        {"layer": 1, "component": "block_output",
         "intervention": "LowRankRotatedSpaceIntervention", "low_rank_dimension": 4}]),
        generator=torch.Generator().manual_seed(7))
    locs = torch.tensor([0, 1], device=device).expand(base.shape[0], 1, 2)
    kw = dict(base_locations=locs, source_locations=locs)
    before = interchange_accuracy(reft, base, source, labels, **kw)
    history = train_das(reft, base, source, labels, steps=das_steps, learning_rate=1e-2,
                        log_every=50, **kw)
    after = interchange_accuracy(reft, base, source, labels, **kw)
    print(f"\ninterchange accuracy: {before:.3f} -> {after:.3f} "
          f"(loss {history[0]:.3f} -> {history[-1]:.3f})")
    print("=> the rotation aligns the network's layer-1 X/Y positions with the causal "
          "variable P" if after > before else "=> no alignment found at this location")
    return {"base_accuracy": acc, "before": before, "after": after, "losses": history}


if __name__ == "__main__":
    main()
