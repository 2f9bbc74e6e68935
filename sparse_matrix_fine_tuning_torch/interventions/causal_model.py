"""Causal-model data generators for interchange-intervention training.

A numpy copy of ``sparse_matrix_fine_tuning_tpu/interventions/causal_model.py``
(itself a redesign of the reference's pyvene generator,
pyvene/data_generators/causal_model.py:12-380), equal to it bit for bit: a
causal graph over discrete variables whose factual and counterfactual
(interchange) behaviour gives the training data of distributed alignment
search (``interventions/das.py``) against a network wrapped in
``ReftModel``.

As the JAX package's: no torch, networkx or matplotlib (``format_structure``
renders the graph as text); an instance-seeded ``random.Random`` in place of
the reference's global ``random``; the dataset generators return one dict
of stacked numpy arrays (``return_arrays=False``: the list of settings).
"""

from __future__ import annotations

import itertools
import random
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["CausalModel"]


class CausalModel:
    """A discrete causal model: DAG of variables with value domains and
    per-variable functions of the parents (reference causal_model.py:12).

    Parameters mirror the reference: ``variables`` (list of names),
    ``values`` ({var: list of domain values}), ``parents`` ({var: list of
    parent names}; inputs have ``[]``), ``functions`` ({var: callable over
    parent values in ``parents[var]`` order}).  ``timesteps`` optional
    explicit topological levels; derived otherwise.
    """

    def __init__(self, variables, values, parents, functions,
                 timesteps=None, equiv_classes=None, seed: int = 0):
        self.variables = sorted(variables)
        self.values = values
        self.parents = parents
        self.functions = functions
        self._rng = random.Random(seed)

        self.children: Dict[str, List[str]] = {v: [] for v in self.variables}
        for var in self.variables:
            if var not in parents:
                raise ValueError(f"variable {var!r} missing from parents")
            if var not in values:
                raise ValueError(f"variable {var!r} missing from values")
            if var not in functions:
                raise ValueError(f"variable {var!r} missing from functions")
            for p in parents[var]:
                self.children[p].append(var)

        self.inputs = [v for v in self.variables if not parents[v]]
        # outputs = variables that are nobody's parent (reference :55-59)
        self.outputs = [v for v in self.variables
                        if all(v not in parents[c] for c in self.variables)]

        if timesteps is None:
            self.timesteps = self._derive_timesteps()
            end = max(self.timesteps.values())
            for out in self.outputs:
                self.timesteps[out] = end
        else:
            for var in self.variables:
                for p in parents[var]:
                    if timesteps[p] >= timesteps[var]:
                        raise ValueError(
                            f"timestep of parent {p!r} must precede {var!r}")
            self.timesteps = dict(timesteps)
        self.variables.sort(key=lambda v: self.timesteps[v])

        # Equivalence classes: for each non-input var and each value, the
        # list of parent settings producing it (reference :77-89).  Used by
        # the balanced tree sampler.
        if equiv_classes is not None:
            self.equiv_classes = equiv_classes
        else:
            self.equiv_classes = {}
            for var in self.variables:
                if var in self.inputs:
                    continue
                cls = {val: [] for val in self.values[var]}
                for pv in itertools.product(
                        *[self.values[p] for p in self.parents[var]]):
                    out = self.functions[var](*pv)
                    cls[out].append(dict(zip(self.parents[var], pv)))
                self.equiv_classes[var] = cls

        self.run_forward()  # validates functions are total over domains

    # -- graph structure ----------------------------------------------------

    def _derive_timesteps(self) -> Dict[str, int]:
        """Longest-path-from-inputs level per variable (matches the
        reference's fixed-point propagation, causal_model.py:91-108)."""
        ts = {v: 0 for v in self.inputs}
        changed = True
        while changed:
            changed = False
            for var in self.variables:
                if not self.parents[var]:
                    continue
                if all(p in ts for p in self.parents[var]):
                    level = 1 + max(ts[p] for p in self.parents[var])
                    if ts.get(var) != level:
                        ts[var] = level
                        changed = True
        missing = [v for v in self.variables if v not in ts]
        if missing:
            raise ValueError(f"cyclic or disconnected variables: {missing}")
        return ts

    def format_structure(self) -> str:
        """ASCII rendering of the DAG by timestep level (replaces the
        reference's networkx/matplotlib print_structure)."""
        lines = []
        for t in sorted(set(self.timesteps.values())):
            row = [v for v in self.variables if self.timesteps[v] == t]
            rendered = []
            for v in row:
                ps = ",".join(self.parents[v])
                rendered.append(f"{v}({ps})" if ps else v)
            lines.append(f"t={t}: " + "  ".join(rendered))
        return "\n".join(lines)

    # -- forward / interchange ----------------------------------------------

    def run_forward(self, intervention: Optional[dict] = None) -> dict:
        """Compute every variable in timestep order; ``intervention`` pins
        variables to fixed values (reference causal_model.py:157-172)."""
        setting: Dict[str, object] = {}
        for var in self.variables:  # already topologically sorted
            if intervention is not None and var in intervention:
                setting[var] = intervention[var]
            else:
                setting[var] = self.functions[var](
                    *[setting[p] for p in self.parents[var]])
        return setting

    def run_interchange(self, input: dict, source_interventions: dict) -> dict:
        """Interchange intervention: for each target var, run the SOURCE
        input forward, take the target's value there, pin it into the BASE
        forward (reference causal_model.py:174-179)."""
        pinned = dict(input)
        for var, source_input in source_interventions.items():
            pinned[var] = self.run_forward(source_input)[var]
        return self.run_forward(pinned)

    def find_live_paths(self, intervention: dict) -> Dict[int, list]:
        """All causally-live paths under the given total input setting: an
        edge var->child is live if flipping var's value (holding the rest)
        changes child (reference causal_model.py:120-141).  Returns
        {path_length: [paths]} for lengths >= 2; like the reference, the
        final (empty) probed length is kept in the dict."""
        actual = self.run_forward(intervention)
        paths = {1: [[v] for v in self.variables]}
        step = 2
        while True:
            paths[step] = []
            for path in paths[step - 1]:
                for child in self.children[path[-1]]:
                    live = False
                    for value in self.values[path[-1]]:
                        counter = dict(intervention)
                        counter[path[-1]] = value
                        if self.run_forward(counter)[child] != actual[child]:
                            live = True
                            break
                    if live:
                        paths[step].append(path + [child])
            if not paths[step]:
                break
            step += 1
        del paths[1]
        return paths

    # -- sampling -------------------------------------------------------------

    def sample_input(self, mandatory: Optional[Callable] = None,
                     output_var: Optional[str] = None,
                     output_var_value=None) -> dict:
        """Uniform input sampling, optionally rejection-filtered by
        ``mandatory(total_setting)`` (reference causal_model.py:204-210).
        Accepts the balanced sampler's kwargs so either sampler can be
        passed to the dataset generators: when ``output_var`` is given,
        rejection-samples until that variable takes ``output_var_value``."""
        while True:
            inp = {v: self._rng.choice(self.values[v]) for v in self.inputs}
            total = self.run_forward(inp)
            if mandatory is not None and not mandatory(total):
                continue
            if output_var is not None and total[output_var] != output_var_value:
                continue
            return inp

    def sample_intervention(self) -> dict:
        """Random nonempty setting of intermediate (non-input, non-output)
        variables (reference causal_model.py:194-202)."""
        intervention: Dict[str, object] = {}
        while not intervention:
            for var in self.variables:
                if var in self.inputs or var in self.outputs:
                    continue
                if self._rng.choice([0, 1]) == 0:
                    intervention[var] = self._rng.choice(self.values[var])
        return intervention

    def sample_input_tree_balanced(self, output_var: Optional[str] = None,
                                   output_var_value=None) -> dict:
        """Sample an input whose forward pass hits ``output_var ==
        output_var_value``, by walking equivalence classes root-to-leaves —
        balanced over output values instead of input-marginal (reference
        causal_model.py:212-232).  Like the reference, only exact on
        TREE-shaped graphs: when two intermediates share an input parent,
        the later equivalence-class pick overwrites the earlier one and the
        target value may not be realized."""
        if output_var is None:
            if len(self.outputs) != 1:
                raise ValueError("output_var required with multiple outputs")
            output_var = self.outputs[0]
        if output_var_value is None:
            output_var_value = self._rng.choice(self.values[output_var])

        input_setting: Dict[str, object] = {}

        def fill(var, value):
            options = self.equiv_classes[var][value]
            if not options:
                raise ValueError(f"{var}={value!r} is unreachable")
            parent_values = self._rng.choice(options)
            for parent, pv in parent_values.items():
                if parent in self.inputs:
                    input_setting[parent] = pv
                else:
                    fill(parent, pv)

        fill(output_var, output_var_value)
        for v in self.inputs:
            if v not in input_setting:
                input_setting[v] = self._rng.choice(self.values[v])
        return input_setting

    # -- dataset filters (reference causal_model.py:234-264) -----------------

    def get_path_maxlen_filter(self, lengths: Sequence[int]) -> Callable:
        def check(total_setting):
            inp = {v: total_setting[v] for v in self.inputs}
            paths = self.find_live_paths(inp)
            non_empty = [l for l in paths if paths[l]]
            return bool(non_empty) and max(non_empty) in set(lengths)
        return check

    def get_partial_filter(self, partial_setting: dict) -> Callable:
        def check(total_setting):
            return all(total_setting[v] == val
                       for v, val in partial_setting.items())
        return check

    def get_specific_path_filter(self, start: str, end: str) -> Callable:
        def check(total_setting):
            inp = {v: total_setting[v] for v in self.inputs}
            for paths in self.find_live_paths(inp).values():
                if any(p[0] == start and p[-1] == end for p in paths):
                    return True
            return False
        return check

    # -- array conversion -----------------------------------------------------

    def input_to_array(self, setting: dict) -> np.ndarray:
        """Concatenate input-variable values into one float32 vector
        (reference input_to_tensor, causal_model.py:266-273)."""
        return np.concatenate(
            [np.atleast_1d(np.asarray(setting[v], np.float32))
             for v in self.inputs])

    def output_to_array(self, setting: dict) -> np.ndarray:
        return np.concatenate(
            [np.atleast_1d(np.asarray(setting[v], np.float32))
             for v in self.outputs])

    # -- dataset generation ---------------------------------------------------

    def generate_factual_dataset(self, size: int, sampler=None, filter=None,
                                 return_arrays: bool = True):
        """``size`` (input, label) pairs.  Arrays mode returns
        {"input_ids": (size, d_in) f32, "labels": (size, d_out) f32} —
        stacked (reference causal_model.py:284-316 returns a
        list of per-example torch dicts instead)."""
        sampler = sampler or self.sample_input
        xs, ys, settings = [], [], []
        while len(xs) < size:
            inp = sampler()
            total = self.run_forward(inp)
            if filter is not None and not filter(total):
                continue
            xs.append(self.input_to_array(inp))
            ys.append(self.output_to_array(total))
            settings.append(total)
        if not return_arrays:
            return settings
        return {"input_ids": np.stack(xs), "labels": np.stack(ys)}

    def generate_counterfactual_dataset(self, size: int, intervention_id,
                                        batch_size: int = 1, sampler=None,
                                        intervention_sampler=None, filter=None,
                                        return_arrays: bool = True):
        """Interchange-intervention training data (reference
        causal_model.py:318-380): per example a BASE input, per-variable
        SOURCE inputs realizing a sampled intervention, the counterfactual
        label from ``run_interchange``, and ``intervention_id(intervention)``
        mapping the intervened variable set to an integer.

        Arrays mode returns stacked float32/int32 arrays:
        ``input_ids (size, d_in)``, ``source_input_ids (size, k, d_in)``
        (k = number of intermediate variables; unused slots zero-filled),
        ``labels / base_labels (size, d_out)``, ``intervention_id (size,)``.
        """
        sampler = sampler or self.sample_input_tree_balanced
        intervention_sampler = intervention_sampler or self.sample_intervention
        k = len([v for v in self.variables
                 if v not in self.inputs and v not in self.outputs])
        d_in = len(self.input_to_array(
            {v: self.values[v][0] for v in self.inputs}))

        bases, sources, labels, base_labels, iv_ids, raw = [], [], [], [], [], []
        while len(bases) < size:
            intervention = intervention_sampler()
            if filter is not None and not filter(intervention):
                continue
            for _ in range(min(batch_size, size - len(bases))):
                base = sampler()
                source_dic, source_rows = {}, []
                for var in self.variables:
                    if var not in intervention:
                        continue
                    src = self._sample_source(sampler, var, intervention[var])
                    source_dic[var] = src
                    source_rows.append(self.input_to_array(src))
                while len(source_rows) < k:
                    source_rows.append(np.zeros(d_in, np.float32))
                bases.append(self.input_to_array(base))
                sources.append(np.stack(source_rows))
                labels.append(self.output_to_array(
                    self.run_interchange(base, source_dic)))
                base_labels.append(self.output_to_array(
                    self.run_forward(base)))
                iv_ids.append(intervention_id(intervention))
                raw.append({"base": base, "sources": source_dic,
                            "intervention": dict(intervention)})
        if not return_arrays:
            return raw
        return {"input_ids": np.stack(bases),
                "source_input_ids": np.stack(sources),
                "labels": np.stack(labels),
                "base_labels": np.stack(base_labels),
                "intervention_id": np.asarray(iv_ids, np.int32)}

    def _sample_source(self, sampler, var, value):
        """Sample an input whose forward pass realizes var=value: use the
        sampler's targeted kwargs when supported (tree-balanced), otherwise
        rejection-sample (the reference assumes the targeted form,
        causal_model.py:354)."""
        try:
            return sampler(output_var=var, output_var_value=value)
        except TypeError:
            for _ in range(10_000):
                src = sampler()
                if self.run_forward(src)[var] == value:
                    return src
            raise ValueError(f"could not realize {var}={value!r} by sampling")
