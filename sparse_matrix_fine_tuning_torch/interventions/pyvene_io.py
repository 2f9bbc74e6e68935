"""Intervention checkpoints in the reference's pyvene format, in and out.

Counterpart of ``sparse_matrix_fine_tuning_tpu/interventions/pyvene_io.py``.
``IntervenableModel.save`` writes one ``intkey_layer.{l}.comp.{c}.unit.{u}
.nunit.{n}#{k}.bin`` torch state_dict per trainable intervention (reference
intervenable_base.py:379-440); the pyreft interventions store their
materialised rotation (reference pyreft interventions.py:39-57, 125-143):

* Loreft:   ``rotate_layer`` (d, r) -> rotate; ``weight`` (r, d) -> w.T;
  ``bias`` -> b
* Noreft:   the module's own state_dict: ``proj_layer`` and
  ``learned_source`` Linears (weights (r, d), transposed into proj and w)
* Consreft: ``learned_source`` -> source; the rotation is parametrised
  (``rotate_layer.parametrizations.weight.{original,0.base}``) and is
  materialised by loading it into a module under
  ``torch.nn.utils.parametrizations.orthogonal``, as the reference reloads
  it
* MoRe:     ``weight`` (the learned source's blocks) ->
  learned_source.weight; ``rotate_layer`` (the rotation's blocks) ->
  rotate_layer.weight

Stateless interventions have no file.  ``save_pyvene_interventions`` writes
the same files from a ``ReftModel``, for a reference ``IntervenableModel``'s
``load_intervention``.  Files are read with ``weights_only=True``.  (The
packages' own format is ``ReftModel.save_interventions``, npz.)
"""

from __future__ import annotations

import os
import re

import torch

__all__ = ["load_pyvene_interventions", "save_pyvene_interventions"]

_FNAME = re.compile(
    r"intkey_layer\.(\d+)\.comp\.([\w.]+)\.unit\.\w+\.nunit\.\d+#(\d+)\.bin$")


@torch.no_grad()
def _set(param: torch.Tensor, value: torch.Tensor, what: str) -> None:
    if tuple(param.shape) != tuple(value.shape):
        raise ValueError(
            f"shape mismatch for {what}: checkpoint {tuple(value.shape)} vs model "
            f"{tuple(param.shape)} -- was the ReftModel built with the same representations "
            "(layer/intervention/low_rank_dimension)?")
    param.copy_(value.detach().to(param.dtype))


def _orthogonal_module(d: int, r: int) -> torch.nn.Module:
    """A (d, r) weight under ``parametrizations.orthogonal``, the
    reference's RotateLayer."""
    class _W(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.weight = torch.nn.Parameter(torch.empty(d, r))

    return torch.nn.utils.parametrizations.orthogonal(_W())


def _materialize_orthogonal(sd, prefix: str) -> torch.Tensor:
    """The rotation a saved ``parametrizations.orthogonal`` state stands for."""
    orig = sd[f"{prefix}.parametrizations.weight.original"]
    mod = _orthogonal_module(*orig.shape)
    state = {"parametrizations.weight.original": orig}
    base_key = f"{prefix}.parametrizations.weight.0.base"
    if base_key in sd:
        state["parametrizations.weight.0.base"] = sd[base_key]
    mod.load_state_dict(state, strict=False)
    with torch.no_grad():
        return mod.weight.float()


def _apply(iv, sd, key: str) -> None:
    """One reference state_dict onto its intervention."""
    from sparse_matrix_fine_tuning_torch.interventions.reft import (
        ConsreftIntervention,
        LoreftIntervention,
        MoReIntervention,
        NoreftIntervention,
    )
    if isinstance(iv, LoreftIntervention):
        _set(iv.rotate, sd["rotate_layer"], f"{key}: rotate")
        _set(iv.w, sd.get("learned_source.weight", sd["weight"]).T, f"{key}: w")
        _set(iv.b, sd.get("learned_source.bias", sd["bias"]), f"{key}: b")
    elif isinstance(iv, NoreftIntervention):
        _set(iv.proj, sd["proj_layer.weight"].T, f"{key}: proj")
        if "proj_layer.bias" in sd and iv.proj_b is not None:
            _set(iv.proj_b, sd["proj_layer.bias"], f"{key}: proj_b")
        _set(iv.w, sd["learned_source.weight"].T, f"{key}: w")
        _set(iv.b, sd["learned_source.bias"], f"{key}: b")
    elif isinstance(iv, ConsreftIntervention):
        _set(iv.source, sd["learned_source"], f"{key}: source")
        _set(iv.rotate, _materialize_orthogonal(sd, "rotate_layer"), f"{key}: rotate")
    elif isinstance(iv, MoReIntervention):
        _set(iv.learned_source.weight, sd.get("learned_source.weight", sd["weight"]),
             f"{key}: learned_source")
        b = sd.get("learned_source.bias", sd.get("bias"))
        if b is not None and iv.learned_source.bias is not None:
            _set(iv.learned_source.bias, b, f"{key}: bias")
        _set(iv.rotate_layer.weight, sd["rotate_layer"], f"{key}: rotate")
    else:
        raise KeyError(f"no import mapping for {type(iv).__name__} (checkpoint {key})")


def _sites(reft_model):
    """(intervention, layer, component, k) in registration order, k counting
    the earlier interventions at the same (layer, component) (pyvene's
    ``#k``)."""
    counters = {}
    for iv, layer, comp in zip(reft_model.interventions, reft_model.intervention_layers,
                               reft_model.intervention_components):
        k = counters.get((layer, comp), 0)
        counters[(layer, comp)] = k + 1
        yield iv, layer, comp, k


def load_pyvene_interventions(reft_model, directory: str, *,
                              strict: bool = True) -> tuple[list[str], list[str]]:
    """Load a reference ``IntervenableModel.save`` directory into a
    ``ReftModel`` built with the same representations, file by (layer,
    component, #k).  Returns (loaded files, skipped files); with ``strict``
    a file that fits no intervention raises."""
    by_site = {}
    for fname in sorted(os.listdir(directory)):
        m = _FNAME.match(fname)
        if m:
            by_site[(int(m.group(1)), m.group(2), int(m.group(3)))] = fname
    loaded, skipped = [], []
    for iv, layer, comp, k in _sites(reft_model):
        fname = by_site.pop((layer, comp, k), None)
        if fname is None:
            continue  # stateless interventions have no file
        sd = torch.load(os.path.join(directory, fname), map_location="cpu", weights_only=True)
        try:
            _apply(iv, sd, fname)
        except KeyError:
            if strict:
                raise
            skipped.append(fname)
            continue
        loaded.append(fname)
    if by_site:
        stray = sorted(by_site.values())
        if strict:
            raise KeyError(f"checkpoint files with no matching intervention: {stray} -- build "
                           "the ReftModel with the same representations")
        skipped.extend(stray)
    return loaded, skipped


def _pyvene_key(layer: int, comp: str, k: int) -> str:
    """pyvene's key for pyreft's default config (unit "pos", one unit;
    reference intervenable_base.py:209-226)."""
    return f"layer.{layer}.comp.{comp}.unit.pos.nunit.1#{k}"


def _buffers(d: int) -> dict:
    return {"embed_dim": torch.tensor(d), "interchange_dim": torch.tensor(d)}


def _parametrized_rotation(R: torch.Tensor) -> dict:
    """A (d, r) rotation as the ``parametrizations.orthogonal`` state that
    torch's strict ``load_state_dict`` expects, through the
    parametrisation's own right inverse."""
    mod = _orthogonal_module(*R.shape)
    with torch.no_grad():
        mod.weight = R
    return {f"rotate_layer.{k}": v for k, v in mod.state_dict().items()}


def _export(iv):
    """One intervention's reference state_dict (float32, on the CPU)."""
    from sparse_matrix_fine_tuning_torch.interventions.reft import (
        ConsreftIntervention,
        LoreftIntervention,
        MoReIntervention,
        NoreftIntervention,
    )

    def t(x):
        return x.detach().float().cpu().clone()

    # Loreft and MoRe: the reference saves the learned source under bare
    # "weight"/"bias" keys, which its own reload (interventions.py:49-57)
    # never matches; both spellings go out, so that its loader restores the
    # learned source too
    if isinstance(iv, LoreftIntervention):
        w = t(iv.w).T.contiguous()
        return {"weight": w, "bias": t(iv.b), "learned_source.weight": w,
                "learned_source.bias": t(iv.b), "rotate_layer": t(iv.rotate)}
    if isinstance(iv, MoReIntervention):
        w = t(iv.learned_source.weight)
        sd = {"weight": w, "learned_source.weight": w,
              "rotate_layer": t(iv.rotate_layer.weight)}
        if iv.learned_source.bias is not None:
            sd["bias"] = sd["learned_source.bias"] = t(iv.learned_source.bias)
        return sd
    if isinstance(iv, NoreftIntervention):
        sd = {"proj_layer.weight": t(iv.proj).T.contiguous(),
              "learned_source.weight": t(iv.w).T.contiguous(),
              "learned_source.bias": t(iv.b), **_buffers(iv.proj.shape[0])}
        if iv.proj_b is not None:
            sd["proj_layer.bias"] = t(iv.proj_b)
        return sd
    if isinstance(iv, ConsreftIntervention):
        R = t(iv.rotate)
        return {"learned_source": t(iv.source), **_buffers(R.shape[0]),
                **_parametrized_rotation(R)}
    return None  # stateless: the reference writes no file either


def save_pyvene_interventions(reft_model, directory: str) -> list[str]:
    """Write the ``ReftModel``'s interventions as the reference's
    ``intkey_*.bin`` files, for ``load_intervention(directory,
    include_model=False)`` (reference intervenable_base.py:543-558).
    Returns the file names."""
    os.makedirs(directory, exist_ok=True)
    written = []
    for iv, layer, comp, k in _sites(reft_model):
        sd = _export(iv)
        if sd is None:
            continue
        fname = f"intkey_{_pyvene_key(layer, comp, k)}.bin"
        torch.save(sd, os.path.join(directory, fname))
        written.append(fname)
    return written
