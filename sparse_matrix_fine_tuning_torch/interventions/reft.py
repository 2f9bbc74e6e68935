"""ReFT activation interventions: pyreft's and pyvene's core for the port.

Counterpart of ``sparse_matrix_fine_tuning_tpu/interventions/reft.py``.  The
models expose ``layer_hooks`` (``models/llama.py``, ``models/roberta.py``,
``models/deberta.py``, ``models/toy.py``); ``ReftModel`` builds them from
the token positions of each intervention: gather the positions, apply the
intervention, scatter the change back.  The arithmetic is plain PyTorch, as
the JAX package computes it outside every Pallas kernel (gathers, small
products, a scatter-add and ``ops/blockdiag.blockdiag_multiply``).

Interventions (reference pyreft interventions.py:19-143, pyvene
models/interventions.py), with the JAX package's parameter names and
layouts, so that ``utils/jax_bridge.load_jax_state`` and the
``interventions.npz`` files carry them as they are:
  LoreftIntervention   h + R^T(act(W h + b) - R h)   R semi-orthogonal (d, r)
  NoreftIntervention   h + P^T(act(W h + b) - (P h + p_b))
  ConsreftIntervention h + R^T(b - R h)
  NoIntervention       identity (the MoRe production path)
  MoReIntervention     rotation and source are Monarch block-diagonal factors
and pyvene's interchange family (Vanilla, Addition, Subtraction, Collect,
the rotated-space DAS variants, Zero, Skip, PCA, Noise).

The port draws its own initial weights, from a CPU ``torch.Generator``
(``ReftModel``'s ``generator``, seeded 0 when None), and moves them to the
wrapped model's device, so that a card run and a CPU run of one seed start
alike; parity with the JAX package goes through the bridge.  Dropout
(Loreft, Noreft, MoRe) acts in ``train()``, as the JAX trainer switches
every ``nnx.Dropout`` on, and draws its masks from the intervention's own
CPU generator, so that the card draws the CPU's masks.

Parameters are float32.  Each module's ``adapter_params`` are the ones
that train (``peft/surgery.trainable_filter``, the JAX ``AdapterParam``);
the fixed state (temperatures, PCA bases, noise) is in persistent buffers.

Backpack's ``sense_network_output`` site (``models/backpack_gpt2.py``) is a
model-level site keyed by its name alone; its tensor is (b, nv, s, d), and a
token-position intervention applies to every sense's (b, s, d) slice at
the same positions (the JAX ``_lift_over_senses``); activations collected
there, and sources given to it, are (b, nv, p, d).  A model without a sense
network refuses the site when the ``ReftModel`` is built.
"""

from __future__ import annotations

import dataclasses
import inspect
import json
import os
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchFactor
from sparse_matrix_fine_tuning_torch.models.backpack_gpt2 import SENSE_SITE, BackpackSenseNetwork
from sparse_matrix_fine_tuning_torch.ops.blockdiag import blockdiag_multiply



def _identity(x):
    return x


def _ortho(shape, generator) -> torch.Tensor:
    """A (d, r) matrix with orthonormal columns (r <= d)."""
    return nn.init.orthogonal_(torch.empty(shape), generator=generator)


def _normal(shape, generator, std: float = 0.02) -> torch.Tensor:
    return torch.randn(shape, generator=generator) * std


class InterventionDropout(nn.Module):
    """``nnx.Dropout`` as the JAX trainer runs it: in ``train()`` each value
    is kept with probability 1 - rate and divided by it, else zeroed; the
    identity in ``eval()``.  The keep mask is drawn on the CPU from the
    module's own generator, seeded from one draw of ``generator``."""

    def __init__(self, rate: float, generator: torch.Generator):
        super().__init__()
        self.rate = float(rate)
        self.generator = torch.Generator().manual_seed(
            int(torch.randint(2 ** 62, (), generator=generator)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0:
            return x
        keep_prob = 1.0 - self.rate
        keep = torch.rand(x.shape, generator=self.generator) < keep_prob
        return torch.where(keep.to(x.device), x / keep_prob, torch.zeros((), dtype=x.dtype,
                                                                         device=x.device))


def _dropout(rate: float, generator) -> Optional[InterventionDropout]:
    return InterventionDropout(rate, generator) if rate > 0 else None


class LoreftIntervention(nn.Module):
    adapter_params = ("rotate", "w", "b")

    def __init__(self, embed_dim: int, low_rank_dimension: int, *, dropout: float = 0.0,
                 act_fn=None, generator: torch.Generator):
        super().__init__()
        self.rotate = nn.Parameter(_ortho((embed_dim, low_rank_dimension), generator))
        self.w = nn.Parameter(_normal((embed_dim, low_rank_dimension), generator))
        self.b = nn.Parameter(torch.zeros(low_rank_dimension))
        self.act_fn = act_fn or _identity
        self.dropout = _dropout(dropout, generator)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        R = self.rotate.to(h.dtype)
        src = self.act_fn(h @ self.w.to(h.dtype) + self.b.to(h.dtype))
        out = h + (src - h @ R) @ R.T
        return self.dropout(out) if self.dropout is not None else out


class NoreftIntervention(nn.Module):
    """h + P^T(act(W h + b) - (P h + p_b)): Loreft with an unconstrained
    projection; ``add_bias`` gates the projection's bias (reference pyreft
    interventions.py:62-82)."""

    adapter_params = ("proj", "proj_b", "w", "b")

    def __init__(self, embed_dim: int, low_rank_dimension: int, *, add_bias: bool = True,
                 dropout: float = 0.0, act_fn=None, generator: torch.Generator):
        super().__init__()
        self.proj = nn.Parameter(_normal((embed_dim, low_rank_dimension), generator))
        self.proj_b = (nn.Parameter(torch.zeros(low_rank_dimension))
                       if add_bias else None)
        self.w = nn.Parameter(_normal((embed_dim, low_rank_dimension), generator))
        self.b = nn.Parameter(torch.zeros(low_rank_dimension))
        self.act_fn = act_fn or _identity
        self.dropout = _dropout(dropout, generator)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        P = self.proj.to(h.dtype)
        proj_base = h @ P
        if self.proj_b is not None:
            proj_base = proj_base + self.proj_b.to(h.dtype)
        src = h @ self.w.to(h.dtype) + self.b.to(h.dtype)
        out = h + (self.act_fn(src) - proj_base) @ P.T
        # the reference drops the intervention's output (interventions.py:69,77)
        return self.dropout(out) if self.dropout is not None else out


class ConsreftIntervention(nn.Module):
    """h + R^T(b - R h); takes and ignores the shared keywords (dropout)."""

    adapter_params = ("rotate", "source")

    def __init__(self, embed_dim: int, low_rank_dimension: int, *,
                 generator: torch.Generator, **_):
        super().__init__()
        self.rotate = nn.Parameter(_ortho((embed_dim, low_rank_dimension), generator))
        self.source = nn.Parameter(torch.rand(low_rank_dimension, generator=generator)
                                   )

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        R = self.rotate.to(h.dtype)
        return h + (self.source.to(h.dtype) - h @ R) @ R.T


class NoIntervention(nn.Module):
    """Identity: the MoRe production path intervenes on nothing."""

    def __init__(self, embed_dim: int = 0, low_rank_dimension: int = 0, **_):
        super().__init__()

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return h


class MoReIntervention(nn.Module):
    """ReFT with Monarch factors: a blockwise-orthogonal rotation and a
    learned source, the inverse rotation by the rotation's transposed blocks
    (reference interventions.py:104-143)."""

    def __init__(self, embed_dim: int, low_rank_dimension: int, *, nblocks: int = 4,
                 dropout: float = 0.0, act_fn=None, generator: torch.Generator):
        super().__init__()
        blk_r = max(low_rank_dimension // nblocks, 1)
        kw = dict(nblocks=nblocks, blk_r=blk_r, device="cpu", generator=generator)
        self.rotate_layer = MonarchFactor(embed_dim, low_rank_dimension, ortho=True, **kw)
        self.learned_source = MonarchFactor(embed_dim, low_rank_dimension, **kw)
        self.act_fn = act_fn or _identity
        self.dropout = _dropout(dropout, generator)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        rotated = self.rotate_layer(h)
        delta = self.act_fn(self.learned_source(h)) - rotated
        w_t = self.rotate_layer.weight.transpose(-1, -2).to(h.dtype)
        out = h + blockdiag_multiply(delta, w_t)
        return self.dropout(out) if self.dropout is not None else out


def _subspace_mask(dim: int, subspaces, subspace_partition, dtype, device) -> torch.Tensor:
    """(dim,) 0/1 mask of the coordinates to swap: all of them (None), the
    given indices, or with ``subspace_partition`` the union of the given
    partitions' index groups."""
    if subspaces is None:
        return torch.ones(dim, dtype=dtype, device=device)
    if subspace_partition is not None:
        idx = [i for s in subspaces for i in subspace_partition[s]]
    else:
        idx = list(subspaces)
    mask = torch.zeros(dim, dtype=dtype, device=device)
    if idx:
        mask[torch.tensor(idx, device=device)] = 1
    return mask


class _Interchange(nn.Module):
    """Base of the stateless source interventions (subspace-aware)."""

    def __init__(self, embed_dim: int = 0, low_rank_dimension: int = 0, *,
                 subspace_partition=None, **_):
        super().__init__()
        self.subspace_partition = subspace_partition

    def _mask(self, h, subspaces):
        return _subspace_mask(h.shape[-1], subspaces, self.subspace_partition, h.dtype,
                              h.device)


class VanillaIntervention(_Interchange):
    """Replace the base's activations with the source's (pyvene's core
    interchange), used through ``ReftModel.swap_forward``."""

    def forward(self, h, source=None, subspaces=None):
        if source is None:
            return h
        return h + self._mask(h, subspaces) * (source.to(h.dtype) - h)


class AdditionIntervention(_Interchange):
    """base + source."""

    def forward(self, h, source=None, subspaces=None):
        if source is None:
            return h
        return h + self._mask(h, subspaces) * source.to(h.dtype)


class SubtractionIntervention(_Interchange):
    """base - source."""

    def forward(self, h, source=None, subspaces=None):
        if source is None:
            return h
        return h - self._mask(h, subspaces) * source.to(h.dtype)


class CollectIntervention(nn.Module):
    """Leaves the activations as they are (``collect_activations`` gathers)."""

    def __init__(self, embed_dim: int = 0, low_rank_dimension: int = 0, **_):
        super().__init__()

    def forward(self, h, source=None):
        return h


def _cayley_rotation(free: torch.Tensor, dtype) -> torch.Tensor:
    """An exactly orthogonal (d, d) rotation: the Cayley transform of the
    skew-symmetric part of ``free``, in float32."""
    a = free.float()
    skew = (a - a.T) / 2
    eye = torch.eye(a.shape[0], dtype=torch.float32, device=a.device)
    return torch.linalg.solve(eye + skew, eye - skew).to(dtype)


class RotatedSpaceIntervention(nn.Module):
    """DAS's interchange in a full rotated space (pyvene
    models/interventions.py:252-278): rotate base and source, swap the
    selected coordinates, rotate back; R the Cayley transform of a free
    parameter."""

    adapter_params = ("skew",)

    def __init__(self, embed_dim: int, low_rank_dimension: int = 0, *, subspace_partition=None,
                 generator: torch.Generator, **_):
        super().__init__()
        self.skew = nn.Parameter(_normal((embed_dim, embed_dim), generator, 0.01))
        self.subspace_partition = subspace_partition

    def forward(self, h, source=None, subspaces=None):
        if source is None:
            return h
        R = _cayley_rotation(self.skew, h.dtype)
        rb, rs = h @ R, source.to(h.dtype) @ R
        mask = _subspace_mask(h.shape[-1], subspaces, self.subspace_partition, h.dtype,
                              h.device)
        return (rb + (rs - rb) * mask) @ R.T


class LowRankRotatedSpaceIntervention(nn.Module):
    """DAS over r semi-orthogonal directions (pyvene models/interventions.py:
    396-448): the QR of a free (d, r) parameter, signs fixed by R's
    diagonal."""

    adapter_params = ("free",)

    def __init__(self, embed_dim: int, low_rank_dimension: int, *, subspace_partition=None,
                 generator: torch.Generator, **_):
        super().__init__()
        self.free = nn.Parameter(_ortho((embed_dim, low_rank_dimension), generator))
        self.low_rank_dimension = low_rank_dimension
        self.subspace_partition = subspace_partition

    def _rotation(self, dtype) -> torch.Tensor:
        q, r = torch.linalg.qr(self.free.float())
        return (q * torch.sign(torch.diagonal(r))[None, :]).to(dtype)

    def forward(self, h, source=None, subspaces=None):
        if source is None:
            return h
        R = self._rotation(h.dtype)
        diff = (source.to(h.dtype) - h) @ R
        mask = _subspace_mask(self.low_rank_dimension, subspaces, self.subspace_partition,
                              h.dtype, h.device)
        return h + (diff * mask) @ R.T


class ZeroIntervention(_Interchange):
    """Zero the selected coordinates of the base; needs no source."""

    def forward(self, h, source=None, subspaces=None):
        return h * (1 - self._mask(h, subspaces))


class SkipIntervention(_Interchange):
    """Skip the hooked block: interchange its output with the same
    example's input to it, which ``ReftModel._hooks`` captures (pyvene
    models/interventions.py:166-186)."""

    def forward(self, h, source=None, subspaces=None):
        if source is None:
            return h
        return h + (source.to(h.dtype) - h) * self._mask(h, subspaces)


class _Annealed(nn.Module):
    """A temperature buffer that a trainer anneals (``set_temperature``)."""

    def set_temperature(self, temp: float) -> None:
        self.temperature.fill_(temp)


class BoundlessRotatedSpaceIntervention(_Annealed):
    """Boundless DAS (pyvene models/interventions.py:281-326): the rotated
    interchange through a soft boundary mask, its boundary fraction trained
    (init 0.5), its temperature annealed (init 50)."""

    adapter_params = ("skew", "intervention_boundaries")

    def __init__(self, embed_dim: int, low_rank_dimension: int = 0, *,
                 generator: torch.Generator, **_):
        super().__init__()
        self.skew = nn.Parameter(_normal((embed_dim, embed_dim), generator, 0.01))
        self.intervention_boundaries = nn.Parameter(torch.tensor([0.5]))
        self.register_buffer("temperature", torch.tensor(50.0))
        self.embed_dim = embed_dim

    def forward(self, h, source=None, subspaces=None):
        if source is None:
            return h
        R = _cayley_rotation(self.skew, h.dtype)
        rb, rs = h @ R, source.to(h.dtype) @ R
        boundary = self.intervention_boundaries.float().clamp(1e-3, 1.0)
        pos = torch.arange(self.embed_dim, dtype=torch.float32, device=h.device)
        temp = self.temperature
        mask = (torch.sigmoid((pos - 0.0) / temp)
                * torch.sigmoid((boundary[0] * self.embed_dim - pos) / temp))
        return (rb + (rs - rb) * mask.to(h.dtype)) @ R.T


class SigmoidMaskRotatedSpaceIntervention(_Annealed):
    """The rotated interchange through a learned per-coordinate sigmoid mask
    (pyvene models/interventions.py:328-365): masks init 100, temperature
    50."""

    adapter_params = ("skew", "masks")

    def __init__(self, embed_dim: int, low_rank_dimension: int = 0, *,
                 generator: torch.Generator, **_):
        super().__init__()
        self.skew = nn.Parameter(_normal((embed_dim, embed_dim), generator, 0.01))
        self.masks = nn.Parameter(torch.full((embed_dim,), 100.0))
        self.register_buffer("temperature", torch.tensor(50.0))

    def forward(self, h, source=None, subspaces=None):
        if source is None:
            return h
        R = _cayley_rotation(self.skew, h.dtype)
        rb, rs = h @ R, source.to(h.dtype) @ R
        mask = torch.sigmoid(self.masks.float() / self.temperature)
        return (rb + (rs - rb) * mask.to(h.dtype)) @ R.T


class SigmoidMaskIntervention(_Annealed):
    """Interchange in the original basis through a learned sigmoid mask
    (pyvene models/interventions.py:367-394): mask init 0, temperature
    0.01."""

    adapter_params = ("mask",)

    def __init__(self, embed_dim: int, low_rank_dimension: int = 0, *,
                 generator: Optional[torch.Generator] = None, **_):
        super().__init__()
        self.mask = nn.Parameter(torch.zeros(embed_dim))
        self.register_buffer("temperature", torch.tensor(0.01))

    def forward(self, h, source=None, subspaces=None):
        if source is None:
            return h
        sig = torch.sigmoid(self.mask.float() / self.temperature).to(h.dtype)
        return (1 - sig) * h + sig * source.to(h.dtype)


class PCARotatedSpaceIntervention(nn.Module):
    """Interchange in a fixed PCA basis (pyvene models/interventions.py:
    448-485): standardise, project on the components, swap, project back,
    de-standardise.  Nothing trains."""

    def __init__(self, embed_dim: int = 0, low_rank_dimension: int = 0, *,
                 pca_components=None, pca_mean=None, pca_std=None, subspace_partition=None,
                 **_):
        super().__init__()
        if pca_components is None or pca_mean is None or pca_std is None:
            raise ValueError(
                "PCARotatedSpaceIntervention needs the fitted basis: pass pca_components "
                "(r, d), pca_mean (d,), pca_std (d,) in the representation dict")
        for name, value in (("components", pca_components), ("mean", pca_mean),
                            ("std", pca_std)):
            self.register_buffer(name, torch.as_tensor(np.asarray(value, np.float32)))
        self.subspace_partition = subspace_partition

    def forward(self, h, source=None, subspaces=None):
        if source is None:
            return h
        comps, mean, std = (t.to(h.dtype) for t in (self.components, self.mean, self.std))
        rb = ((h - mean) / std) @ comps.T
        rs = ((source.to(h.dtype) - mean) / std) @ comps.T
        mask = _subspace_mask(comps.shape[0], subspaces, self.subspace_partition, h.dtype,
                              h.device)
        return ((rb + (rs - rb) * mask) @ comps) * std + mean


class NoiseIntervention(nn.Module):
    """Add a fixed Gaussian pattern to the gathered positions (pyvene
    models/interventions.py:487-505, ROME's corruption: drawn once from
    ``np.random.RandomState(1)``, shape (1, positions, d), times
    ``noise_level``)."""

    def __init__(self, embed_dim: int, low_rank_dimension: int = 0, *, positions: int = 4,
                 noise_level: float = 0.13462981581687927, **_):
        super().__init__()
        noise = np.random.RandomState(1).randn(1, positions, embed_dim).astype(np.float32)
        self.register_buffer("noise", torch.from_numpy(noise))
        self.noise_level = float(noise_level)

    def forward(self, h, source=None, subspaces=None):
        level = torch.tensor(self.noise_level, dtype=h.dtype, device=h.device)
        return h + self.noise.to(h.dtype) * level


INTERVENTION_TYPES = {
    "LoreftIntervention": LoreftIntervention,
    "NoreftIntervention": NoreftIntervention,
    "ConsreftIntervention": ConsreftIntervention,
    "NoIntervention": NoIntervention,
    "Nothing": NoIntervention,
    "MoReIntervention": MoReIntervention,
    "VanillaIntervention": VanillaIntervention,
    "AdditionIntervention": AdditionIntervention,
    "SubtractionIntervention": SubtractionIntervention,
    "CollectIntervention": CollectIntervention,
    "RotatedSpaceIntervention": RotatedSpaceIntervention,
    "LowRankRotatedSpaceIntervention": LowRankRotatedSpaceIntervention,
    "ZeroIntervention": ZeroIntervention,
    "SkipIntervention": SkipIntervention,
    "BoundlessRotatedSpaceIntervention": BoundlessRotatedSpaceIntervention,
    "SigmoidMaskRotatedSpaceIntervention": SigmoidMaskRotatedSpaceIntervention,
    "SigmoidMaskIntervention": SigmoidMaskIntervention,
    "PCARotatedSpaceIntervention": PCARotatedSpaceIntervention,
    "NoiseIntervention": NoiseIntervention,
}

# interventions whose edit is a function of a source example's activations
# (SkipIntervention's source is the same example's block input, never a
# source example)
SOURCE_BASED = (VanillaIntervention, AdditionIntervention, SubtractionIntervention,
                RotatedSpaceIntervention, LowRankRotatedSpaceIntervention,
                BoundlessRotatedSpaceIntervention, SigmoidMaskRotatedSpaceIntervention,
                SigmoidMaskIntervention, PCARotatedSpaceIntervention)


@dataclasses.dataclass
class ReftConfig:
    """representations: dicts of ``layer``, ``component`` (default
    "block_output"), ``intervention`` (a name or a class; default
    NoIntervention), ``low_rank_dimension`` (default 4) and the class's own
    keywords (reference pyreft config.py:4-30)."""
    representations: Sequence[dict] = ()


def _subspaces_for(subspaces, i):
    """Intervention i's subspaces: None, a flat int list shared by all, or
    one list (or None) for each intervention."""
    if subspaces is None:
        return None
    if all(isinstance(s, int) for s in subspaces):
        return list(subspaces)
    return subspaces[i]


def _bind_subspaces(iv, sub):
    """``iv`` with its subspace selection bound; a class that takes none
    raises here, when the hooks are built."""
    if sub is None:
        return iv
    if "subspaces" not in inspect.signature(type(iv).forward).parameters:
        raise ValueError(f"{type(iv).__name__} does not support subspaces; use a "
                         "subspace-aware intervention (Vanilla/Addition/Subtraction/"
                         "RotatedSpace family)")
    return lambda h, source=None: iv(h, source=source, subspaces=sub)


def _chain(prev, fn):
    """Two hooks of one site in registration order."""
    return lambda x: fn(prev(x))


def _over_senses(fn, x: torch.Tensor, locations: torch.Tensor, source=None):
    """``fn(rows, locations, source)`` on the (b * nv, s, d) rows of a
    (b, nv, s, d) sense tensor, each sense at its example's positions;
    (b, nv, ...) back."""
    b, nv = x.shape[:2]
    rows = fn(x.reshape(b * nv, *x.shape[2:]), locations.repeat_interleave(nv, 0),
              None if source is None else source.reshape(b * nv, *source.shape[2:]))
    return rows.reshape(b, nv, *rows.shape[1:])


def gather_positions(x: torch.Tensor, locations: torch.Tensor) -> torch.Tensor:
    """(b, t, d) gathered at (b, p) positions -> (b, p, d); a -1 pad reads
    position 0 (pyvene gather_neurons)."""
    safe = locations.clamp_min(0).long()
    return torch.gather(x, 1, safe[..., None].expand(*safe.shape, x.shape[-1]))


def apply_at_positions(x: torch.Tensor, locations: torch.Tensor, fn, source=None
                       ) -> torch.Tensor:
    """Gather the positions, intervene, scatter the change back.

    x: (b, t, d); locations: (b, p) with -1 pads; source: optional (b, p, d)
    source activations.  The change is added out of place, summed where a
    position repeats (as JAX's ``.at[].add``); a -1 pad adds zero at
    position 0."""
    gathered = gather_positions(x, locations)
    edited = fn(gathered, source) if source is not None else fn(gathered)
    keep = (locations >= 0)[..., None]
    delta = torch.where(keep, edited - gathered, torch.zeros((), dtype=edited.dtype,
                                                             device=x.device))
    safe = locations.clamp_min(0).long()
    rows = torch.arange(x.shape[0], device=x.device)[:, None].expand_as(safe)
    return x.index_put((rows, safe), delta.to(x.dtype), accumulate=True)


class ReftModel(nn.Module):
    """A model with position-indexed interventions at its hook sites (what
    the MoRe flows use of pyvene's IntervenableModel, reference
    reft_model.py:9-55).

    Args:
      model: a model of the port with ``layer_hooks`` and ``config``.
      config: ``ReftConfig``.
      generator: CPU ``torch.Generator`` for the interventions' initial
        weights and dropout seeds; seeded 0 when None.
    The interventions' parameters are float32, moved to the model's
    device.
    """

    def __init__(self, model: nn.Module, config: ReftConfig, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.model = model
        embed_dim = model.config.hidden_size
        device = next(model.parameters()).device
        layers, components, interventions = [], [], []
        for rep in config.representations:
            comp = rep.get("component", "block_output")
            if comp == SENSE_SITE and not any(isinstance(m, BackpackSenseNetwork)
                                              for m in model.modules()):
                raise ValueError(f"the {SENSE_SITE} site is Backpack-GPT-2's: "
                                 f"{type(model).__name__} has no sense network")
            cls = rep.get("intervention", "NoIntervention")
            if isinstance(cls, str):
                cls = INTERVENTION_TYPES[cls]
            kw = {k: v for k, v in rep.items() if k not in ("layer", "component", "intervention")}
            kw.setdefault("low_rank_dimension", 4)
            iv = (NoIntervention() if cls is NoIntervention
                  else cls(embed_dim, generator=generator, **kw))
            interventions.append(iv.to(device))
            layers.append(int(rep["layer"]))
            components.append(comp)
        self.intervention_layers = tuple(layers)
        self.intervention_components = tuple(components)
        self.interventions = nn.ModuleList(interventions)

    @property
    def config(self):
        return self.model.config

    def _key(self, i):
        layer, comp = self.intervention_layers[i], self.intervention_components[i]
        if comp == SENSE_SITE:
            return comp  # a model-level site, named alone
        return layer if comp == "block_output" else (layer, comp)

    @staticmethod
    def _locs(intervention_locations, i):
        return intervention_locations[:, min(i, intervention_locations.shape[1] - 1)]

    def _hooks(self, intervention_locations, sources=None, subspaces=None) -> dict:
        """{site: fn} for (b, num_interventions, p) locations; ``sources``:
        optional {i: (b, p, d)} source activations; ``subspaces`` as
        ``_subspaces_for``.  Hooks of one site chain in registration order,
        and a SkipIntervention's capture after every edit at its site."""
        hooks = {}
        pending_captures = []
        for i, iv in enumerate(self.interventions):
            if isinstance(iv, NoIntervention):
                continue
            locs = self._locs(intervention_locations, i)
            sub = _subspaces_for(subspaces, i)
            if isinstance(iv, SkipIntervention):
                pending_captures.append(self._add_skip_hooks(hooks, iv, i, locs, sub))
                continue
            src = (sources or {}).get(i)
            bound = _bind_subspaces(iv, sub)

            def at_positions(x, locs, src, bound=bound):
                return apply_at_positions(x, locs, bound, source=src)

            def fn(x, at=at_positions, locs=locs, src=src,
                   senses=self.intervention_components[i] == SENSE_SITE):
                return _over_senses(at, x, locs, src) if senses else at(x, locs, src)
            prev = hooks.get(self._key(i))
            hooks[self._key(i)] = fn if prev is None else _chain(prev, fn)
        for cap_key, capture in pending_captures:
            prev = hooks.get(cap_key)
            hooks[cap_key] = capture if prev is None else _chain(prev, capture)
        return hooks

    def _add_skip_hooks(self, hooks, iv, i, locs, sub=None):
        """Register a SkipIntervention's hook; return (site, capture) for the
        caller to chain last at the capture site: block L-1's output, or the
        embeddings at (0, "block_input") for L = 0."""
        layer, comp = self.intervention_layers[i], self.intervention_components[i]
        if comp != "block_output":
            raise NotImplementedError(
                "SkipIntervention is supported at component='block_output' (got "
                f"{comp!r}): its source is the block's input, which the engine captures at "
                "the previous block's output")
        if layer == 0 and getattr(self.model.config, "remat", False):
            raise NotImplementedError(
                "SkipIntervention at layer 0 of a remat'd model: the embeddings capture runs "
                "inside the rematerialized block and cannot escape to the block-output site; "
                "disable remat or skip a later layer")
        cap = {}

        def capture(x):
            cap["src"] = gather_positions(x, locs)
            return x

        def skip_fn(x):
            assert "src" in cap, "SkipIntervention's capture did not run before its site"
            return apply_at_positions(x, locs, _bind_subspaces(iv, sub), source=cap["src"])

        prev = hooks.get(layer)
        hooks[layer] = skip_fn if prev is None else _chain(prev, skip_fn)
        return ((0, "block_input") if layer == 0 else layer - 1), capture

    def collect_activations(self, input_ids, locations, attention_mask=None, **kw) -> dict:
        """A forward that gathers each intervention site's activations at
        ``locations`` (b, num_interventions, p): {i: (b, p, d)}, (b, nv, p, d)
        at the sense site."""
        collected, hooks = {}, {}
        for i in range(len(self.interventions)):
            def fn(x, i=i, locs=self._locs(locations, i),
                   senses=self.intervention_components[i] == SENSE_SITE):
                collected[i] = (_over_senses(lambda r, l, _: gather_positions(r, l), x, locs)
                                if senses else gather_positions(x, locs))
                return x
            prev = hooks.get(self._key(i))
            hooks[self._key(i)] = fn if prev is None else _chain(prev, fn)
        self.model(input_ids, attention_mask=attention_mask, layer_hooks=hooks, **kw)
        return collected

    def swap_forward(self, base_ids, source_ids, *, base_locations, source_locations,
                     base_mask=None, source_mask=None, subspaces=None, **kw):
        """pyvene's source -> base interchange: the source example's
        activations at ``source_locations`` enter the base forward at
        ``base_locations``, as each intervention combines them."""
        sources = self.collect_activations(source_ids, source_locations,
                                           attention_mask=source_mask, **kw)
        hooks = self._hooks(base_locations, sources=sources, subspaces=subspaces)
        return self.model(base_ids, attention_mask=base_mask, layer_hooks=hooks, **kw)

    def _state(self, i: int) -> dict:
        iv = self.interventions[i]
        return {**dict(iv.named_parameters()), **dict(iv.named_buffers())}

    @staticmethod
    def _npz_key(i: int, name: str) -> str:
        """The JAX package's key: ``{i}/`` the path joined by "/", then
        ``/.value``."""
        return f"{i}/{name.replace('.', '/')}/.value"

    def save_interventions(self, directory: str) -> None:
        """``interventions.npz`` (float32 parameters and buffers, the JAX
        package's keys) and ``intervenable_config.json``, files each package
        reads."""
        os.makedirs(directory, exist_ok=True)
        arrays = {self._npz_key(i, name): t.detach().float().cpu().numpy()
                  for i in range(len(self.interventions)) for name, t in self._state(i).items()}
        np.savez(os.path.join(directory, "interventions.npz"), **arrays)
        meta = [{"layer": l, "component": c, "intervention": type(iv).__name__}
                for l, c, iv in zip(self.intervention_layers, self.intervention_components,
                                    self.interventions)]
        with open(os.path.join(directory, "intervenable_config.json"), "w") as f:
            json.dump(meta, f, indent=1)

    @torch.no_grad()
    def load_interventions(self, directory: str) -> None:
        """Copy an ``interventions.npz`` into the interventions' parameters and
        buffers of the same keys; a key the file lacks keeps its value."""
        from sparse_matrix_fine_tuning_torch.utils.jax_bridge import _as_float_array

        with np.load(os.path.join(directory, "interventions.npz")) as data:
            for i in range(len(self.interventions)):
                for name, t in self._state(i).items():
                    key = self._npz_key(i, name)
                    if key in data.files:
                        arr = _as_float_array(np.array(data[key]))
                        if tuple(arr.shape) != tuple(t.shape):
                            raise ValueError(f"{key}: shape {arr.shape}, the intervention's "
                                             f"{tuple(t.shape)}")
                        t.copy_(torch.from_numpy(arr).to(t.dtype))

    def forward(self, input_ids, attention_mask=None, intervention_locations=None,
                subspaces=None, **kw):
        hooks = (self._hooks(intervention_locations, subspaces=subspaces)
                 if intervention_locations is not None else None)
        # a caller's pre-built hooks (generate's prefill) join them
        extern = kw.pop("layer_hooks", None)
        if extern:
            hooks = {**(hooks or {}), **extern}
        return self.model(input_ids, attention_mask=attention_mask, layer_hooks=hooks, **kw)

    def loss(self, logits, labels, **kw):
        return self.model.loss(logits, labels, **kw)


def get_reft_model(model: nn.Module, reft_config: ReftConfig, *,
                   generator: Optional[torch.Generator] = None) -> ReftModel:
    """reference pyreft.get_reft_model (utils.py:19-44)."""
    return ReftModel(model, reft_config, generator=generator)
