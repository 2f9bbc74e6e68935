"""Sharding rules: FSDP2 for the frozen base, Megatron tensor parallelism
over DTensor, replicated adapters.

Counterpart of ``sparse_matrix_fine_tuning_tpu/parallel/sharding.py`` and of
the JAX trainer's mesh block (trainer.py:224-237).

``param_spec`` is JAX's placement rule, a pure function of a parameter's
shape, dtype and name and the mesh's fsdp and tp sizes:

* fsdp: the largest dimension that the axis divides is sharded; below
  ``_MIN_SHARD_ELEMS`` (2^16 elements) the parameter is replicated;
* tp: column-parallel names (``_TP_COL``: q/k/v/gate/up and lm_head) shard
  their output features, row-parallel ones (``_TP_ROW``: o/down) their
  input features; a tp dimension that tp does not divide backs off to the
  fsdp placement alone.

Orientation: every weight of the port, ``lm_head`` included, is (out, in)
as ``F.linear`` takes it, where JAX's ``nnx.Linear.kernel`` is (in, out).
Names are the JAX paths of ``training/adam8bit.jax_paths`` (a linear's
weight ends in ``kernel``): for a ``kernel`` the rule is JAX's on the
transposed shape, transposed back, so the two packages place the same
physical dimension, ties in the fsdp choice included.  A MonarchLinear
``dense`` is (out, in) in both; a quantized one (int8/uint8) in-major in
both.  A spec is a tuple of "fsdp", "tp" or None a dimension, ``()`` where
replicated (JAX's ``P()``).

``shard_model(model, mesh)`` places a model as the JAX trainer places its
state: the frozen parameters by ``param_spec`` (FSDP2's ``fully_shard`` over
the mesh's "fsdp" axis, a unit each decoder layer and the model; the
dimension from ``shard_placement_fn``; those it leaves whole in
``ignored_params``), the tp dimension as a DTensor ``Shard`` over "tp";
the trainable parameters (adapters, Scalers, the trainable extras) and so
the optimizer's state stay replicated plain tensors (JAX's
``shard_state(..., replicate=True)``).  Trainability is ``requires_grad``
(``peft/surgery.trainable_filter`` first, as the Trainer does).

Tensor parallelism is the Llama's (``models/llama.py``): q/k/v/o and
gate/up/down of every layer, and a frozen ``lm_head``, whose logits are
gathered over the vocabulary.  The attention runs the rank's heads, so tp
must divide the kv heads; it must divide the MLP width too.  Every kernel
gets the rank's plain local tensors (``local``); how each adapted layer
splits its Monarch term is in ``layers/monarch_linear.py``.  The adapters'
gradients in a tensor-parallel layer are partial sums over tp (each peer
sees its columns or its input slice); ``sync_gradients`` sums them over tp
and averages every trainable gradient over the data ranks before the
clipping and the step.

Refused: a quantized (int8/int4) base under a mesh of more than one rank
(``ITEM_28B``); a one-rank mesh over one runs it as unsharded.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from sparse_matrix_fine_tuning_torch.parallel.annotate import TensorParallel, tensor_parallel

ITEM_28B = ("ROADMAP.md queue A item 28b, 'The quantized base under a mesh of more than one "
            "rank'")

# Below this size it is cheaper to replicate than to gather (fsdp only; the
# tp rules always apply: tp partitions compute, not just memory).
_MIN_SHARD_ELEMS = 1 << 16

# Column-parallel (output features) and row-parallel (input features) names,
# per Megatron: the column -> row pairing keeps the activation sharded over
# tp between the two products of attention and of the MLP.
_TP_COL = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj", "lm_head")
_TP_ROW = ("o_proj", "down_proj")


def _tp_dim(name: str, shape, tp_size: int, in_major: bool) -> Optional[int]:
    """JAX's ``_tp_dim``: which dimension of a JAX-layout leaf tp shards."""
    if tp_size <= 1 or len(shape) != 2:
        return None
    col = any(n in name for n in _TP_COL)
    row = any(n in name for n in _TP_ROW)
    if not (col or row):
        return None
    if "dense" in name and "dense_scales" not in name:
        dim = (1 if col else 0) if in_major else (0 if col else 1)
    elif "kernel" in name:
        dim = 1 if col else 0
    else:
        return None
    return dim if shape[dim] % tp_size == 0 else None


def _jax_spec(shape, dtype, name: str, fsdp_size: int, tp_size: int) -> tuple:
    """JAX's ``param_spec`` on a JAX-layout shape."""
    ndim = len(shape)
    spec = [None] * ndim
    in_major = dtype in (torch.uint8, torch.int8)
    tp_d = _tp_dim(name, shape, tp_size, in_major)
    if tp_d is not None:
        spec[tp_d] = "tp"
    numel = 1
    for s in shape:
        numel *= s
    if not shape or numel < _MIN_SHARD_ELEMS:
        return tuple(spec) if any(spec) else ()
    for d in sorted(range(ndim), key=lambda i: -shape[i]):
        if d == tp_d:
            continue
        if shape[d] % fsdp_size == 0 and shape[d] >= fsdp_size:
            spec[d] = "fsdp"
            break
    return tuple(spec) if any(spec) else ()


def param_spec(shape, dtype: torch.dtype, name: str, fsdp_size: int, tp_size: int = 1) -> tuple:
    """The placement of the port's parameter of ``shape``, ``dtype`` and JAX
    path ``name`` (``adam8bit.jax_paths``) in the port's layout."""
    shape = tuple(shape)
    if name.rsplit("/", 1)[-1] == "kernel":
        spec = _jax_spec(shape[::-1], dtype, name, fsdp_size, tp_size)
        return spec[::-1]
    return _jax_spec(shape, dtype, name, fsdp_size, tp_size)


def local(t: torch.Tensor) -> torch.Tensor:
    """The rank's plain tensor of a DTensor (a tp-sharded weight as FSDP2
    hands it to the forward); a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def local_bias(bias: Optional[torch.Tensor], tp: Optional[TensorParallel],
               style: Optional[str]) -> Optional[torch.Tensor]:
    """A tensor-parallel layer's share of its (replicated) bias: the rank's
    output features for "col" and "head", the whole bias on tp rank 0 and
    none elsewhere for "row" (its output is a partial sum)."""
    if bias is None or style is None:
        return bias
    if style == "row":
        return bias if tp.rank == 0 else None
    return bias.chunk(tp.size)[tp.rank]


def full_tensor(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a (sharded) DTensor, gathered; a plain tensor as
    it is.  A collective over the DTensor's mesh."""
    return t.full_tensor() if isinstance(t, DTensor) else t


@dataclasses.dataclass
class Placement:
    """What ``shard_model`` did to a model, kept on it as ``_parallel``."""

    mesh: object
    tp: Optional[TensorParallel]   # the tp axis of the tensor-parallel layers
    kv_shards: int                 # the attention's kv heads are split this many ways
    partial: frozenset             # ids of the parameters whose gradients sum over tp
    specs: dict                    # parameter name -> param_spec (the frozen ones)
    wrapped: bool                  # FSDP2 and tp applied (False: run as unsharded)


def placement(model: nn.Module) -> Optional[Placement]:
    return model.__dict__.get("_parallel")


def model_tp_size(model: nn.Module) -> int:
    """How many ways the model's kv heads are split (1 unsharded): a KV
    cache holds this rank's share (``models/llama.init_caches``)."""
    p = placement(model)
    return p.kv_shards if p is not None else 1


def is_quantized(model: nn.Module) -> bool:
    return any(getattr(m, "quant_bits", 0) for m in model.modules())


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Place ``model`` on ``mesh`` in place (see the module docstring) and
    return it.  Idempotent for the same mesh."""
    done = placement(model)
    if done is not None:
        if done.mesh is not mesh:
            raise ValueError("the model is already placed on another mesh")
        return model
    _, fsdp, tp = (int(s) for s in mesh.mesh.shape)
    if is_quantized(model):
        if mesh.size() > 1:
            raise NotImplementedError(f"a quantized base under a mesh of {mesh.size()} ranks: "
                                      f"{ITEM_28B}")
        model.__dict__["_parallel"] = Placement(mesh, None, 1, frozenset(), {}, False)
        return model
    from sparse_matrix_fine_tuning_torch.training.adam8bit import jax_paths

    frozen = {n: p for n, p in model.named_parameters() if not p.requires_grad}
    paths = jax_paths(model, list(frozen))
    specs = {n: param_spec(p.shape, p.dtype, paths[n], fsdp, tp) for n, p in frozen.items()}
    tpi = tensor_parallel(mesh)
    kv_shards, partial = 1, set()
    if tpi is not None:
        kv_shards, partial = _tensor_parallel(model, specs, tpi, mesh["tp"])
    _fully_shard(model, specs, mesh["fsdp"])
    model.__dict__["_parallel"] = Placement(mesh, tpi, kv_shards, frozenset(partial), specs,
                                            True)
    return model


def _fsdp_dim(spec: tuple) -> Optional[int]:
    return spec.index("fsdp") if "fsdp" in spec else None


def _fully_shard(model: nn.Module, specs: dict, fsdp_mesh) -> None:
    """FSDP2 over the fsdp axis: a unit each decoder layer (each element of
    the model's ``nn.ModuleList``s that holds a parameter to shard, deepest
    first), then the model; a parameter whose spec has no fsdp dimension is
    ignored (left whole)."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    params = dict(model.named_parameters())
    dims = {id(params[n]): _fsdp_dim(s) for n, s in specs.items() if _fsdp_dim(s) is not None}
    ignored = {p for p in model.parameters() if id(p) not in dims}

    def placement_fn(param):
        return Shard(dims[id(param)])

    blocks = []
    for name, module in model.named_modules():
        if isinstance(module, nn.ModuleList):
            for i, block in enumerate(module):
                if any(id(p) in dims for p in block.parameters()):
                    blocks.append((f"{name}.{i}".count("."), block))
    for _, block in sorted(blocks, key=lambda b: -b[0]):
        fully_shard(block, mesh=fsdp_mesh, shard_placement_fn=placement_fn,
                    ignored_params=ignored)
    fully_shard(model, mesh=fsdp_mesh, shard_placement_fn=placement_fn, ignored_params=ignored)
    if hasattr(model, "training_loss"):
        # the fused forward and loss gathers the model's own parameters too
        register_fsdp_forward_method(model, "training_loss")


def _shard_weight(module: nn.Module, attr: str, dim: int, tp: TensorParallel, tp_mesh) -> None:
    """Replace ``module.<attr>`` with its DTensor ``Shard(dim)`` over tp
    (this rank's slice; the peers hold equal weights)."""
    w = getattr(module, attr)
    piece = w.detach().chunk(tp.size, dim)[tp.rank].contiguous()
    dt = DTensor.from_local(piece, tp_mesh, [Shard(dim)], run_check=False)
    setattr(module, attr, nn.Parameter(dt, requires_grad=False))


def _weight_attr(module: nn.Module) -> str:
    return "dense" if hasattr(module, "blkdiag1") else "weight"


def _tensor_parallel(model: nn.Module, specs: dict, tp: TensorParallel, tp_mesh):
    """Megatron tensor parallelism over the Llama's blocks and a frozen head;
    (kv shards, ids of the parameters with partial gradients)."""
    from sparse_matrix_fine_tuning_torch.models.llama import (
        LlamaAttention,
        LlamaForCausalLM,
        LlamaMLP,
        LlamaModel,
    )

    if not isinstance(model, LlamaForCausalLM):
        raise ValueError(f"tensor parallelism (tp {tp.size}) places a LlamaForCausalLM's "
                         f"blocks; got {type(model).__name__}")
    cfg = model.config
    if cfg.kv_heads % tp.size:
        raise ValueError(f"tp {tp.size} does not divide the {cfg.kv_heads} kv heads: each rank "
                         "runs whole kv heads and their query groups")
    if cfg.intermediate_size % tp.size:
        raise ValueError(f"tp {tp.size} does not divide the MLP width {cfg.intermediate_size}")
    names = {id(m): n for n, m in model.named_modules()}
    partial = set()

    def style(parent, proj, want):
        module = getattr(parent, proj)
        attr = _weight_attr(module)
        name = f"{names[id(module)]}.{attr}"
        spec = specs.get(name)
        if spec is None or "tp" not in spec:
            return None
        if spec.index("tp") != (0 if want == "col" else 1):
            raise AssertionError(f"{name}: tp on dimension {spec.index('tp')} for a {want} layer")
        return module, attr, spec.index("tp")

    for parent in model.modules():
        if isinstance(parent, (LlamaAttention, LlamaMLP)):
            cols, rows = (("q_proj", "k_proj", "v_proj"), ("o_proj",)) \
                if isinstance(parent, LlamaAttention) else (("gate_proj", "up_proj"), ("down_proj",))
            plan = [(p, "col") for p in cols] + [(p, "row") for p in rows]
            found = [style(parent, p, s) for p, s in plan]
            if not any(found):
                continue  # no frozen dense (projection mode, a trained base): replicated
            if not all(found):
                missing = [p for (p, _), f in zip(plan, found) if f is None]
                raise ValueError(f"{names[id(parent)]}: tensor parallelism needs every "
                                 f"projection's frozen weight; {missing} have none")
            for (proj, kind), (module, attr, dim) in zip(plan, found):
                _shard_weight(module, attr, dim, tp, tp_mesh)
                module.set_tensor_parallel(tp, kind)
                partial.update(id(p) for p in module.parameters() if p.requires_grad)
            parent.tp = tp
    if model.lm_head is not None:
        found = style(model, "lm_head", "col")
        if found is not None:
            module, attr, dim = found
            _shard_weight(module, attr, dim, tp, tp_mesh)
            module.set_tensor_parallel(tp, "head")
            partial.update(id(p) for p in module.parameters() if p.requires_grad)
    for m in model.modules():
        if isinstance(m, LlamaModel):
            m.tp = tp
    return tp.size, partial


def sync_gradients(model: nn.Module) -> None:
    """Make every rank's trainable gradients the global batch's: summed over
    tp where they are partial, averaged over the data ranks.  One all-reduce
    over the world a dtype (the tp peers of replicated computations hold
    equal gradients, so those are averaged over the world)."""
    p = placement(model)
    if p is None or not p.wrapped:
        return
    dp, fsdp, tp = (int(s) for s in p.mesh.mesh.shape)
    data = dp * fsdp
    by_dtype: dict = {}
    for param in model.parameters():
        if param.requires_grad and param.grad is not None:
            by_dtype.setdefault(param.grad.dtype, []).append(param)
    for params in by_dtype.values():
        scales = [1.0 / data if id(q) in p.partial else 1.0 / (data * tp) for q in params]
        flat = torch.cat([q.grad.reshape(-1) * s for q, s in zip(params, scales)])
        dist.all_reduce(flat)
        offset = 0
        for q in params:
            n = q.grad.numel()
            q.grad.copy_(flat[offset:offset + n].view_as(q.grad))
            offset += n


def all_mean(value: torch.Tensor, model: nn.Module) -> torch.Tensor:
    """A per-rank scalar averaged over the data ranks (its tp peers hold the
    same value): the global batch's loss on every rank."""
    p = placement(model)
    if p is None or not p.wrapped:
        return value
    t = value.detach().float().reshape(1).clone()
    dist.all_reduce(t)
    return (t / p.mesh.size()).reshape(())
