"""Llama decoder for the port: RMSNorm, split-half RoPE, GQA, SwiGLU, and a
preallocated KV cache for greedy decode.

Counterpart of ``sparse_matrix_fine_tuning_tpu/models/llama.py`` with the
same HF attribute names (``q_proj`` ... ``down_proj``), so ``init_monarch``
finds the same targets and ``utils/jax_bridge.py`` carries the same
parameters.  The arithmetic follows the JAX model: RMSNorm reduces in fp32;
attention is ``softmax(q k^T / sqrt(d) + bias)`` with the scores, the
additive bias and the softmax in fp32; the bias is -1e9 where a key is
masked.  ``forward`` with ``caches`` writes this call's keys and values into
the preallocated cache in place, at ``cache_index``, and attends over the
whole cache.

Training: ``loss`` is the shifted causal-LM cross-entropy over full logits
and ``training_loss`` the forward plus that loss, chunked over tokens when
``config.loss_chunk > 0`` (``ops/losses.py``), as the JAX model's
(llama.py:371-405).  ``lm_head`` may be replaced by a ``quant.Int8LMHead``
(``quant.quantize_lm_head``, which refuses a tied head); the loss takes
either as the head callable.

Attention, as ``config.attention_impl`` picks it (the JAX llama.py:138-150): "einsum"
as above; "dpa" the composition ``jax.nn.dot_product_attention`` runs
through XLA (``_dpa_attention``: fp32 scores, the bias, an fp32 softmax,
probabilities in the keys' dtype); "splash" the causal flash attention of
``kernels/attention_cuda.py`` (K17-K19 on the card), which ignores the bias
(pure-causal is exact for right-padded rows: a pad key comes after every
real query).  "dpa" and "splash" serve the training path (no cache);
prefill and decode over a cache take the einsum attention, as in JAX.

Sequence packing (the JAX llama.py:229-291): ``segment_ids`` (b, t), 1..n
a row and 0 for padding, restart the RoPE positions at each segment and add
-1e9 where a key lies in another segment, after the causal and padding
terms, in the activation dtype; the bias is then (b, 1, t, t).  "splash"
refuses it (its kernels are purely causal), and so does decode.

Remat (``config.remat``, the JAX llama.py:293-317): in training with
gradients on, each decoder layer runs under ``torch.utils.checkpoint``
(non-reentrant; the random state is replayed, so dropout masks repeat).
``remat_policy`` "nothing" keeps only each layer's input; "dots" also
keeps the outputs of the products with no batch dimension (``aten.mm`` and
``aten.addmm``: the base projections), as JAX's
``dots_with_no_batch_dims_saveable``, and recomputes the rest (the Monarch
kernels, attention's batched products, norms and activations).  On the
card the recompute launches the layer's forward kernels again.

Layer hooks (the JAX llama.py:177-227, ReFT's intervention sites):
``layer_hooks`` maps a plain int (that layer's block output) or ``(layer,
component)``, the component one of "block_output", "block_input",
"attention_output" or "mlp_output", to a function of the hidden states.
The inner components run inside the decoder layer, so under remat inside
the checkpointed function (recomputed with it, as JAX's ``make_run``);
block outputs run after it.  Hooks apply on a prefill over a cache as well.

Gemma (the JAX llama.py:28-50, :246-249): ``rmsnorm_unit_offset`` takes
``UnitOffsetRMSNorm``, ``normalize(x) * (1 + w)`` in fp32 end to end, whose
stored weight is the checkpoint's offset (zero at init); ``scale_embeddings``
multiplies the embeddings by ``sqrt(hidden_size)`` rounded to the
activation dtype first, as HF does.  "splash" at Gemma's head_dim 256 raises
(``kernels/attention_cuda.py``: K17-K19 instantiate 64 and 128).

Parallelism (``parallel/``, the JAX llama.py's ``shard_tokens`` marks):
under ``sharding.shard_model``'s tensor parallelism each attention runs
the rank's heads (q/k/v column-parallel, o row-parallel; the KV cache holds
the rank's kv heads, ``init_caches(tp_size=)``), each MLP the rank's slice
of its width, and a frozen head gathers its logits over the vocabulary, so
``loss`` and the chunked ``training_loss`` see whole logits.  With an
activation mesh installed (the Trainer's ``sequence_parallel``) a training
forward runs the residual stream and the norms on the rank's slice of the
sequence.  Under a mesh the losses' denominator is the global batch's
count (``multihost.loss_denominator``).

The model is built on the card unless ``device="cpu"`` is passed
(``utils/device.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from sparse_matrix_fine_tuning_torch.kernels.attention_cuda import splash_attention
from sparse_matrix_fine_tuning_torch.models.config import ATTENTION_IMPLS, LlamaConfig
from sparse_matrix_fine_tuning_torch.ops.activations import geglu, swiglu
from sparse_matrix_fine_tuning_torch.parallel import annotate
from sparse_matrix_fine_tuning_torch.parallel.annotate import enter_tp, exit_tp, tp_copy, tp_gather
from sparse_matrix_fine_tuning_torch.parallel.multihost import loss_denominator
from sparse_matrix_fine_tuning_torch.parallel.sharding import local, local_bias
from sparse_matrix_fine_tuning_torch.utils.device import resolve_device, seeded_generator


class Linear(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (None: the promoted dtype of
    input and weight), initialised N(0, 0.02) with a zero bias, as the JAX
    model's ``nnx.Linear``.

    Under tensor parallelism (``set_tensor_parallel``) the weight is a
    DTensor sharded over tp and the product takes its local rows ("col" and
    "head": the rank's output features; "head" also copies its input into
    the tp region and gathers the logits over the vocabulary) or columns
    ("row": a partial sum, the bias added on tp rank 0 only)."""

    tp = None
    tp_style = None

    def __init__(self, in_features: int, out_features: int, bias: bool = False, *,
                 dtype: Optional[torch.dtype] = None, param_dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        device = resolve_device(device)
        super().__init__(in_features, out_features, bias=bias, device=device, dtype=param_dtype)
        self.compute_dtype = dtype
        generator = seeded_generator(device, generator)
        with torch.no_grad():
            self.weight.normal_(0.0, 0.02, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def reset_parameters(self) -> None:
        """Init happens in ``__init__`` from an explicit generator."""

    def set_tensor_parallel(self, tp, style: str) -> None:
        self.tp, self.tp_style = tp, style

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = local(self.weight)
        dtype = self.compute_dtype or torch.promote_types(x.dtype, weight.dtype)
        bias = local_bias(self.bias, self.tp, self.tp_style)
        bias = bias.to(dtype) if bias is not None else None
        if self.tp_style == "head":
            x = tp_copy(x, self.tp)
        out = F.linear(x.to(dtype), weight.to(dtype), bias)
        return tp_gather(out, self.tp, -1) if self.tp_style == "head" else out


class UnitOffsetRMSNorm(nn.Module):
    """Gemma's RMSNorm (the JAX ``UnitOffsetRMSNorm``): ``normalize(x) * (1 +
    w)`` in fp32, the result in ``dtype`` (None: the input's); ``weight``
    holds the offset ``w``, zero at init."""

    def __init__(self, dim: int, *, eps: float, dtype=None, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(dim, dtype=param_dtype,
                                               device=resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + self.eps) * (1.0 + self.weight.float())
        return out.to(self.dtype or x.dtype)


class RMSNorm(nn.Module):
    """RMSNorm as ``nnx.RMSNorm``: the mean square and the scaling in fp32,
    the result in ``dtype`` (None: the promoted dtype of input and weight)."""

    def __init__(self, dim: int, *, eps: float, dtype=None, param_dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim, dtype=param_dtype,
                                              device=resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        xf = x.to(dtype).float()
        var = xf.square().mean(-1, keepdim=True)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(dtype).float()
        return (xf * mul).to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding.  x: (b, t, heads, head_dim); positions: (b, t)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs            # (b, t, hd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _splash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal flash attention, the JAX model's ``_splash_attention``
    (llama.py:57): q, k, v (b, t, heads, head_dim) with equal heads ->
    (b, t, heads, head_dim).  q is scaled by ``1/sqrt(head_dim)`` in its own
    dtype first, as JAX multiplies by a weakly typed scalar (at head_dim 128
    that rounds q in bf16; at 64 it is exact).  Purely causal: no bias."""
    scale = float(torch.tensor(1.0 / q.shape[-1] ** 0.5, dtype=q.dtype))
    return splash_attention(q * scale, k, v)


def _dpa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor,
                   scale: float) -> torch.Tensor:
    """``jax.nn.dot_product_attention(q, k, v, bias=bias.astype(q.dtype),
    scale=scale)`` as XLA computes it (jax/_src/nn/functions.py,
    ``_dot_product_attention_core``): the scores with fp32 sums, times the
    fp32 scale, plus the bias, an fp32 softmax, the probabilities rounded to
    the keys' dtype, then their product with v.  (b, t, heads, head_dim)."""
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    scores = scores + bias.to(q.dtype).float()
    probs = torch.softmax(scores, dim=-1).to(k.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _linear(cfg: LlamaConfig, in_f: int, out_f: int, device, generator, bias: bool = False):
    return Linear(in_f, out_f, bias, dtype=cfg.compute_dtype, param_dtype=cfg.params_dtype,
                  device=device, generator=generator)


# remat_policy "dots": the products with no batch dimension, whose outputs
# the recompute reads back instead of running them again
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def remat_context(policy: str):
    """``checkpoint``'s ``context_fn`` for a ``remat_policy``: its default
    (everything recomputed) for "nothing", the selective contexts that keep
    ``_SAVED_DOTS``' outputs for "dots"."""
    if policy == "nothing":
        return noop_context_fn
    if policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts, _save_dots)
    raise ValueError(f"unknown remat_policy {policy!r} (nothing | dots)")


def segment_positions(segment_ids: torch.Tensor) -> torch.Tensor:
    """Each token's offset within its own segment: ``idx - cummax(where(
    boundary, idx, 0))``, boundaries where the id changes (the JAX
    llama.py:251-261).  (b, t) -> (b, t) int64."""
    b, t = segment_ids.shape
    idx = torch.arange(t, device=segment_ids.device).expand(b, t)
    boundary = torch.ones_like(segment_ids, dtype=torch.bool)
    boundary[:, 1:] = segment_ids[:, 1:] != segment_ids[:, :-1]
    return idx - torch.cummax(torch.where(boundary, idx, 0), dim=1).values


def write_cache(k, v, cache):
    """This call's keys and values written in place into the preallocated
    cache (the whole generation's) at its index: (k_cache, v_cache) to
    attend over and the new cache; (k, v) and None without a cache."""
    if cache is None:
        return k, v, None
    k_cache, v_cache, idx = cache
    t = k.shape[1]
    k_cache[:, idx:idx + t] = k
    v_cache[:, idx:idx + t] = v
    return k_cache, v_cache, (k_cache, v_cache)


class LlamaAttention(nn.Module):
    """GQA attention.  Under tensor parallelism (``tp``, set by
    ``parallel/sharding.shard_model``) q/k/v are column-parallel and o
    row-parallel: the layer runs the rank's heads (their counts follow from
    the local shapes), its input entering the tp region and its output
    summed over tp at the block's boundary (``annotate.enter_tp`` and
    ``exit_tp``; ``sp``: the sequence-parallel layout)."""

    tp = None

    def __init__(self, cfg: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        self.num_heads = cfg.num_attention_heads
        self.num_kv = cfg.kv_heads
        self.head_dim = cfg.head_width
        h, qkv_bias = cfg.hidden_size, cfg.attention_qkv_bias
        self.q_proj = _linear(cfg, h, self.num_heads * self.head_dim, device, generator, qkv_bias)
        self.k_proj = _linear(cfg, h, self.num_kv * self.head_dim, device, generator, qkv_bias)
        self.v_proj = _linear(cfg, h, self.num_kv * self.head_dim, device, generator, qkv_bias)
        self.o_proj = _linear(cfg, self.num_heads * self.head_dim, h, device, generator)

    def forward(self, x, attn_bias, positions, cache=None, sp: bool = False):
        x = enter_tp(x, self.tp, sp)
        b, t, _ = x.shape
        q = self.q_proj(x).reshape(b, t, -1, self.head_dim)
        k = self.k_proj(x).reshape(b, t, -1, self.head_dim)
        v = self.v_proj(x).reshape(b, t, -1, self.head_dim)
        q = apply_rope(q, positions, self.cfg.rope_theta)
        k = apply_rope(k, positions, self.cfg.rope_theta)

        k, v, new_cache = write_cache(k, v, cache)
        groups = q.shape[2] // k.shape[2]
        kr = k.repeat_interleave(groups, dim=2) if groups > 1 else k
        vr = v.repeat_interleave(groups, dim=2) if groups > 1 else v
        impl = self.cfg.attention_impl
        if cache is None and impl == "splash":
            ctx = _splash_attention(q, kr, vr)
        elif cache is None and impl == "dpa":
            ctx = _dpa_attention(q, kr, vr, attn_bias, 1.0 / math.sqrt(self.head_dim))
        else:
            scores = torch.einsum("bthd,bshd->bhts", q, kr).float() / math.sqrt(self.head_dim)
            scores = scores + attn_bias.float()
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            ctx = torch.einsum("bhts,bshd->bthd", probs, vr)
        return exit_tp(self.o_proj(ctx.reshape(b, t, -1)), self.tp, sp), new_cache


class LlamaMLP(nn.Module):
    """SwiGLU (GeGLU) MLP; under tensor parallelism gate/up column-parallel
    and down row-parallel, as ``LlamaAttention``."""

    tp = None

    def __init__(self, cfg: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        if cfg.mlp_activation not in ("silu", "gelu_tanh"):
            raise ValueError(f"unknown mlp_activation {cfg.mlp_activation!r} (silu | gelu_tanh)")
        self.act = swiglu if cfg.mlp_activation == "silu" else geglu
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = _linear(cfg, h, i, device, generator)
        self.up_proj = _linear(cfg, h, i, device, generator)
        self.down_proj = _linear(cfg, i, h, device, generator)

    def forward(self, x, sp: bool = False):
        x = enter_tp(x, self.tp, sp)
        return exit_tp(self.down_proj(self.act(self.gate_proj(x), self.up_proj(x))), self.tp, sp)


def _norm(cfg: LlamaConfig, device) -> nn.Module:
    cls = UnitOffsetRMSNorm if cfg.rmsnorm_unit_offset else RMSNorm
    return cls(cfg.hidden_size, eps=cfg.rms_norm_eps, dtype=cfg.compute_dtype,
               param_dtype=cfg.params_dtype, device=device)


def run_block(x, hooks, attention, mlp):
    """A pre-norm block's sequential residual with its inner hook sites:
    ``attention(x)`` (its output and new cache) and ``mlp(x)`` take the
    block's input and return the branch's output, the norms inside."""
    hooks = hooks or {}
    if "block_input" in hooks:
        x = hooks["block_input"](x)
    attn_out, new_cache = attention(x)
    if "attention_output" in hooks:
        attn_out = hooks["attention_output"](attn_out)
    x = x + attn_out
    mlp_out = mlp(x)
    if "mlp_output" in hooks:
        mlp_out = hooks["mlp_output"](mlp_out)
    return x + mlp_out, new_cache


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        self.self_attn = LlamaAttention(cfg, device=device, generator=generator)
        self.mlp = LlamaMLP(cfg, device=device, generator=generator)
        self.input_layernorm = _norm(cfg, device)
        self.post_attention_layernorm = _norm(cfg, device)

    def forward(self, x, attn_bias, positions, cache=None, hooks=None, sp: bool = False):
        """hooks: optional {component: fn} of this layer's inner sites,
        "block_input", "attention_output" and "mlp_output"; "block_output" is
        the caller's.  sp: x is this rank's slice of the sequence
        (``parallel/annotate.py``)."""
        return run_block(
            x, hooks,
            lambda h: self.self_attn(self.input_layernorm(h), attn_bias, positions, cache, sp=sp),
            lambda h: self.mlp(self.post_attention_layernorm(h), sp=sp))


HOOK_COMPONENTS = ("block_output", "block_input", "attention_output", "mlp_output")


def split_hooks(layer_hooks) -> tuple[dict, dict]:
    """({layer: fn} block outputs, {layer: {component: fn}} inner sites) of
    ``layer_hooks``, whose keys are a plain int (a block output) or
    ``(layer, component)`` (the JAX ``_split_hooks``)."""
    block, inner = {}, {}
    for key, fn in (layer_hooks or {}).items():
        if isinstance(key, tuple):
            i, comp = key
            if comp not in HOOK_COMPONENTS:
                raise ValueError(f"unknown Llama hook component {comp!r} "
                                 f"({' | '.join(HOOK_COMPONENTS)})")
            if comp == "block_output":
                block[int(i)] = fn
            else:
                inner.setdefault(int(i), {})[comp] = fn
        else:
            block[int(key)] = fn
    return block, inner


def attention_bias(attention_mask, t, caches, cache_index, dtype, device, segment_ids=None,
                   window: Optional[int] = None) -> torch.Tensor:
    """The additive attention bias of a decoder's forward (the JAX
    models' construction): 0 where a key may be attended, -1e9 where not.
    Without ``caches``: causal (and within ``window`` tokens, the query
    counted), then the padding term of ``attention_mask``, then the segment
    term, each added in ``dtype``; (b or 1, 1, t, t).  Over a fixed-size
    cache: query row i sits at slot ``cache_index + i`` and may attend any
    valid slot at or before it (within ``window``); (b, 1, t, cache_len)."""
    if caches is None:
        offs = torch.arange(t, device=device)
        causal = offs[None, :] <= offs[:, None]
        if window is not None:
            causal = causal & (offs[:, None] - offs[None, :] < window)
        bias = torch.where(causal[None, None], 0.0, -1e9).to(dtype)
        if attention_mask is not None:
            pad = (1.0 - attention_mask[:, None, None, :].to(dtype)) * torch.tensor(
                -1e9, dtype=dtype, device=device)
            bias = bias + pad
        if segment_ids is not None:
            same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
            bias = bias + torch.where(same, 0.0, -1e9).to(dtype)
        return bias
    cache_len = caches[0][0].shape[1]
    slot_ids = torch.arange(cache_len, device=device)[None, :]
    row_pos = cache_index + torch.arange(t, device=device)[:, None]
    causal = slot_ids <= row_pos
    if window is not None:
        causal = causal & (row_pos - slot_ids < window)
    ok = causal[None, None] & (attention_mask[:, None, None, :] > 0)
    return torch.where(ok, 0.0, -1e9).to(dtype)


def default_positions(b: int, t: int, segment_ids, device) -> torch.Tensor:
    """0..t-1 a row, or each token's offset in its segment when packed."""
    return (torch.arange(t, device=device).expand(b, t) if segment_ids is None
            else segment_positions(segment_ids))


class LlamaModel(nn.Module):
    """The decoder stack.  Under tensor parallelism (``tp``) with an
    activation mesh installed, a training forward whose sequence tp divides
    runs the residual stream and the norms on the rank's slice of the
    sequence (``parallel/annotate.py``) and gathers it back after the final
    norm."""

    tp = None

    def __init__(self, cfg: LlamaConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        self.config = cfg
        weight = torch.empty(cfg.vocab_size, cfg.hidden_size, dtype=cfg.params_dtype,
                             device=device)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         _weight=weight.normal_(0.0, 0.02, generator=generator))
        self.layers = nn.ModuleList([LlamaDecoderLayer(cfg, device=device, generator=generator)
                                     for _ in range(cfg.num_hidden_layers)])
        self.norm = _norm(cfg, device)

    def forward(self, input_ids, attention_mask=None, positions=None, caches=None,
                cache_index=None, segment_ids=None, layer_hooks=None):
        """segment_ids: optional (b, t) ints of a packed batch
        (``data/alpaca.pack_causal_lm``), training path only.  layer_hooks:
        see the module docstring."""
        cfg = self.config
        block_hooks, inner_hooks = split_hooks(layer_hooks)
        b, t = input_ids.shape
        if segment_ids is not None and caches is not None:
            raise ValueError("segment_ids (sequence packing) is for the training path; "
                             "decode over a cache never packs")
        x = self.embed_tokens(input_ids)
        if cfg.compute_dtype is not None:
            x = x.to(cfg.compute_dtype)
        if cfg.scale_embeddings:
            x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=x.dtype, device=x.device)
        if positions is None:
            positions = default_positions(b, t, segment_ids, x.device)
        if caches is None and cfg.attention_impl == "splash":
            # splash builds its own pure-causal mask and ignores the bias: it
            # would silently attend beyond the window or across segments
            # (llama.py:266-271, :283-288)
            if cfg.sliding_window is not None:
                raise ValueError("sliding_window requires a bias-carrying attention_impl "
                                 "(einsum or dpa)")
            if segment_ids is not None:
                raise ValueError("sequence packing (segment_ids) requires a bias-carrying "
                                 "attention_impl (einsum or dpa)")
            bias = None  # splash takes no bias
        else:
            bias = attention_bias(attention_mask, t, caches, cache_index, x.dtype, x.device,
                                  segment_ids, window=cfg.sliding_window)
        sp = annotate.sequence_parallel(x) if self.tp is not None and caches is None else None
        if sp is not None:
            if layer_hooks:
                raise ValueError("layer hooks see whole sequences; sequence parallelism splits "
                                 "them (run the hooked model with sequence_parallel off)")
            x = annotate.shard_tokens(x)  # the JAX model's boundaries (llama.py:250, ...)
        remat = cfg.remat and caches is None and self.training and torch.is_grad_enabled()
        context_fn = remat_context(cfg.remat_policy) if remat else None
        new_caches = None if caches is None else []
        for i, layer in enumerate(self.layers):
            hooks = inner_hooks.get(i)
            if remat:
                x, _ = checkpoint(layer, x, bias, positions, None, hooks, sp is not None,
                                  use_reentrant=False, context_fn=context_fn)
            elif caches is None:
                x, _ = layer(x, bias, positions, hooks=hooks, sp=sp is not None)
            else:
                kc, vc = caches[i]
                x, nc = layer(x, bias, positions, cache=(kc, vc, cache_index), hooks=hooks)
                new_caches.append(nc)
            if sp is not None:
                x = annotate.shard_tokens(x, t)  # (:315, :321) already in the layout
            if i in block_hooks:
                x = block_hooks[i](x)
        x = self.norm(x)
        if sp is not None:
            # (:344) in the layout; the head takes the whole sequence
            x = annotate.gather_tokens(annotate.shard_tokens(x, t), sp)
        return x, new_caches


class LlamaForCausalLM(nn.Module):
    def __init__(self, cfg: LlamaConfig, *, device=None, generator: Optional[torch.Generator] = None):
        """device: where to build; the card when None.  generator:
        ``torch.Generator`` on ``device`` for the random init; a fresh one
        seeded with 0 when None."""
        super().__init__()
        if cfg.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(f"unknown attention_impl {cfg.attention_impl!r} "
                             f"({' | '.join(ATTENTION_IMPLS)})")
        if cfg.remat:
            remat_context(cfg.remat_policy)  # an unknown policy raises
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        self.config = cfg
        self.model = LlamaModel(cfg, device=device, generator=generator)
        self.lm_head = (None if cfg.tie_word_embeddings
                        else _linear(cfg, cfg.hidden_size, cfg.vocab_size, device, generator))

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.lm_head is None:
            return hidden @ self.model.embed_tokens.weight.T.to(hidden.dtype)
        return self.lm_head(hidden)

    def forward(self, input_ids, attention_mask=None, positions=None, caches=None,
                cache_index=None, segment_ids=None, layer_hooks=None):
        hidden, new_caches = self.model(input_ids, attention_mask, positions, caches,
                                        cache_index, segment_ids, layer_hooks)
        out = self.logits(hidden)
        return (out, new_caches) if caches is not None else out

    def training_loss(self, input_ids, labels, attention_mask=None, positions=None,
                      layer_hooks=None, segment_ids=None, weights=None,
                      ignore_index: int = -100) -> torch.Tensor:
        """Forward and shifted CE in one call; chunked over tokens, without
        the full (B, T, V) logits, when ``config.loss_chunk > 0``."""
        from sparse_matrix_fine_tuning_torch.ops.losses import model_training_loss

        return model_training_loss(
            self, input_ids, labels, attention_mask=attention_mask, positions=positions,
            layer_hooks=layer_hooks, segment_ids=segment_ids, weights=weights,
            ignore_index=ignore_index)

    def loss(self, logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = -100,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Shifted causal-LM cross-entropy, fp32, mean over the positions
        whose label is not ``ignore_index`` (and whose row has a nonzero
        ``weights`` entry, for padded ragged-tail rows); under the Trainer's
        mesh the global batch's mean (``multihost.loss_denominator``)."""
        shift_logits = logits[:, :-1].float()
        shift_labels = labels[:, 1:]
        mask = shift_labels != ignore_index
        if weights is not None:
            mask = mask & (weights[:, None] != 0)
        safe = torch.where(mask, shift_labels, torch.zeros_like(shift_labels))
        logp = torch.log_softmax(shift_logits, dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None].long()).squeeze(-1)
        maskf = mask.float()
        return (nll * maskf).sum() / loss_denominator(maskf.sum())


def init_caches(cfg: LlamaConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                device=None, tp_size: int = 1) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Empty KV caches: one (k, v) pair of (b, max_len, kv_heads / tp_size,
    head_dim) per layer, on ``device`` (the card when None): under tensor
    parallelism (``parallel.sharding.model_tp_size``) the rank's kv heads."""
    device = resolve_device(device)
    if cfg.kv_heads % tp_size:
        raise ValueError(f"tp {tp_size} does not divide the {cfg.kv_heads} kv heads")
    shape = (batch, max_len, cfg.kv_heads // tp_size, cfg.head_width)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device))
            for _ in range(cfg.num_hidden_layers)]
