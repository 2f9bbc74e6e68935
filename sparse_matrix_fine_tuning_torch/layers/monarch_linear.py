"""MonarchLinear: the MoRe adapter layer, PyTorch.

Counterpart of ``sparse_matrix_fine_tuning_tpu/layers/monarch_linear.py`` in
adapter mode: ``y = x @ dense^T + monarch(x) (+ bias)`` with a frozen dense
base.

  * Trainability is ``requires_grad``: the factors ``blkdiag1 (nblocks,
    blk_r, in_blksz)`` and ``blkdiag2 (nblocks, out_blksz, blk_r)`` (and the
    Scaler and multiplicative factor, where used) are trainable
    ``nn.Parameter``s; the dense base and its bias are parameters with
    ``requires_grad=False``.  This replaces the JAX ``AdapterParam`` type.
  * Init: per-block Kaiming-uniform with bound 1/sqrt(in_blksz) on
    ``blkdiag1``; ``blkdiag2`` is zero in plain adapter mode (the adapter
    starts as the identity map) and Kaiming with a Scaler or outside
    adapter mode.  Random init draws from an explicit ``torch.Generator``.
  * Dispatch is by device alone.  A CUDA input takes the fused
    ``base + monarch(x)`` kernel (K2) when no branch transform (dropout,
    Scaler, multiplicative factor) and no padding is in the way, otherwise
    the Monarch kernel (K1) on the padded input.  Both are autograd
    Functions whose backward is K3.  A CPU input takes the plain functions,
    unfused, as the JAX package does off the TPU.
  * Merged training (``enable_merged_training``, ``kernels/merged.py``): the
    forward is one product with the merged operand, refreshed once per
    optimizer step; the factor gradients are K4 on the card.
  * Dropout follows ``self.training`` (``nn.Module.train()/eval()``), or
    the ``deterministic`` argument where given.
  * Built without ``weights``, the layer lives on ``device``, the card when
    None (``utils/device.py``); with ``weights``, on the weights' device.
  * Quantized base (``quant.quantize_frozen_base``): ``dense`` holds int8
    codes (in, out) or packed int4 codes (in/2, out), ``dense_scales`` their
    f32 scales (a persistent buffer that ``.to(dtype)`` keeps float32), and
    ``quant_bits``/``quant_group`` steer ``_dense_forward``: a CUDA input
    takes the dequantize-matmul kernels K7/K5 (backward K8/K6), a CPU input
    their plain versions, and the adapter is added as for a float base (K2
    on the card).  ``serve_w8a8`` (int8, serving) takes per-token int8
    activations and an int8 x int8 -> int32 product instead.

Not ported yet, and refused with ``NotImplementedError``: SVD projection
(``svd_init``, projection mode, ``reference_orientation``); it names its
item of ROADMAP.md queue A.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from sparse_matrix_fine_tuning_torch.kernels.merged import build_merged_operands, merged_apply
from sparse_matrix_fine_tuning_torch.kernels.monarch_cuda import monarch_add, monarch_mm
from sparse_matrix_fine_tuning_torch.kernels.quant_cuda import int4_mm, int8_mm
from sparse_matrix_fine_tuning_torch.ops.blockdiag import blockdiag_multiply
from sparse_matrix_fine_tuning_torch.utils.device import resolve_device, seeded_generator

DEFAULT_PEFT_CONFIG: dict[str, Any] = {
    "nblocks": 4,
    "blk_r": 4,
    "blk_sz": None,
    "square": False,
    "adapter": True,
    "svd_init": False,
    "scaler": False,
    "scaler_type": "scaler",
    "layernorm": False,
    "affine": False,
    "lora_style_init": False,
    "use_mult_factor": False,
    "dropout": 0.0,
    "reference_orientation": False,
}

_PROJECTION_ITEM = "SVD projection: ROADMAP.md queue A, 'ops/projection.py'"


def _kaiming_block_uniform(shape, dtype, device, generator) -> torch.Tensor:
    """Uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) with fan_in = shape[-1]."""
    bound = 1.0 / math.sqrt(shape[-1])
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.uniform_(-bound, bound, generator=generator)


def keep_f32_buffers(module: nn.Module, names, fn, recurse: bool = True) -> nn.Module:
    """``nn.Module._apply`` that leaves the float32 buffers ``names`` float32,
    bit for bit: they pass through ``fn`` viewed as int32, so a device move
    applies to them and a dtype cast (``.to(torch.bfloat16)``, ``.half()``)
    does not."""
    for name in names:
        if module._buffers.get(name) is not None:
            module._buffers[name] = module._buffers[name].view(torch.int32)
    try:
        nn.Module._apply(module, fn, recurse)
    finally:
        for name in names:
            if module._buffers.get(name) is not None:
                module._buffers[name] = module._buffers[name].view(torch.float32)
    return module


class Scaler(nn.Module):
    """Scale (scalar or per-feature), then LayerNorm, on the adapter branch."""

    def __init__(self, out_features: int, scaler_type: str = "scaler", affine: bool = False,
                 *, dtype=None, param_dtype=torch.float32, device=None):
        super().__init__()
        device = resolve_device(device)
        if scaler_type not in ("scaler", "diag"):
            raise ValueError(f"scaler_type must be 'scaler' or 'diag', got {scaler_type!r}")
        self.scaler_type = scaler_type
        self.dtype = dtype
        shape = (1,) if scaler_type == "scaler" else (out_features,)
        self.scaler = nn.Parameter(torch.zeros(shape, dtype=param_dtype, device=device))
        self.norm = nn.LayerNorm(out_features, eps=1e-5, elementwise_affine=affine,
                                 dtype=param_dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x * self.scaler.to(x.dtype)
        weight, bias = self.norm.weight, self.norm.bias
        dtype = self.dtype
        if dtype is None:  # as flax: the promoted dtype of x and the norm's params
            dtype = x.dtype
            for p in (weight, bias):
                if p is not None:
                    dtype = torch.promote_types(dtype, p.dtype)
        weight = weight.to(dtype) if weight is not None else None
        bias = bias.to(dtype) if bias is not None else None
        return F.layer_norm(x.to(dtype), self.norm.normalized_shape, weight, bias,
                            self.norm.eps)


class MonarchLinear(nn.Module):
    """Monarch (MoRe) adapter layer."""

    def __init__(
        self,
        in_features: int,
        out_features: int,
        *,
        peft_config: Optional[dict] = None,
        weights: Optional[torch.Tensor] = None,
        bias: Optional[torch.Tensor] = None,
        use_bias: bool = False,
        nblocks: Optional[int] = None,
        blk_r: Optional[int] = None,
        blk_sz: Optional[int] = None,
        as_adapter: Optional[bool] = None,
        dtype: Optional[torch.dtype] = None,
        param_dtype: torch.dtype = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
    ):
        """
        Args:
          peft_config: reference-format config dict; explicit kwargs win.
          weights: dense (out_features, in_features) weight, the frozen base.
            It is kept in its own dtype and storage.
          bias: optional frozen dense bias.
          use_bias: create a uniform-init frozen bias when ``bias`` is None.
          dtype: compute dtype; None computes in the input's dtype.
          param_dtype: dtype of the adapter factors.
          device: where to build when ``weights`` is None; the card when
            None.  With ``weights``, the weights' device.
          generator: ``torch.Generator`` on ``device`` for the random init;
            a fresh one seeded with 0 when None.
        """
        super().__init__()
        cfg = dict(DEFAULT_PEFT_CONFIG)
        if peft_config:
            cfg.update({k: v for k, v in peft_config.items() if v is not None})
        if weights is not None and device is None:
            device = weights.device
        device = resolve_device(device)
        generator = seeded_generator(device, generator)
        self.in_features = in_features
        self.out_features = out_features
        self.dtype = dtype
        self.param_dtype = param_dtype

        # shape resolution (reference monarch_linear.py:119-137)
        self.nblocks = nblocks if nblocks is not None else cfg["nblocks"]
        self.blk_r = blk_r if blk_r is not None else cfg["blk_r"]
        self.blk_sz = blk_sz if blk_sz is not None else cfg["blk_sz"]
        if self.blk_sz is None:
            self.blk_sz = int(math.ceil(in_features / self.nblocks))
        self.in_blksz = self.blk_sz
        if cfg["square"]:
            self.blk_r = self.in_blksz
        self.nblocks = (in_features + self.in_blksz - 1) // self.in_blksz
        self.out_blksz = int(math.ceil(self.in_blksz * out_features / in_features))

        self.as_adapter = cfg["adapter"] if as_adapter is None else as_adapter
        if cfg["svd_init"]:
            raise NotImplementedError(f"svd_init: {_PROJECTION_ITEM}")
        if cfg.get("reference_orientation", False):
            raise NotImplementedError(f"reference_orientation: {_PROJECTION_ITEM}")
        if weights is not None and not self.as_adapter:
            raise NotImplementedError(f"projection mode: {_PROJECTION_ITEM}")
        self.lora_style_init = cfg["lora_style_init"]
        self.use_mult_factor = cfg["use_mult_factor"]
        use_scaler = cfg["scaler"] or self.use_mult_factor
        self.merged = False
        # Quantized base (quant.quantize_frozen_base): 0 bits is a float base.
        self.quant_bits = 0
        self.quant_group = 0
        self.serve_w8a8 = False
        self.register_buffer("dense_scales", None)
        # Merged-training operands (kernels/merged.py): never trained, never
        # checkpointed, None until enable_merged_training().
        self.register_buffer("wm_cache", None, persistent=False)
        self.register_buffer("wm_t_cache", None, persistent=False)

        shape1 = (self.nblocks, self.blk_r, self.in_blksz)
        shape2 = (self.nblocks, self.out_blksz, self.blk_r)
        if self.lora_style_init:
            bd1 = torch.zeros(shape1, dtype=param_dtype, device=device)
            bd2 = torch.zeros(shape2, dtype=param_dtype, device=device)
        else:
            bd1 = _kaiming_block_uniform(shape1, param_dtype, device, generator)
            if use_scaler or not self.as_adapter:
                bd2 = _kaiming_block_uniform(shape2, param_dtype, device, generator)
            else:
                bd2 = torch.zeros(shape2, dtype=param_dtype, device=device)

        if self.use_mult_factor:
            if (self.nblocks * self.in_blksz != self.out_features
                    or self.in_blksz != self.out_blksz):
                raise ValueError(
                    "use_mult_factor requires a square layer with out_features == "
                    f"nblocks * blk_sz; got in={in_features}, out={out_features}, "
                    f"nblocks={self.nblocks}, blk_sz=({self.in_blksz},{self.out_blksz})")
            eye = torch.eye(self.out_blksz, self.in_blksz, dtype=param_dtype, device=device)
            self.blkdiag_mult = nn.Parameter(eye.repeat(self.nblocks, 1, 1))

        self.blkdiag1 = nn.Parameter(bd1)
        self.blkdiag2 = nn.Parameter(bd2)
        if weights is not None:
            if tuple(weights.shape) != (out_features, in_features):
                raise ValueError(f"weights must be ({out_features}, {in_features}), "
                                 f"got {tuple(weights.shape)}")
            self.dense = nn.Parameter(weights.detach(), requires_grad=False)
        else:
            self.dense = None

        if bias is not None:
            self.bias = nn.Parameter(bias.detach(), requires_grad=False)
        elif use_bias:
            bound = 1.0 / math.sqrt(out_features)
            b = torch.empty(out_features, dtype=param_dtype, device=device)
            self.bias = nn.Parameter(b.uniform_(-bound, bound, generator=generator),
                                     requires_grad=False)
        else:
            self.bias = None

        rate = float(cfg.get("dropout") or 0.0)
        self.dropout = nn.Dropout(rate) if rate > 0 else None
        if use_scaler:
            if self.lora_style_init:
                raise ValueError("LoRA-style init already zeroes the adapter; no scaler needed")
            self.scaler = Scaler(out_features, cfg["scaler_type"], cfg["affine"],
                                 dtype=dtype, param_dtype=param_dtype, device=device)
        else:
            self.scaler = None

    def _apply(self, fn, recurse=True):
        return keep_f32_buffers(self, ("dense_scales",), fn, recurse)

    # ------------------------------------------------------------------
    def _preprocess(self, x: torch.Tensor) -> torch.Tensor:
        """Zero-pad the features up to nblocks * in_blksz."""
        pad = self.nblocks * self.in_blksz - x.shape[-1]
        return F.pad(x, (0, pad)) if pad > 0 else x

    def _postprocess(self, out: torch.Tensor) -> torch.Tensor:
        """Truncate the features down to out_features."""
        return out[..., : self.out_features] if out.shape[-1] > self.out_features else out

    def monarch_forward(self, x: torch.Tensor, *, deterministic: Optional[bool] = None
                        ) -> torch.Tensor:
        """The adapter branch: monarch(x), then dropout and Scaler."""
        w1, w2 = self.blkdiag1, self.blkdiag2
        if self.dtype is not None:
            x = x.to(self.dtype)
        w1, w2 = w1.to(x.dtype), w2.to(x.dtype)
        out = self._postprocess(monarch_mm(self._preprocess(x), w1, w2))
        if self.dropout is not None:
            if deterministic is None:
                deterministic = not self.training
            out = F.dropout(out, self.dropout.p, training=not deterministic)
        if self.scaler is not None:
            out = self.scaler(out)
        return out

    def _apply_mult(self, out: torch.Tensor) -> torch.Tensor:
        """x @ W @ M_mult: the multiplicative block-diagonal factor."""
        if self.use_mult_factor:
            out = blockdiag_multiply(out, self.blkdiag_mult.to(out.dtype))
        return out

    def _dense_forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.quant_bits:
            if self.serve_w8a8:
                from sparse_matrix_fine_tuning_torch.quant import w8a8_matmul

                return self._apply_mult(w8a8_matmul(x, self.dense, self.dense_scales))
            # as the JAX layer: int8 answers in the compute dtype, int4 in x's
            xq = x.to(self.dtype or x.dtype)
            if self.quant_bits == 8:
                out = int8_mm(xq, self.dense, self.dense_scales)
            else:
                out = int4_mm(xq, self.dense, self.dense_scales, self.quant_group).to(x.dtype)
            return self._apply_mult(out)
        if self.dtype is not None:
            x = x.to(self.dtype)
        return self._apply_mult(F.linear(x, self.dense.to(x.dtype)))

    def _can_fuse_add(self, x: torch.Tensor) -> bool:
        """Whether the fused base + monarch kernel applies: a CUDA input, no
        branch transform and no padding."""
        if not x.is_cuda:
            return False
        if self.dropout is not None or self.scaler is not None or self.use_mult_factor:
            return False
        return (self.nblocks * self.in_blksz == self.in_features
                and self.nblocks * self.out_blksz == self.out_features)

    def forward(self, x: torch.Tensor, *, deterministic: Optional[bool] = None) -> torch.Tensor:
        if self.as_adapter:
            if self.dense is None:
                raise ValueError("adapter mode requires frozen dense weights (pass `weights=`) "
                                 "or set as_adapter=False")
            if self.wm_cache is not None and not self.merged:
                out = self._merged_forward(x)
                if self.bias is not None:
                    out = out + self.bias.to(out.dtype)
                return out
            out = self._dense_forward(x)
            if not self.merged and self._can_fuse_add(x):
                out = monarch_add(out, x.to(out.dtype), self.blkdiag1.to(out.dtype),
                                  self.blkdiag2.to(out.dtype))
            elif not self.merged:
                out = out + self.monarch_forward(x, deterministic=deterministic)
        else:
            out = self.monarch_forward(x, deterministic=deterministic)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out

    # ------------------------------------------------------------------
    def adapter_dense_equivalent(self) -> torch.Tensor:
        """The dense (out, in) matrix the adapter branch currently adds,
        Scaler included: monarch_forward(I)^T."""
        eye = torch.eye(self.in_features, dtype=self.param_dtype, device=self.blkdiag1.device)
        return self.monarch_forward(eye, deterministic=True).T

    def _check_mergeable(self) -> None:
        if self.quant_bits:
            raise ValueError(
                "merge/unmerge on a quantized base: the dense holds packed "
                f"int{self.quant_bits} codes -- adding a float adapter delta "
                "into them would silently corrupt the weights.  Keep the "
                "adapter unmerged (the quantized hot path already fuses it), "
                "merge BEFORE quantize_frozen_base, or use the lossy "
                "serving-only quant.requantize_merge_adapters.")

    @torch.no_grad()
    def merge_adapter(self) -> None:
        """Fold the adapter into the frozen dense weights, in place.  With a
        Scaler the fold linearises its LayerNorm at the identity probe, as
        the reference does."""
        if not self.as_adapter or self.merged:
            return
        self._check_mergeable()
        self.dense.add_(self.adapter_dense_equivalent().to(self.dense.dtype))
        self.merged = True

    @torch.no_grad()
    def unmerge_adapter(self) -> None:
        """Split the adapter back out of the dense weights, in place."""
        if not self.as_adapter or not self.merged:
            return
        self._check_mergeable()
        self.dense.sub_(self.adapter_dense_equivalent().to(self.dense.dtype))
        self.merged = False

    # ------------------------------------------------------------------
    # Merge during training (kernels/merged.py): the frozen dense and the
    # adapter collapse into one operand, refreshed once per optimizer step.
    def can_merge_train(self) -> bool:
        """Plain additive adapter only: dropout, a Scaler or the
        multiplicative factor wrap the Monarch branch and cannot fold into
        the merged operand."""
        return (self.as_adapter and self.dense is not None and self.dropout is None
                and self.scaler is None and not self.use_mult_factor and not self.quant_bits)

    def _build_merged(self):
        dense = self.dense if self.dtype is None else self.dense.to(self.dtype)
        return build_merged_operands(dense, self.blkdiag1.to(dense.dtype),
                                     self.blkdiag2.to(dense.dtype))

    def enable_merged_training(self) -> None:
        if not self.can_merge_train():
            raise ValueError("merged training needs a plain additive adapter on a float dense "
                             "base (no dropout, Scaler or multiplicative factor)")
        self.wm_cache, self.wm_t_cache = self._build_merged()

    def refresh_merged(self) -> None:
        """Rebuild the merged operands from the current factors; the trainer
        calls this at the top of every optimizer step."""
        if self.wm_cache is None:
            return
        self.wm_cache, self.wm_t_cache = self._build_merged()

    def disable_merged_training(self) -> None:
        self.wm_cache = None
        self.wm_t_cache = None

    def _merged_forward(self, x: torch.Tensor) -> torch.Tensor:
        wm = self.wm_cache  # already in the compute dtype (_build_merged)
        return merged_apply(x.to(wm.dtype), wm, self.wm_t_cache,
                            self.blkdiag1.to(wm.dtype), self.blkdiag2.to(wm.dtype))
