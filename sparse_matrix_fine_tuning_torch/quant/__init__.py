"""Quantized frozen base: int8 or packed int4 dense weights under Monarch
adapters, PyTorch.

Counterpart of ``sparse_matrix_fine_tuning_tpu/quant/__init__.py``, with
its layouts bit for bit, so that a JAX state loads unchanged
(``utils/jax_bridge.py``):

  int8: per-output-column absmax, codes ``q_t (in, out)`` int8 in-major,
        ``scales (1, out)`` f32;
  int4: per-(group of input columns, output column) absmax, two nibbles a
        byte in the packed-halves layout ``packed_t (in/2, out)`` uint8:
        byte (j, o) holds input column j (low nibble) and j + in/2 (high
        nibble), offset 8; ``scales (in/group, out)`` f32, rows [0, ns/2)
        for the low half and [ns/2, ns) for the high half.

The host quantizers (``quantize_int8``, ``quantize_int4``) are numpy, as
the JAX package's; the device quantizers (``_quantize_int8_device``,
``_quantize_int4_device``) are plain torch on the weight's device.

Two things the JAX package gets from its variable types are built here:
  * frozen by type: the scales, and ``Int8LMHead``'s codes and scales, are
    persistent buffers, never parameters, so no trainable filter (the
    default one trains every parameter under ``lm_head``) can reach them;
    ``MonarchLinear.dense`` holds the codes as a parameter with
    ``requires_grad=False``, as the JAX package keeps them in its Param;
  * the scales stay float32: ``module.to(torch.bfloat16)`` casts floating
    buffers, and a scale cast to bf16 would change every output, so the
    modules that own scales keep them bit for bit (``keep_f32_buffers``).

``Int8LMHead(impl="w8a8")`` and ``MonarchLinear.serve_w8a8`` compute their
int8 x int8 -> int32 product with ``torch._int_mm``, as the JAX package
leaves it to XLA outside any Pallas kernel; ``impl="dequant"`` is a plain
dequantize-then-matmul, as the JAX package chose XLA there.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from sparse_matrix_fine_tuning_torch.kernels.quant_cuda import (  # noqa: F401 (unpack_int4)
    dequant_int4_t,
    dequant_int8_t,
    unpack_int4,
)
from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear, keep_f32_buffers


def _host_array(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        w = w.detach().float().cpu().numpy()
    return np.asarray(w, np.float32)


def quantize_int8(w):
    """(codes int8 (in, out) in-major, scales f32 (1, out)) of W (out, in), numpy."""
    w = _host_array(w)
    scales = np.abs(w).max(axis=1, keepdims=True) / 127.0
    scales = np.maximum(scales, 1e-12)
    q = np.clip(np.round(w / scales), -127, 127).astype(np.int8)
    return np.ascontiguousarray(q.T), np.ascontiguousarray(scales.astype(np.float32).T)


def dequantize_int8(q_t: torch.Tensor, scales: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """W (out, in) from the in-major layout."""
    return dequant_int8_t(q_t, scales, dtype).T


def quantize_int4(w, group_size: int = 64):
    """(packed_t uint8 (in/2, out), scales f32 (in/group_size, out)) of W
    (out, in), numpy; (in/2) must be a multiple of ``group_size``."""
    w = _host_array(w)
    out_f, in_f = w.shape
    h = in_f // 2
    if in_f % 2 or h % group_size:
        raise ValueError(f"in_features {in_f}: half must be a multiple of {group_size}")
    g = w.reshape(out_f, in_f // group_size, group_size)
    scales = np.abs(g).max(axis=-1, keepdims=True) / 7.0
    scales = np.maximum(scales, 1e-12)
    q = np.clip(np.round(g / scales), -8, 7).astype(np.int8).reshape(out_f, in_f)
    u = (q + 8).astype(np.uint8)
    packed = (u[:, :h] | (u[:, h:] << 4)).astype(np.uint8)
    return np.ascontiguousarray(packed.T), np.ascontiguousarray(scales[..., 0].astype(np.float32).T)


def dequantize_int4_halves(packed_t: torch.Tensor, scales: torch.Tensor, group_size: int = 64,
                           dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """(W_lo^T, W_hi^T), each (in/2, out), dequantized in ``dtype``."""
    return dequant_int4_t(packed_t, scales, group_size, dtype)


def dequantize_int4(packed_t: torch.Tensor, scales: torch.Tensor, group_size: int = 64,
                    dtype=torch.float32) -> torch.Tensor:
    """W (out, in) from the in-major layout."""
    lo, hi = dequant_int4_t(packed_t, scales, group_size, torch.float32)
    return torch.cat([lo, hi], dim=0).T.to(dtype)


@torch.no_grad()
def _quantize_int8_device(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_int8`` on the weight's device: (q_t (in, out), scales (1, out)).
    The absmax is multiplied by the f32 reciprocal of 127, as XLA compiles
    the JAX package's division, so that the two give the same bits."""
    w = w.float()
    scales = torch.clamp_min(w.abs().amax(dim=1, keepdim=True) * (1.0 / 127.0), 1e-12)
    q = torch.clamp(torch.round(w / scales), -127, 127).to(torch.int8)
    return q.T.contiguous(), scales.T.contiguous()


@torch.no_grad()
def _quantize_int4_device(w: torch.Tensor, group_size: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_int4`` on the weight's device: (packed_t, scales); the
    absmax times the f32 reciprocal of 7, as XLA compiles the division."""
    w = w.float()
    out_f, in_f = w.shape
    g = w.reshape(out_f, in_f // group_size, group_size)
    scales = torch.clamp_min(g.abs().amax(dim=-1, keepdim=True) * (1.0 / 7.0), 1e-12)
    q = torch.clamp(torch.round(g / scales), -8, 7).to(torch.int8).reshape(out_f, in_f)
    u = (q + 8).to(torch.uint8)
    h = in_f // 2
    packed = u[:, :h] | (u[:, h:] << 4)
    return packed.T.contiguous(), scales[..., 0].T.contiguous()


def _fit_group(in_f: int, group_size: int) -> Optional[int]:
    """Largest group <= group_size that divides in_f // 2, or None (odd
    in_f, or only groups under 8, whose f32 scales would balloon)."""
    if in_f % 2:
        return None
    half = in_f // 2
    for g in range(min(group_size, half), 7, -1):
        if half % g == 0:
            return g
    return None


def quantize_activations(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token absmax int8 activations: (codes int8, scales f32 (..., 1))."""
    xf = x.float()
    sx = torch.clamp_min(xf.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


def int8_dot(xq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """int8 (..., in) @ int8 (in, out) -> int32 (..., out) by
    ``torch._int_mm``.  On the card cuBLAS takes more than 16 rows, in
    multiples of 8: the rows are padded with zeros (which change no sum)
    and cut again."""
    *batch, k = xq.shape
    x2d = xq.reshape(-1, k)
    n = x2d.shape[0]
    if x2d.is_cuda:
        rows = max(32, -(-n // 8) * 8)
        if rows != n:
            x2d = torch.cat([x2d, x2d.new_zeros(rows - n, k)])
    return torch._int_mm(x2d.contiguous(), q)[:n].reshape(*batch, q.shape[1])


def w8a8_matmul(x: torch.Tensor, q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Per-token int8 activations times int8 codes (in, out), int32 sums,
    both scales applied to the sum; the result in x's dtype."""
    xq, sx = quantize_activations(x)
    return (int8_dot(xq, q).float() * sx * scales.float()).to(x.dtype)


class Int8LMHead(nn.Module):
    """Frozen int8 lm_head, a drop-in for the model's ``Linear`` head.

    ``impl="dequant"``: dequantize to the compute dtype, then one plain
    matmul with fp32 sums.  ``impl="w8a8"``: per-token int8 activations and
    an int8 x int8 -> int32 product (one more quantization error term).
    Codes ``kernel_q (in, vocab)`` int8 and ``scales (1, vocab)`` f32 are
    persistent buffers, kept as they are by ``.to(dtype)``."""

    def __init__(self, q_t: torch.Tensor, scales: torch.Tensor,
                 compute_dtype: Optional[torch.dtype] = None, impl: str = "dequant"):
        super().__init__()
        if impl not in ("dequant", "w8a8"):
            raise ValueError(f"impl must be 'dequant' or 'w8a8', got {impl!r}")
        self.register_buffer("kernel_q", q_t)
        self.register_buffer("scales", scales)
        self.compute_dtype = compute_dtype
        self.impl = impl

    def _apply(self, fn, recurse=True):
        return keep_f32_buffers(self, ("scales",), fn, recurse)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.impl == "w8a8":
            return w8a8_matmul(x, self.kernel_q, self.scales)
        compute = self.compute_dtype or x.dtype
        w = (self.kernel_q.float() * self.scales).to(compute)
        if compute == x.dtype:
            return x @ w
        return (x.to(compute).float() @ w.float()).to(x.dtype)


def quantize_lm_head(model: nn.Module, impl: str = "dequant") -> bool:
    """Replace ``model.lm_head`` (an untied linear head) with an
    ``Int8LMHead``, quantized on its device.  Returns False, with a note,
    for a head tied to the embedding or a head with a bias."""
    head = getattr(model, "lm_head", None)
    if head is None:
        print("[quant] lm_head is tied to the embedding; not quantized")
        return False
    if getattr(head, "bias", None) is not None:
        print("[quant] lm_head has a bias; not quantized")
        return False
    q_t, scales = _quantize_int8_device(head.weight)  # weight (vocab, in) = W
    model.lm_head = Int8LMHead(q_t, scales, compute_dtype=getattr(head, "compute_dtype", None),
                               impl=impl)
    return True


def _monarch_layers(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, MonarchLinear)]


def enable_w8a8_serving(model: nn.Module) -> int:
    """Serving-only w8a8 on every int8 layer: per-token int8 activations
    times the int8 codes, int32 sums, no weight dequantization.  Returns the
    number of layers switched (int8 layers only: int4's grouped scales do
    not ride one int32 sum)."""
    n = 0
    for m in _monarch_layers(model):
        if m.quant_bits == 8:
            m.serve_w8a8 = True
            n += 1
    return n


@torch.no_grad()
def requantize_merge_adapters(model: nn.Module) -> int:
    """Serving-only, lossy merge of each unmerged adapter into its codes:
    dequantize, add the adapter's dense equivalent, requantize with the
    same bits and group.  Layers whose branch has a Scaler or the
    multiplicative factor are skipped, as are merged or unquantized layers.
    Returns the number of layers merged."""
    n = 0
    for m in _monarch_layers(model):
        if not (m.as_adapter and not m.merged and m.quant_bits):
            continue
        if m.scaler is not None or m.use_mult_factor:
            print("[quant] requantize-merge skipping a layer with scaler/mult-factor "
                  "(branch transforms do not fold)")
            continue
        if m.quant_bits == 8:
            w = dequantize_int8(m.dense, m.dense_scales)
        else:
            w = dequantize_int4(m.dense, m.dense_scales, m.quant_group)
        w = w + m.adapter_dense_equivalent().float()
        if m.quant_bits == 8:
            q, s = _quantize_int8_device(w)
        else:
            q, s = _quantize_int4_device(w, m.quant_group)
        m.dense.data = q
        m.dense_scales = s
        m.merged = True
        n += 1
    return n


@torch.no_grad()
def quantize_frozen_base(model: nn.Module, bits: int = 8, group_size: int = 64) -> int:
    """Quantize every adapter's frozen dense weight in place, on its device,
    one layer at a time; returns the number of matrices quantized.  A layer
    whose in_features has no halves-compatible int4 group stays float."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    n = 0
    for m in _monarch_layers(model):
        if m.dense is None or not m.as_adapter or m.quant_bits:
            continue
        w = m.dense
        if bits == 8:
            q, s = _quantize_int8_device(w)
            group = group_size
        else:
            group = _fit_group(w.shape[1], group_size)
            if group is None:
                print(f"[quant] skipping {tuple(w.shape)} layer: in_features has no "
                      f"halves-compatible group <= {group_size}; stays float")
                continue
            q, s = _quantize_int4_device(w, group)
        m.dense = nn.Parameter(q, requires_grad=False)
        m.dense_scales = s
        m.quant_bits = bits
        m.quant_group = group
        n += 1
    return n
