"""Dequantize-matmul kernels of the quantized frozen base on the card
(K5-K8), their autograd Functions, and their plain versions.

``int8_matmul`` and ``int4_matmul`` launch the hand-written CUDA kernels of
``csrc/quant_matmul.cu``: the forward (K7 for int8, K5 for int4) and, as
the autograd backward, the input gradient (K8, K6).  With bfloat16
activations, the dx kernels and the forwards above 16 rows run in
``csrc/quant_wgmma.cu``'s warp-specialised wgmma + TMA kernels (int4
unpacked once for both halves into B in shared memory, int8 into wgmma's A
operand in registers); the decode rows (M <= 16, one launch of
``quant_matmul.cu``'s ``qgemv_kernel``: mma.sync on bf16 x, f32 FMA on f32
x, the split over code rows reduced across a thread block cluster) and
float32 activations stay in ``quant_matmul.cu``.  They replace
``int8_matmul`` and ``int4_matmul`` of
``sparse_matrix_fine_tuning_tpu/kernels/quant_matmul.py`` and take CUDA
tensors only: nothing here moves work to the plain path or to the CPU.
``int8_mm`` and ``int4_mm`` dispatch by device alone: a CUDA tensor goes
to the kernel, a CPU tensor to the plain version (the CPU tests' mode).

Layouts (``quant/__init__.py``, in-major, bit for bit the JAX package's):
  int8: ``q_t (in, out)`` int8, ``scales (1, out)`` f32;
  int4: ``packed_t (in/2, out)`` uint8, byte (j, o) holding input column j
        in the low nibble and j + in/2 in the high nibble, offset 8;
        ``scales (in/group, out)`` f32, the scale of input column j being
        row j // group (the high half's rows start at ns/2, as
        (in/2) % group == 0).

Semantics, for x of dtype T (float32 or bfloat16) and W the dequantized
(in, out) matrix rounded to T once per cell, W[j, o] = round_T(q[j, o] *
s[j // group, o]):
  forward   y  = round_T( sum_j x[m, j] * W[j, o] )     (fp32 sums)
  backward  dx = round_T( sum_o dy[m, o] * W[j, o] )    (fp32 sums over all of out)
The codes and scales are frozen: their gradient is None, where the JAX
package returns structural zeros.

K16 (``int4_variant_matmul``, ``csrc/quant_matmul.cu``'s decode kernel
``qgemv_kernel`` with its per-cell arithmetic a template parameter) replaces the Pallas
kernels of ``scripts/exp_int4_dequant_variants.py``: seven arithmetic
variants (``INT4_VARIANTS``) of the int4 product for bf16 x, with u = the
nibble, q = u - 8, s = the f32 scale and bf() a rounding to bf16, each
summed in fp32 and rounded to bf16 once (the raw output):
  f32mul   x @ bf(q * s)                K5's arithmetic
  bf16mul  x @ bf(q * bf(s))            (mul3d: the same function)
  ucorr    x @ bf(u * bf(s))
  ugdot    sum over groups of s * (x_group @ u_group)
  f32dot   x @ (q * s)                  (f32 cells, the JAX int4 kernel at b <= 64)
  u2dot    x @ (u * s) - 8 * x @ s
``int4_variant`` finishes a variant as the script does: ucorr and ugdot
subtract ``unsigned_correction`` (torch ops, outside the kernel, as in
JAX) from the bf16 raw output and round to bf16 again.

``LAUNCHES`` counts the launches of each kernel: a wrapper adds one where it
launches its kernel, and nowhere else.
"""

from __future__ import annotations

import torch

from sparse_matrix_fine_tuning_torch.kernels.monarch_cuda import load_ops

LAUNCHES = {"int8_matmul": 0, "int8_matmul_dx": 0, "int4_matmul": 0, "int4_matmul_dx": 0,
            "int4_variant": 0}

INT4_VARIANTS = ("f32mul", "bf16mul", "mul3d", "ucorr", "ugdot", "f32dot", "u2dot")
# the kernel's arithmetic (csrc/quant_matmul.cu `Arith`) of each variant
_ARITH = {"f32mul": 0, "bf16mul": 1, "mul3d": 1, "ucorr": 2, "ugdot": 3, "f32dot": 4, "u2dot": 5}
UNSIGNED_VARIANTS = ("ucorr", "ugdot")  # finished by subtracting unsigned_correction


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# -- dequantization, shared by the plain versions ----------------------------

def dequant_int8_t(q_t: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The dequantized (in, out) matrix, each cell rounded to ``dtype`` once."""
    return (q_t.float() * scales.float()).to(dtype)


def unpack_int4(packed_t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo_t, hi_t) int8 codes, each (in/2, out): input columns [0, in/2)
    and [in/2, in)."""
    lo = (packed_t & 0xF).to(torch.int8) - 8
    hi = ((packed_t >> 4) & 0xF).to(torch.int8) - 8
    return lo, hi


def dequant_int4_t(packed_t: torch.Tensor, scales: torch.Tensor, group: int,
                   dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(low half, high half), each (in/2, out) dequantized in ``dtype``: the
    grouped scale row j // group broadcast along the leading axis."""
    lo, hi = unpack_int4(packed_t)
    ns = scales.shape[0]
    s = scales.float()
    s_lo = s[: ns // 2].repeat_interleave(group, dim=0)
    s_hi = s[ns // 2:].repeat_interleave(group, dim=0)
    return (lo.float() * s_lo).to(dtype), (hi.float() * s_hi).to(dtype)


# -- plain versions ----------------------------------------------------------

def int8_matmul_reference(x: torch.Tensor, q_t: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K7 (differentiable; its gradient of x is
    K8's function).  x (..., in) -> (..., out) in x's dtype."""
    w = dequant_int8_t(q_t, scales, x.dtype)
    return (x.float() @ w.float()).to(x.dtype)


def int8_matmul_dx_reference(dy: torch.Tensor, q_t: torch.Tensor,
                             scales: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8: dy (..., out) -> dx (..., in)."""
    w = dequant_int8_t(q_t, scales, dy.dtype)
    return (dy.float() @ w.float().T).to(dy.dtype)


def int4_matmul_reference(x: torch.Tensor, packed_t: torch.Tensor, scales: torch.Tensor,
                          group: int) -> torch.Tensor:
    """Plain PyTorch version of K5: ``x_lo @ W_lo + x_hi @ W_hi`` in fp32,
    one rounding (differentiable; its gradient of x is K6's function)."""
    lo, hi = dequant_int4_t(packed_t, scales, group, x.dtype)
    h = packed_t.shape[0]
    xf = x.float()
    return (xf[..., :h] @ lo.float() + xf[..., h:] @ hi.float()).to(x.dtype)


def int4_matmul_dx_reference(dy: torch.Tensor, packed_t: torch.Tensor, scales: torch.Tensor,
                             group: int) -> torch.Tensor:
    """Plain PyTorch version of K6: dy (..., out) -> dx (..., in)."""
    lo, hi = dequant_int4_t(packed_t, scales, group, dy.dtype)
    dyf = dy.float()
    return torch.cat([dyf @ lo.float().T, dyf @ hi.float().T], dim=-1).to(dy.dtype)


def _arith(variant: str) -> int:
    if variant not in _ARITH:
        raise ValueError(f"unknown int4 variant {variant!r}; expected one of {INT4_VARIANTS}")
    return _ARITH[variant]


def _variant_cells(packed_t: torch.Tensor, scales: torch.Tensor, group: int,
                   variant: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(low half, high half) of the weight cells a variant multiplies x by,
    each (in/2, out) f32 (holding bf16 values where the variant rounds)."""
    if variant == "f32mul":
        return tuple(w.float() for w in dequant_int4_t(packed_t, scales, group, torch.bfloat16))
    signed = variant in ("bf16mul", "mul3d", "f32dot")
    codes = unpack_int4(packed_t) if signed else (packed_t & 0xF, (packed_t >> 4) & 0xF)
    ns = scales.shape[0]
    halves = (scales[: ns // 2], scales[ns // 2:])
    out = []
    for q, s in zip(codes, halves):
        if variant in ("f32dot", "u2dot"):
            out.append(q.float() * s.float().repeat_interleave(group, dim=0))
        else:  # bf16 product of bf16 operands (exact in f32, then rounded once)
            sb = s.to(torch.bfloat16).repeat_interleave(group, dim=0)
            out.append((q.to(torch.bfloat16) * sb).float())
    return out[0], out[1]


def int4_variant_reference(x: torch.Tensor, packed_t: torch.Tensor, scales: torch.Tensor,
                           group: int, variant: str) -> torch.Tensor:
    """Plain PyTorch version of K16: the raw output of ``variant`` (one of
    ``INT4_VARIANTS``) for x (..., in), op for op the arithmetic in the
    module's docstring, in x's dtype."""
    _arith(variant)
    *batch, in_f = x.shape
    h, out_f = packed_t.shape
    xf = x.reshape(-1, in_f).float()
    x_lo, x_hi = xf[:, :h], xf[:, h:]
    if variant == "ugdot":
        ns = scales.shape[0]
        y = 0
        for xh, u, s in ((x_lo, packed_t & 0xF, scales[: ns // 2]),
                         (x_hi, (packed_t >> 4) & 0xF, scales[ns // 2:])):
            ns2 = s.shape[0]
            x3 = xh.reshape(-1, ns2, group).transpose(0, 1)        # (ns2, b, g)
            t = torch.bmm(x3, u.float().reshape(ns2, group, out_f))  # (ns2, b, out)
            y = y + (t * s.float()[:, None, :]).sum(0)
    elif variant == "u2dot":
        w_lo, w_hi = _variant_cells(packed_t, scales, group, variant)
        sb = scales.float().repeat_interleave(group, dim=0)  # (in, out): low rows, then high
        y = (x_lo @ w_lo - 8.0 * (x_lo @ sb[:h])) + (x_hi @ w_hi - 8.0 * (x_hi @ sb[h:]))
    else:
        w_lo, w_hi = _variant_cells(packed_t, scales, group, variant)
        y = x_lo @ w_lo + x_hi @ w_hi
    return y.to(x.dtype).reshape(*batch, out_f)


def unsigned_correction(x: torch.Tensor, scales: torch.Tensor, group: int) -> torch.Tensor:
    """``8 * (group_sums(x) @ s)`` over both halves, f32 (b, out): the term
    that turns the unsigned nibbles of ucorr and ugdot back into the
    offset-8 codes (``scripts/exp_int4_dequant_variants.py:244``)."""
    *batch, in_f = x.shape
    ns = scales.shape[0]
    xs = x.reshape(-1, ns, group).sum(-1, dtype=torch.float32)  # (b, ns): low groups, then high
    s = scales.float()
    y = xs[:, : ns // 2] @ s[: ns // 2] + xs[:, ns // 2:] @ s[ns // 2:]
    return (8.0 * y).reshape(*batch, scales.shape[1])


def finish_int4_variant(raw: torch.Tensor, x: torch.Tensor, scales: torch.Tensor, group: int,
                        variant: str) -> torch.Tensor:
    """A variant's result from its raw output: ucorr and ugdot subtract
    ``unsigned_correction`` from the bf16 raw output in f32 and round once
    more; the others are their raw output."""
    if variant not in UNSIGNED_VARIANTS:
        return raw
    return (raw.float() - unsigned_correction(x, scales, group)).to(x.dtype)


# -- kernels -----------------------------------------------------------------

def _check(*tensors: torch.Tensor) -> None:
    """Raise unless every operand lies on the card.  The binding
    (``csrc/ops.cpp``) checks dtypes, shapes, contiguity and alignment and
    raises on anything the kernels do not take; the checks stay there, in
    C++, because a decode step calls these wrappers 154 times."""
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"the quantized-matmul CUDA kernels take CUDA tensors, got one on "
                             f"{t.device}")


def _launch(name: str, a: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
            group: int = 0, arith: int = 0) -> torch.Tensor:
    ops = load_ops()
    *batch, width = a.shape
    a2d = a.reshape(-1, width).contiguous()
    if a2d.data_ptr() % 16:  # the kernels load 16 bytes a thread
        a2d = a2d.clone()
    if name == "int8_matmul":
        out = ops.int8_mm(a2d, codes, scales)
    elif name == "int8_matmul_dx":
        out = ops.int8_mm_dx(a2d, codes, scales)
    elif name == "int4_matmul":
        out = ops.int4_mm(a2d, codes, scales, group)
    elif name == "int4_variant":
        out = ops.int4_variant_mm(a2d, codes, scales, group, arith)
    else:
        out = ops.int4_mm_dx(a2d, codes, scales, group)
    LAUNCHES[name] += 1
    return out.reshape(*batch, out.shape[-1])


def int8_matmul_dx(dy: torch.Tensor, q_t: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """K8: dx (..., in) of ``x @ W`` from dy (..., out), in dy's dtype."""
    _check(dy, q_t, scales)
    return _launch("int8_matmul_dx", dy, q_t, scales)


def int4_matmul_dx(dy: torch.Tensor, packed_t: torch.Tensor, scales: torch.Tensor,
                   group: int) -> torch.Tensor:
    """K6: dx (..., in) of ``x @ W`` from dy (..., out), in dy's dtype."""
    _check(dy, packed_t, scales)
    return _launch("int4_matmul_dx", dy, packed_t, scales, int(group))


class _Int8MatmulFn(torch.autograd.Function):
    """K7 forward, K8 backward; codes and scales get no gradient."""

    @staticmethod
    def forward(ctx, x, q_t, scales):
        ctx.save_for_backward(q_t, scales)
        ctx.x_dtype = x.dtype
        return _launch("int8_matmul", x, q_t, scales)

    @staticmethod
    def backward(ctx, dy):
        q_t, scales = ctx.saved_tensors
        return int8_matmul_dx(dy.to(ctx.x_dtype), q_t, scales), None, None


class _Int4MatmulFn(torch.autograd.Function):
    """K5 forward, K6 backward; codes and scales get no gradient."""

    @staticmethod
    def forward(ctx, x, packed_t, scales, group):
        ctx.save_for_backward(packed_t, scales)
        ctx.x_dtype, ctx.group = x.dtype, group
        return _launch("int4_matmul", x, packed_t, scales, group)

    @staticmethod
    def backward(ctx, dy):
        packed_t, scales = ctx.saved_tensors
        return int4_matmul_dx(dy.to(ctx.x_dtype), packed_t, scales, ctx.group), None, None, None


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def int8_matmul(x: torch.Tensor, q_t: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """K7: ``y = x @ dequant(q_t, scales)`` with the dequantization in the
    kernel.  x (..., in) float32 or bfloat16; y (..., out) in x's dtype.
    Differentiable in x: the gradient is K8 (without a graph to record, the
    kernel is launched without the autograd Function)."""
    _check(x, q_t, scales)
    if _needs_grad(x):
        return _Int8MatmulFn.apply(x, q_t, scales)
    return _launch("int8_matmul", x, q_t, scales)


def int4_matmul(x: torch.Tensor, packed_t: torch.Tensor, scales: torch.Tensor,
                group: int) -> torch.Tensor:
    """K5: ``y = x @ dequant(packed_t, scales)`` with the nibble unpack and
    the dequantization in the kernel.  Differentiable in x: the gradient is
    K6."""
    _check(x, packed_t, scales)
    if _needs_grad(x):
        return _Int4MatmulFn.apply(x, packed_t, scales, int(group))
    return _launch("int4_matmul", x, packed_t, scales, int(group))


def int8_mm(x: torch.Tensor, q_t: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Device dispatch of K7: the kernel on CUDA, the plain version on the CPU."""
    if x.is_cuda:
        return int8_matmul(x, q_t, scales)
    return int8_matmul_reference(x, q_t, scales)


def int4_mm(x: torch.Tensor, packed_t: torch.Tensor, scales: torch.Tensor,
            group: int) -> torch.Tensor:
    """Device dispatch of K5: the kernel on CUDA, the plain version on the CPU."""
    if x.is_cuda:
        return int4_matmul(x, packed_t, scales, group)
    return int4_matmul_reference(x, packed_t, scales, group)

def int4_variant_matmul(x: torch.Tensor, packed_t: torch.Tensor, scales: torch.Tensor,
                        group: int, variant: str) -> torch.Tensor:
    """K16: the raw output of ``variant`` for bf16 x (..., in) on the card.
    Refuses an unknown variant, x not bfloat16 and CPU tensors before any
    build; the binding checks the rest."""
    arith = _arith(variant)
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the int4 variants take bfloat16 x, got {x.dtype}")
    _check(x, packed_t, scales)
    return _launch("int4_variant", x, packed_t, scales, int(group), arith)


# The decode kernel's plan (csrc/quant_matmul.cu ``smft_quant_decode_plan``):
# output columns a CTA, slices of the code rows (the CTAs of a cluster),
# CTAs of the launch, ring slots a warp, CTAs an SM (the occupancy at the
# plan's shared memory), blocks of rows of x and rows a block, code rows a
# slice and a chunk of it, shared memory bytes a CTA, and whether the
# product runs on mma.sync (1) or f32 FMA (0).
PLAN_FIELDS = ("col_tile", "slices", "ctas", "stages", "ctas_per_sm", "row_blocks", "rows",
               "slice_rows", "chunk_rows", "smem", "mma")
# One row of ``decode_attrs`` a decode-kernel instantiation.
ATTR_FIELDS = ("bits", "bf16", "arith", "rows", "registers", "local_bytes", "ctas_per_sm",
               "threads")


def decode_plan(bits: int, dtype: torch.dtype, m_rows: int, in_f: int, out_f: int,
                group: int = 64) -> dict:
    """The launch plan of K5 (``bits`` 4) or K7 (8) at ``m_rows`` <= 16 rows
    of x in ``dtype`` on the current card (``PLAN_FIELDS``)."""
    plan = load_ops().quant_decode_plan(int(bits), dtype == torch.bfloat16, int(m_rows),
                                        int(in_f), int(out_f), int(group), 0)
    return dict(zip(PLAN_FIELDS, plan))


def decode_attrs() -> list[dict]:
    """Registers, local memory and CTAs an SM (at the most shared memory a
    CTA takes) of every instantiation of the decode kernel (``ATTR_FIELDS``)."""
    flat = load_ops().quant_decode_attrs()
    n = len(ATTR_FIELDS)
    return [dict(zip(ATTR_FIELDS, flat[i:i + n])) for i in range(0, len(flat), n)]


def decode_empty(bits: int, dtype: torch.dtype, m_rows: int, in_f: int, out_f: int,
                 group: int = 64) -> None:
    """Launch the decode call's floor: an empty kernel at the grid, cluster,
    threads and shared memory ``decode_plan`` gives.  Not a kernel of the
    path: it is not counted in ``LAUNCHES``."""
    load_ops().quant_decode_empty(int(bits), dtype == torch.bfloat16, int(m_rows), int(in_f),
                                  int(out_f), int(group))


def int4_variant_plan(m_rows: int, in_f: int, out_f: int, variant: str) -> dict:
    """K16's launch plan on the current card at group 64 (``PLAN_FIELDS``):
    the decode kernel's, blocks of ``rows`` rows of x past 16 rows."""
    plan = load_ops().quant_decode_plan(4, True, int(m_rows), int(in_f), int(out_f), 64,
                                        _arith(variant))
    return dict(zip(PLAN_FIELDS, plan))


def int4_variant(x: torch.Tensor, packed_t: torch.Tensor, scales: torch.Tensor, group: int,
                 variant: str) -> torch.Tensor:
    """The whole variant, as the script calls it: the raw output (K16 on
    CUDA, the plain version on the CPU), finished by
    ``finish_int4_variant``."""
    if x.is_cuda:
        raw = int4_variant_matmul(x, packed_t, scales, group, variant)
    else:
        raw = int4_variant_reference(x, packed_t, scales, group, variant)
    return finish_int4_variant(raw, x, scales, group, variant)
