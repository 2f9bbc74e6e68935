"""Parity and speed of the attention implementations on the card:
``python -m sparse_matrix_fine_tuning_torch.scripts.bench_attention``.

Counterpart of ``scripts/bench_attention.py``, at its shape: one
Llama-7B-shaped attention, b 4, t 1024, 32 heads, head_dim 128, bfloat16,
q, k and v N(0, 1) from a seeded generator (the JAX script's key draws other
numbers).  The three paths of ``LlamaAttention``:

  einsum  the JAX script's ``einsum_attn``: bf16 scores times the scale plus
          the causal bias, softmax in fp32, probabilities in bf16, times v
  dpa     ``models/llama._dpa_attention`` with the causal bias (the JAX
          script's ``jax.nn.dot_product_attention(is_causal=True)``)
  splash  ``models/llama._splash_attention``: K17 forward, K18 and K19 in
          the backward (``kernels/attention_cuda.py``)

It prints the card's name and power limit; the max difference of dpa and of
splash against einsum; then, for each path, the device and wall
microseconds of a step (the value and the gradients with respect to q, k
and v of ``sum(out.float() ** 2)``; ``utils/benchlib.time_ms``), its
TFLOP/s by the JAX script's FLOP count (``jax_flops``: 4 b h t^2 d x 2 x 1.5,
"fwd + ~2x bwd, causal ~0.5") and its share of ``bound_ms``; last
``torch.nn.functional.scaled_dot_product_attention(is_causal=True)`` as the
library line, timed only: the port never calls it.  It needs a CUDA card
and fails without one; its functions take any device (the CPU tests).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparse_matrix_fine_tuning_torch.models.llama import _dpa_attention, _splash_attention
from sparse_matrix_fine_tuning_torch.ops.attention import attention_cost
from sparse_matrix_fine_tuning_torch.utils import benchlib

SHAPE = (4, 1024, 32, 128)  # (b, t, heads, head_dim): scripts/bench_attention.py:17
# timed rounds of ITERS steps: an einsum step launches a few dozen kernels,
# and a timed window stays under a few hundred launches (utils/benchlib)
ROUNDS, ITERS = 5, 5


def make_inputs(shape=SHAPE, dtype=torch.bfloat16, device="cuda", seed: int = 0):
    """q, k, v (b, t, heads, head_dim), N(0, 1) from a seeded generator on
    ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(*shape, generator=g, device=device).to(dtype) for _ in range(3)]


def _causal_bias(q: torch.Tensor) -> torch.Tensor:
    t = q.shape[1]
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    return torch.where(keep, 0.0, -1e9).to(q.dtype)[None, None]


def einsum_attn(q, k, v):
    # the scale in q's dtype, as JAX multiplies a bf16 array by a Python float
    scale = float(torch.tensor(1.0 / q.shape[-1] ** 0.5, dtype=q.dtype))
    scores = torch.einsum("bthd,bshd->bhts", q, k) * scale + _causal_bias(q)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def dpa_attn(q, k, v):
    return _dpa_attention(q, k, v, _causal_bias(q), 1.0 / q.shape[-1] ** 0.5)


def splash_attn(q, k, v):
    return _splash_attention(q, k, v)


def sdpa_attn(q, k, v):
    """The library line: PyTorch's fused causal attention, (b, heads, t, d)."""
    out = F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                         v.transpose(1, 2), is_causal=True)
    return out.transpose(1, 2)


PATHS = {"einsum": einsum_attn, "dpa": dpa_attn, "splash": splash_attn}


def value_and_grad(fn, q, k, v):
    """``sum(fn(q, k, v).float() ** 2)`` and its gradients w.r.t. q, k, v."""
    loss = fn(q, k, v).float().square().sum()
    return (loss, *torch.autograd.grad(loss, (q, k, v)))


def max_diffs(q, k, v) -> dict:
    """The max |difference| of dpa's and splash's output against einsum's."""
    with torch.no_grad():
        ref = einsum_attn(q, k, v).float()
        return {name: float((PATHS[name](q, k, v).float() - ref).abs().max())
                for name in ("dpa", "splash")}


def jax_flops(b: int, t: int, h: int, d: int) -> float:
    """The JAX script's FLOPs a step (scripts/bench_attention.py:68)."""
    return 4 * b * h * t * t * d * 2 * 1.5


def bound_ms(b: int, t: int, h: int, d: int, dtype=torch.bfloat16) -> tuple[float, str]:
    """Least ms a step could take (``ops/attention.attention_cost``'s
    ``"step"``): q, k, v read and dq, dk, dv written once; six causal
    products of t (t + 1) / 2 query-key pairs by d."""
    return benchlib.roofline_ms(*attention_cost("step", (b, t, h, d), dtype), dtype)


def run(shape=SHAPE) -> dict:
    """The cross-check, then each path's and SDPA's step times at ``shape``.
    Each path runs ``benchlib.calls_per_timing(ITERS, ROUNDS)`` steps
    (``"steps"``); the cross-check runs each forward once more, without a
    gradient."""
    b, t, h, d = shape
    q, k, v = make_inputs(shape)
    diffs = max_diffs(q, k, v)
    for name, diff in diffs.items():
        print(f"{name}: max diff vs einsum = {diff:.4f}", flush=True)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    bound, bound_by = bound_ms(b, t, h, d)
    flops = jax_flops(b, t, h, d)
    out = {"shape": shape, "diffs": diffs, "bound_ms": bound, "bound_by": bound_by,
           "steps": benchlib.calls_per_timing(ITERS, ROUNDS)}
    for name, fn in {**PATHS, "sdpa (library)": sdpa_attn}.items():
        ms, wall_ms = benchlib.time_ms(lambda: value_and_grad(fn, q, k, v), ITERS, ROUNDS)
        print(f"{name}: {ms * 1e3:8.1f} us/iter fwd+bwd on the device, {wall_ms * 1e3:8.1f} wall "
              f"(~{flops / (ms / 1e3) / 1e12:.1f} TFLOP/s by the JAX script's count; bound "
              f"{bound * 1e3:.1f} us ({bound_by}), {bound / ms:.1%} of it)", flush=True)
        out[name.split()[0]] = {"us": ms * 1e3, "wall_us": wall_ms * 1e3}
    return out


def main() -> dict:
    benchlib.require_card("bench_attention")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    return run()


if __name__ == "__main__":
    main()
