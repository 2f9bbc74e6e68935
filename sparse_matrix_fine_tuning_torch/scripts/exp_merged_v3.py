"""Time the merged design's training micro-step against the unfused one on the
card: ``python -m sparse_matrix_fine_tuning_torch.scripts.exp_merged_v3``.

Counterpart of ``scripts/exp_merged_v3.py``.  The merged design folds the
Monarch adapter into the frozen dense weight once per optimizer step
(``kernels/merged.build_merged_operands``), so that each micro-batch's
forward and input gradient are one dense product each, and takes the
factor gradients from (x, dout) by a dw pass.  Each variant computes the
value and the gradients of ``sum(y.float() ** 2)``, with respect to x, w1
and w2 (x alone for the dense floor), on G micro-batches:

  dense floor    ``F.linear`` and its dx product, no adapter: the script's
                 ``loop_dense``
  unfused        the port's training path: ``F.linear``, then K2
                 (``monarch_cuda.monarch_add``), whose backward is K3; the
                 dense dx is cuBLAS: the script's "xla-unfused"
  merged[plain]  ``merged_apply`` with dw by ``monarch_dw_fused_reference``
                 (PyTorch ops): the script's "jnp"
  merged[K4]     ``merged_apply`` as merged training runs it, dw by K4: the
                 script's "pallas"
  merged[K14]    ``merged_apply`` with dw by K14
                 (``monarch_cuda.monarch_dw_merged``): the script's
                 "pallas_v2", which it defines but never times

The script's "jnp_hybrid" and "jnp_expanded" are left out: both need the
TPU's expanded W1bd/W2hat, which the port never builds.  The merge runs
once per macro step of G micro-batches and is amortised over them, as in
the script: it is timed on its own, and a merged variant's time a
micro-batch is its micro-step's plus the merge's over G.  The micro-steps
are timed in windows of REPS calls (``utils/benchlib.time_ms``, device
microseconds, the host's cost held out by a spin kernel; wall beside it),
each call on the next of the G micro-batches, so that a window stays under
300 launches.  It prints each variant's time a micro-batch, its marginal
over the dense floor and each merged variant's speedup over unfused
(:244-256).

Checks first: on micro-batch 0, every adapted variant's dx, dw1 and dw2
against the plain unfused gradients (``F.linear`` plus the plain Monarch
multiply, PyTorch's autograd), within ``GRAD_RTOL`` of each gradient's
scale; a failed check fails the script.

Shapes: the JAX script's (:167-172: x (G = 16, 2664, 4096) bf16, wd (4096,
4096), nblocks K = 4, w1 (K, r*K, n/K) and w2 (K, m/K, r*K) with r = 4, a
rank of r*K = 16 a block, wd and factors scaled 0.02) and the same with a
rank of 4 a block, the port's blk_r 4 adapters.  It needs a CUDA card and
fails without one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda
from sparse_matrix_fine_tuning_torch.kernels.merged import build_merged_operands, merged_apply
from sparse_matrix_fine_tuning_torch.ops.monarch import blockdiag_butterfly_multiply
from sparse_matrix_fine_tuning_torch.utils import benchlib

# (tag, B, n, m, nblocks, rank a block, G micro-batches)
SHAPES = [
    ("exp_merged_v3 (2664 x 4096 -> 4096, nblocks 4, rank r*K = 16, G 16)",
     2664, 4096, 4096, 4, 16, 16),
    ("blk_r 4 adapter (2664 x 4096 -> 4096, nblocks 4, rank 4, G 16)",
     2664, 4096, 4096, 4, 4, 16),
]
# A micro-step launches 15-30 kernels: REPS of them keep a timed window
# under 300 launches (utils/benchlib).
REPS, ROUNDS = 8, 5
# Each gradient against the plain unfused one, as a share of its largest
# element: the merged operand rounds wd + M once to bf16 (half an ulp of
# each weight, 2**-9 relatively), so y, and with it dout = 2y, moves by
# about one bf16 ulp; the gradients round once more to bf16.  Two bf16
# ulps of the scale, 2**-6, covers both.
GRAD_RTOL = 2.0 ** -6


def sq(y: torch.Tensor) -> torch.Tensor:
    return y.float().square().sum()


def loss_dense(x, wd, w1, w2, ops):
    return sq(F.linear(x, wd))


def loss_unfused(x, wd, w1, w2, ops):
    return sq(monarch_cuda.monarch_add(F.linear(x, wd), x, w1, w2))


def loss_plain(x, wd, w1, w2, ops):
    return sq(F.linear(x, wd) + blockdiag_butterfly_multiply(x, w1, w2))


def merged_loss(dw):
    """The merged design's loss with ``dw`` as its factor-gradient pass;
    ``ops`` is ``build_merged_operands(wd, w1, w2)``."""
    def loss(x, wd, w1, w2, ops):
        return sq(merged_apply(x, *ops, w1, w2, dw=dw))

    return loss


# name -> (loss, whether it takes the merged operands); the dense floor
# differentiates x alone.
VARIANTS = {
    "dense floor": (loss_dense, False),
    "unfused": (loss_unfused, False),
    "merged[plain]": (merged_loss(monarch_cuda.monarch_dw_fused_reference), True),
    "merged[K4]": (merged_loss(monarch_cuda.monarch_dw_any), True),
    "merged[K14]": (merged_loss(monarch_cuda.monarch_dw_merged), True),
}


def value_and_grad(loss_fn, x, wd, w1, w2, ops=None, wrt_factors: bool = True):
    """The loss and its gradients with respect to x, w1 and w2 (x alone
    where ``wrt_factors`` is False)."""
    loss = loss_fn(x, wd, w1, w2, ops)
    return (loss, *torch.autograd.grad(loss, (x, w1, w2) if wrt_factors else (x,)))


def make_inputs(b: int, n: int, m: int, nblocks: int, rank: int, g: int,
                dtype=torch.bfloat16, device="cuda", seed: int = 0):
    """xs, G micro-batches (b, n) that require a gradient; wd (m, n) frozen;
    w1 (nblocks, rank, n / nblocks) and w2 (nblocks, m / nblocks, rank) that
    require a gradient; scaled as the JAX script's (:168-172)."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=device) * scale).to(dtype)

    xs = [randn(b, n).requires_grad_() for _ in range(g)]
    wd = randn(m, n, scale=0.02)
    w1 = randn(nblocks, rank, n // nblocks, scale=0.02).requires_grad_()
    w2 = randn(nblocks, m // nblocks, rank, scale=0.02).requires_grad_()
    return xs, wd, w1, w2


ADAPTED = tuple(name for name in VARIANTS if name != "dense floor")


def check(x, wd, w1, w2, names=ADAPTED) -> dict:
    """Each adapted variant's (dx, dw1, dw2) on the micro-batch x against the
    plain unfused gradients: {name: largest error / (GRAD_RTOL * scale)}.
    Raises past 1.  (The dense floor has no adapter to hold.)"""
    ops = build_merged_operands(wd, w1, w2)
    want = value_and_grad(loss_plain, x, wd, w1, w2)[1:]
    shares = {}
    for name in names:
        loss_fn, merged = VARIANTS[name]
        got = value_and_grad(loss_fn, x, wd, w1, w2, ops if merged else None)[1:]
        share = 0.0
        for what, g, w in zip(("dx", "dw1", "dw2"), got, want):
            if g.shape != w.shape or g.dtype != w.dtype or not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"{name}: {what} {tuple(g.shape)}/{g.dtype}, expected "
                                   f"{tuple(w.shape)}/{w.dtype}, or not finite")
            err = float((g.float() - w.float()).abs().max())
            share = max(share, err / (GRAD_RTOL * float(w.float().abs().max())))
        if share > 1.0:
            raise RuntimeError(f"{name}: a gradient is {share:.3f} of its tolerance from the "
                               "plain unfused one")
        shares[name] = share
    return shares


def run(tag: str, b: int, n: int, m: int, nblocks: int, rank: int, g: int) -> dict:
    """The checks and the variants' times at one shape.  Each adapted
    variant's micro-step runs ``"steps"`` times: once for its check and
    ``benchlib.calls_per_timing(REPS, ROUNDS)`` times to time it."""
    xs, wd, w1, w2 = make_inputs(b, n, m, nblocks, rank, g)
    shares = check(xs[0], wd, w1, w2)
    print(f"{tag}: checks of dx, dw1, dw2 on micro-batch 0 against plain unfused, share of "
          f"the tolerance: " + ", ".join(f"{k} {v:.3f}" for k, v in shares.items()), flush=True)
    ops = build_merged_operands(wd, w1, w2)
    merge_ms, merge_call = benchlib.time_ms(lambda: build_merged_operands(wd, w1, w2), REPS,
                                            ROUNDS)
    print(f"  merge          {merge_ms * 1e3:9.1f} device us a macro step  "
          f"{merge_ms * 1e3 / g:7.1f} a micro-batch  (wall {merge_call * 1e3:.1f} us)",
          flush=True)
    out = {"tag": tag, "shape": [b, n, m, nblocks, rank, g], "shares": shares,
           "merge_us": merge_ms * 1e3, "steps": 1 + benchlib.calls_per_timing(REPS, ROUNDS)}
    variants = {}
    for name, (loss_fn, merged) in VARIANTS.items():
        state = {"i": 0}

        def step(loss_fn=loss_fn, merged=merged, dense=name == "dense floor"):
            x = xs[state["i"] % g]
            state["i"] += 1
            return value_and_grad(loss_fn, x, wd, w1, w2, ops if merged else None,
                                  wrt_factors=not dense)

        ms, call_ms = benchlib.time_ms(step, REPS, ROUNDS)
        us = ms * 1e3 + (merge_ms * 1e3 / g if merged else 0.0)
        variants[name] = {"us": us, "step_us": ms * 1e3, "wall_us": call_ms * 1e3}
    floor = variants["dense floor"]["us"]
    for name, v in variants.items():
        v["marginal_us"] = v["us"] - floor
        line = (f"  {name:14s} {v['us']:9.1f} device us a micro-batch (marginal "
                f"+{v['marginal_us']:.1f})  (wall {v['wall_us']:.1f} us a micro-step)")
        if name.startswith("merged"):
            v["speedup"] = variants["unfused"]["us"] / v["us"]
            line += f"  -> speedup vs unfused: {v['speedup']:.3f}x"
        print(line, flush=True)
    out["variants"] = variants
    return out


def main() -> list[dict]:
    benchlib.require_card("exp_merged_v3")
    print(f"device: {benchlib.card_line()}, torch {torch.__version__}", flush=True)
    return [run(*shape) for shape in SHAPES]


if __name__ == "__main__":
    main()
