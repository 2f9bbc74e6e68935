"""The merged design's training micro-step of the port
(``scripts/exp_merged_v3``: ``kernels/merged.merged_apply`` with its dw
pass) on the CPU, against the JAX script's own ``make_merged_apply``
(imported from the unedited ``scripts/exp_merged_v3.py``) with its
``"pallas_v2"`` dw (``dw_call_v2``, the TPU kernel K14 replaces) in
interpret mode and with its ``"jnp"`` dw (in float32 only: XLA's CPU
backend has no bfloat16 batched product with a float32 result, which that
path asks for).

The port's variant is merged[plain]: on the CPU the dw pass is the plain
``monarch_dw_fused_reference``, which K14 computes on the card.  B = 256,
``dw_call_v2``'s fixed ts, so that its one tile holds every row (it does
not mask a ragged tile); narrow widths, rank 4 and the script's rank 16.
Both sides merge wd + M once, in fp32, rounded to the working dtype.
Tolerances (``utils/testing``): float32 ``f32_logits``, 1e-4 (the factor
gradients sum over all 256 rows, in another order); bfloat16 ``bf16_atol``,
two bf16 ulps of each gradient's scale (the merged operand may round one
ulp apart where the two fp32 sums of wd + M straddle a bf16 boundary, and
the gradients round once more to bf16).
The script's own check (every variant against the plain unfused
gradients, within ``GRAD_RTOL``) is run here on its plain variants, and
its shapes are held against the JAX script's.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sparse_matrix_fine_tuning_torch.kernels.merged import build_merged_operands
from sparse_matrix_fine_tuning_torch.scripts import exp_merged_v3
from sparse_matrix_fine_tuning_torch.utils.testing import TOLERANCES, bf16_atol, to_numpy, to_torch

ROOT = Path(__file__).resolve().parents[1]
B, N, M, NBLOCKS = 256, 128, 96, 4


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "exp_merged_v3_jax", ROOT / "scripts" / "exp_merged_v3.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_SCRIPT = _jax_script()


def _arrays(rank, seed=0):
    """x (B, N), wd (M, N), w1 (NBLOCKS, rank, N / NBLOCKS), w2 (NBLOCKS,
    M / NBLOCKS, rank); wd scaled 0.02 as the script's, the factors by one
    over the root of their reduced width, so that at these narrow widths
    the adapter's part of y is not lost under the dense's."""
    rng = np.random.default_rng(seed)
    p = N // NBLOCKS
    return (rng.standard_normal((B, N)).astype(np.float32),
            (rng.standard_normal((M, N)) * 0.02).astype(np.float32),
            (rng.standard_normal((NBLOCKS, rank, p)) / np.sqrt(p)).astype(np.float32),
            (rng.standard_normal((NBLOCKS, M // NBLOCKS, rank)) / np.sqrt(rank)).astype(np.float32))


def _jax_grads(impl, x, wd, w1, w2, dtype):
    """Gradients of sum(y**2) with respect to x, w1 and w2 through the
    script's merged apply with the dw ``impl``, in interpret mode."""
    jx, jwd, jw1, jw2 = (jnp.asarray(a, dtype) for a in (x, wd, w1, w2))
    wm, wm_t, w1bd, w2hat = JAX_SCRIPT.build_merged(jwd.T, jw1, jw2)
    apply_fn = JAX_SCRIPT.make_merged_apply(impl)

    def loss(v, a, b):
        return jnp.sum(apply_fn(v, wm, wm_t, w1bd, w2hat, a, b).astype(jnp.float32) ** 2)

    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(loss, argnums=(0, 1, 2))(jx, jw1, jw2)
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize("rank", [4, 16])
@pytest.mark.parametrize("impl, dtype", [("pallas_v2", "float32"), ("pallas_v2", "bfloat16"),
                                         ("jnp", "float32")])
def test_torch_merged_v3_plain_matches_jax(impl, dtype, rank):
    arrays = _arrays(rank, seed=rank)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want = _jax_grads(impl, *arrays, jdt)
    x, wd, w1, w2 = (to_torch(a, tdt) for a in arrays)
    x, w1, w2 = (t.requires_grad_() for t in (x, w1, w2))
    loss_fn, merged = exp_merged_v3.VARIANTS["merged[plain]"]
    assert merged
    got = exp_merged_v3.value_and_grad(loss_fn, x, wd, w1, w2,
                                       build_merged_operands(wd, w1, w2))[1:]
    for g, w in zip(got, want):
        assert g.dtype == tdt and tuple(g.shape) == w.shape
        if dtype == "float32":
            np.testing.assert_allclose(to_numpy(g), w, **TOLERANCES["f32_logits"])
        else:
            assert np.abs(to_numpy(g) - w).max() <= bf16_atol(w)


@pytest.mark.parametrize("rank", [4, 16])
def test_torch_merged_v3_check_passes_on_plain_variants(rank):
    """The script's own check, bf16, on the adapted variant that runs on the
    CPU."""
    xs, wd, w1, w2 = exp_merged_v3.make_inputs(B, N, M, NBLOCKS, rank, 2, device="cpu")
    shares = exp_merged_v3.check(xs[1], wd, w1, w2, names=("merged[plain]",))
    assert list(shares) == ["merged[plain]"] and 0.0 < shares["merged[plain]"] <= 1.0
    assert exp_merged_v3.ADAPTED == ("unfused", "merged[plain]", "merged[K4]", "merged[K14]")


def test_torch_merged_v3_shapes_are_the_jax_scripts():
    src = (ROOT / "scripts" / "exp_merged_v3.py").read_text()
    b, n, m, k, r, g = (int(v) for v in re.search(
        r"B, n, m, K, r, G = (\d+), (\d+), (\d+), (\d+), (\d+), (\d+)", src).groups())
    (_, *script), (_, *adapter) = exp_merged_v3.SHAPES
    assert script == [b, n, m, k, r * k, g] == [2664, 4096, 4096, 4, 16, 16]
    assert adapter == [b, n, m, k, 4, g]
    assert list(exp_merged_v3.VARIANTS) == ["dense floor", "unfused", "merged[plain]",
                                            "merged[K4]", "merged[K14]"]
