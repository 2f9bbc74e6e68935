"""The int4 dequant-arithmetic variants of the port (K16's plain versions,
``quant_cuda.int4_variant_reference``, ``unsigned_correction`` and
``int4_variant``) and the port of ``scripts/exp_int4_dequant_variants.py``,
on the CPU.

Each of the seven variants' plain version is held against the JAX script's
own Pallas call (imported from the unedited script, run in interpret mode
on the CPU by the script itself), raw output and finished variant, at
B 4 and 13 and (in, out, group) (512, 256, 64) and (768, 128, 32).
Tolerance: two bf16 ulps of the raw output's scale (``bf16_atol``): both
sides sum in fp32 in another order and round the output once.  Beside
them: JAX's bf16mul equals its mul3d bit for bit; the port's f32mul equals
K5's plain version bit for bit; its f32dot against the JAX production int4
kernel (``int4_matmul(..., interpret=True)``, whose b <= 64 branch keeps the
cells in f32) within f32 sum order, each side rounding once to bf16;
``unsigned_correction`` against JAX's at 1e-5 of its scale; the bf16 pair
arithmetic the kernel uses for bf16mul, ucorr and ugdot against the plain
cells; and the script's shapes, group, seed, bounds and weight rotation.
"""

import ast
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_matrix_fine_tuning_torch.kernels import quant_cuda as qc
from sparse_matrix_fine_tuning_torch.scripts import exp_int4_dequant_variants as script
from sparse_matrix_fine_tuning_torch.utils.testing import bf16_atol, to_numpy, to_torch
from sparse_matrix_fine_tuning_tpu.kernels import quant_matmul as jqm
from sparse_matrix_fine_tuning_tpu.quant import quantize_int4

ROOT = Path(__file__).resolve().parents[1]
JAX_SCRIPT_PATH = ROOT / "scripts" / "exp_int4_dequant_variants.py"
SOURCE = ROOT / "sparse_matrix_fine_tuning_torch" / "kernels" / "csrc" / "quant_matmul.cu"
# (B, in, out, group)
CASES = [(4, 512, 256, 64), (13, 512, 256, 64), (4, 768, 128, 32), (13, 768, 128, 32)]


def _jax_script():
    spec = importlib.util.spec_from_file_location("exp_int4_dequant_variants_jax",
                                                  JAX_SCRIPT_PATH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_SCRIPT = _jax_script()


def _jax_call(name: str):
    s = JAX_SCRIPT
    return {"f32mul": s.make_call(s._unpack_f32mul), "bf16mul": s.make_call(s._unpack_bf16mul),
            "mul3d": s.make_call(s._unpack_mul3d), "ucorr": s.make_call(s._unpack_ucorr),
            "ugdot": s.gdot_call, "f32dot": s.make_ukern_call("f32dot"),
            "u2dot": s.make_ukern_call("u2dot")}[name]


def _operands(b, n_in, n_out, group, seed=0):
    """Numpy codes, scales and x (bf16 values in f32), made as the JAX
    script makes them, and their copies for each framework."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n_out, n_in)) * 0.02).astype(np.float32)
    packed, scales = (np.array(a) for a in quantize_int4(w, group_size=group))
    x = np.asarray(jnp.asarray(rng.normal(size=(b, n_in)), jnp.bfloat16).astype(jnp.float32))
    jax_side = (jnp.asarray(x.copy(), jnp.bfloat16), jnp.asarray(packed.copy()),
                jnp.asarray(scales.copy()))
    torch_side = (to_torch(x, torch.bfloat16), to_torch(packed), to_torch(scales))
    return jax_side, torch_side


def _jax_raw(name, jx, jp, js, group):
    ns = js.shape[0]
    b = jx.shape[0]
    y = _jax_call(name)(jx, jp, js[: ns // 2], js[ns // 2:], group, b, 128)
    return np.asarray(y.astype(jnp.float32))


def _jax_finished(name, raw, jx, js, group):
    if name not in ("ucorr", "ugdot"):
        return raw
    ns = js.shape[0]
    corr = JAX_SCRIPT.unsigned_correction(jx, js[: ns // 2], js[ns // 2:], group)
    return np.asarray((jnp.asarray(raw) - corr).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", qc.INT4_VARIANTS)
def test_torch_int4_variant_plain_matches_jax_script(name, case):
    b, n_in, n_out, group = case
    (jx, jp, js), (tx, tp, ts) = _operands(*case)
    want = _jax_raw(name, jx, jp, js, group)
    got = qc.int4_variant_reference(tx, tp, ts, group, name)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, n_out)
    tol = bf16_atol(want)
    assert np.abs(to_numpy(got) - want).max() <= tol
    finished = qc.int4_variant(tx, tp, ts, group, name)
    assert finished.dtype == torch.bfloat16
    assert np.abs(to_numpy(finished) - _jax_finished(name, want, jx, js, group)).max() <= tol


def test_torch_int4_variant_jax_bf16mul_is_mul3d():
    """The two JAX unpacks differ only in the TPU layout of the scale
    broadcast: the same bits, so the port runs both through one kernel."""
    for case in CASES:
        (jx, jp, js), _ = _operands(*case)
        group = case[3]
        assert np.array_equal(_jax_raw("bf16mul", jx, jp, js, group),
                              _jax_raw("mul3d", jx, jp, js, group))


@pytest.mark.parametrize("case", CASES)
def test_torch_int4_variant_f32mul_is_k5_plain(case):
    _, (tx, tp, ts) = _operands(*case)
    group = case[3]
    assert torch.equal(qc.int4_variant_reference(tx, tp, ts, group, "f32mul"),
                       qc.int4_matmul_reference(tx, tp, ts, group))


@pytest.mark.parametrize("case", CASES)
def test_torch_int4_variant_f32dot_matches_jax_production_kernel(case):
    """JAX's int4 kernel keeps the cells in f32 at b <= 64 (its ``f32dot``
    branch): f32 sums in another order, each side rounding once to bf16, so
    one bf16 ulp of each element (2**-7 relatively) over 1e-5 of the scale."""
    (jx, jp, js), (tx, tp, ts) = _operands(*case)
    group = case[3]
    want = np.asarray(jqm.int4_matmul(jx, jp, js, group, interpret=True).astype(jnp.float32))
    got = to_numpy(qc.int4_variant_reference(tx, tp, ts, group, "f32dot"))
    assert np.all(np.abs(got - want) <= np.abs(want) * 2.0 ** -7 + 1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", CASES)
def test_torch_int4_unsigned_correction_matches_jax(case):
    (jx, jp, js), (tx, tp, ts) = _operands(*case)
    group = case[3]
    ns = js.shape[0]
    want = np.asarray(JAX_SCRIPT.unsigned_correction(jx, js[: ns // 2], js[ns // 2:], group))
    got = qc.unsigned_correction(tx, ts, group)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=1e-5 * np.abs(want).max())


def _bf16_bits(bits: np.ndarray) -> torch.Tensor:
    """bf16 values from their 16-bit patterns."""
    return torch.from_numpy(bits.astype(np.int16)).view(torch.bfloat16)


def test_torch_int4_variant_bf16_pair_arithmetic():
    """The kernel's bf16 pair arithmetic gives the plain cells exactly: a
    nibble u under the bf16 exponent of 128 (bits 0x4300 | u) is 128 + u;
    bf16mul takes (128 + u) - 136 = q, exact, then bf(q * bf(s)); ucorr's
    single-rounding fma (128 + u) * bf(s) + (-128 * bf(s)) is bf(u * bf(s));
    ugdot's (128 + u) - 128 is u."""
    u = np.arange(16)
    biased = _bf16_bits(0x4300 | u).float()
    assert torch.equal(biased, torch.arange(16.0) + 128)
    assert float(_bf16_bits(np.array([0x4308]))) == 136.0
    assert float(_bf16_bits(np.array([0x4300]))) == 128.0
    rng = np.random.default_rng(0)
    s = torch.from_numpy(np.abs(rng.normal(size=4096)) * 0.01).to(torch.bfloat16)
    ub = torch.arange(16, dtype=torch.float64)[:, None]
    sd = s.double()[None, :]
    # one rounding of each exact real value to bf16 (exact in f64 and f32)
    fma = ((ub + 128) * sd + (-128.0 * sd)).float().to(torch.bfloat16)
    assert torch.equal(fma, ub.to(torch.bfloat16) * s[None, :])
    q = (biased - 136.0).to(torch.bfloat16)
    assert torch.equal(q.float(), torch.arange(16.0) - 8)
    assert torch.equal((q[:, None].float() * s[None, :].float()).to(torch.bfloat16),
                       q[:, None] * s[None, :])


def test_torch_int4_variant_kernel_source_has_every_arithmetic():
    """The kernel source names the six arithmetic values the wrapper maps
    the seven variants to, with the C entry points the binding declares."""
    src = SOURCE.read_text()
    enum = re.search(r"enum Arith : int \{([^}]*)\}", src).group(1)
    values = dict((k.strip(), int(v)) for k, v in re.findall(r"(k\w+) = (\d+)", enum))
    assert sorted(values.values()) == sorted(set(qc._ARITH.values())) == list(range(6))
    for entry in ("smft_int4_variant_mm", "smft_quant_decode_plan"):
        assert f'extern "C" int' in src and entry + "(" in src
    ops = (SOURCE.parent / "ops.cpp").read_text()
    assert "int4_variant_mm(Tensor x, Tensor packed, Tensor scales, int group, int arith)" in ops


def _jax_main_constants():
    """G, the shapes, the seed and the weight scale in the JAX script's main."""
    tree = ast.parse(JAX_SCRIPT_PATH.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    group = next(n.value.value for n in ast.walk(main) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "G")
    loop = next(n for n in ast.walk(main) if isinstance(n, ast.For))
    shapes = ast.literal_eval(loop.iter)
    text = ast.get_source_segment(JAX_SCRIPT_PATH.read_text(), main)
    seed = int(re.search(r"default_rng\((\d+)\)", text).group(1))
    scale = float(re.search(r"\* ([0-9.]+)\)\.astype\(np\.float32\)", text).group(1))
    return group, tuple(shapes), seed, scale


def test_torch_int4_variant_script_matches_jax_script():
    group, shapes, seed, scale = _jax_main_constants()
    assert (script.G, script.SHAPES, script.SEED, script.WEIGHT_SCALE) == (group, shapes, seed,
                                                                          scale)
    assert script.ORACLE_RTOL == 0.02


def test_torch_int4_variant_script_bounds():
    """Bytes (codes, f32 scales, x and y once) over 3.35 TB/s, or operations
    over 989 TFLOP/s, the larger."""
    want = {(4, 5632, 2048): (1.955, "bytes", 6_549_504),
            (4, 2048, 5632): (1.955, "bytes", 6_549_504),
            (4, 11008, 4096): (7.607, "bytes", 25_483_264),
            (256, 11008, 4096): (23.342, "operations", 33_095_680)}
    for shape, (us, by, nbytes) in want.items():
        ms, bound_by = script.bound_ms(*shape)
        assert bound_by == by and abs(ms * 1e3 - us) < 0.001
        assert script.cost(*shape) == (nbytes, 2 * shape[0] * shape[1] * shape[2])
    assert abs(script.cuda_core_ms(256, 11008, 4096) * 1e3 - 344.56) < 0.01


def test_torch_int4_variant_script_rotates_past_l2():
    """The timed calls rotate over weight sets of more than the 50 MB L2."""
    for _, n_in, n_out in script.SHAPES:
        total = script.weight_sets(n_in, n_out) * script.weight_bytes(n_in, n_out)
        assert total > 50e6 and total >= script.ROTATE_BYTES
    assert script.weight_sets(5632, 2048) == 16 and script.weight_sets(11008, 4096) == 4
