"""Import hygiene of the PyTorch port: importing it pulls in no JAX, Flax,
Triton, transformers, safetensors, tokenizers, regex, sentencepiece or
JAX-package module and builds no kernel; its CUDA
kernels refuse CPU tensors instead of computing on them; and the build key
follows the kernel sources."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
MODULES = [
    "sparse_matrix_fine_tuning_torch",
    "sparse_matrix_fine_tuning_torch.ops.monarch",
    "sparse_matrix_fine_tuning_torch.ops.blockdiag",
    "sparse_matrix_fine_tuning_torch.ops.activations",
    "sparse_matrix_fine_tuning_torch.ops.losses",
    "sparse_matrix_fine_tuning_torch.ops.attention",
    "sparse_matrix_fine_tuning_torch.ops.projection",
    "sparse_matrix_fine_tuning_torch.kernels.build",
    "sparse_matrix_fine_tuning_torch.kernels.monarch_cuda",
    "sparse_matrix_fine_tuning_torch.kernels.quant_cuda",
    "sparse_matrix_fine_tuning_torch.kernels.merged",
    "sparse_matrix_fine_tuning_torch.kernels.attention_cuda",
    "sparse_matrix_fine_tuning_torch.kernels.experimental",
    "sparse_matrix_fine_tuning_torch.kernels.experimental.more_linear",
    "sparse_matrix_fine_tuning_torch.kernels.experimental.tiled_matmul",
    "sparse_matrix_fine_tuning_torch.scripts",
    "sparse_matrix_fine_tuning_torch.scripts.bench_more_linear",
    "sparse_matrix_fine_tuning_torch.scripts.bench_attention",
    "sparse_matrix_fine_tuning_torch.scripts.exp_matmul_tiles",
    "sparse_matrix_fine_tuning_torch.scripts.exp_fwd_tile",
    "sparse_matrix_fine_tuning_torch.scripts.exp_dw_kernel",
    "sparse_matrix_fine_tuning_torch.scripts.exp_merged_v3",
    "sparse_matrix_fine_tuning_torch.scripts.exp_int4_dequant_variants",
    "sparse_matrix_fine_tuning_torch.scripts.probe_profiler_window",
    "sparse_matrix_fine_tuning_torch.scripts.run_alpaca",
    "sparse_matrix_fine_tuning_torch.scripts.run_reasoning",
    "sparse_matrix_fine_tuning_torch.scripts.run_glue",
    "sparse_matrix_fine_tuning_torch.scripts.run_agnews",
    "sparse_matrix_fine_tuning_torch.evaluation",
    "sparse_matrix_fine_tuning_torch.evaluation.reasoning",
    "sparse_matrix_fine_tuning_torch.evaluation.predict",
    "sparse_matrix_fine_tuning_torch.data",
    "sparse_matrix_fine_tuning_torch.data.templates",
    "sparse_matrix_fine_tuning_torch.data.reasoning",
    "sparse_matrix_fine_tuning_torch.data.tokenizer",
    "sparse_matrix_fine_tuning_torch.data.alpaca",
    "sparse_matrix_fine_tuning_torch.data.mmlu",
    "sparse_matrix_fine_tuning_torch.data.glue",
    "sparse_matrix_fine_tuning_torch.layers",
    "sparse_matrix_fine_tuning_torch.layers.monarch_linear",
    "sparse_matrix_fine_tuning_torch.layers.structured",
    "sparse_matrix_fine_tuning_torch.layers.blocksparse",
    "sparse_matrix_fine_tuning_torch.layers.spectral",
    "sparse_matrix_fine_tuning_torch.ops",
    "sparse_matrix_fine_tuning_torch.ops.butterfly",
    "sparse_matrix_fine_tuning_torch.models.config",
    "sparse_matrix_fine_tuning_torch.models.llama",
    "sparse_matrix_fine_tuning_torch.models.roberta",
    "sparse_matrix_fine_tuning_torch.models.deberta",
    "sparse_matrix_fine_tuning_torch.models",
    "sparse_matrix_fine_tuning_torch.models.gpt2",
    "sparse_matrix_fine_tuning_torch.models.gpt_neo",
    "sparse_matrix_fine_tuning_torch.models.gpt_neox",
    "sparse_matrix_fine_tuning_torch.models.blip",
    "sparse_matrix_fine_tuning_torch.models.backpack_gpt2",
    "sparse_matrix_fine_tuning_torch.models.generate",
    "sparse_matrix_fine_tuning_torch.models.hf_convert",
    "sparse_matrix_fine_tuning_torch.peft.surgery",
    "sparse_matrix_fine_tuning_torch.peft.boft",
    "sparse_matrix_fine_tuning_torch.peft.import_reference",
    "sparse_matrix_fine_tuning_torch.interventions",
    "sparse_matrix_fine_tuning_torch.interventions.reft",
    "sparse_matrix_fine_tuning_torch.interventions.pyvene_io",
    "sparse_matrix_fine_tuning_torch.interventions.das",
    "sparse_matrix_fine_tuning_torch.interventions.causal_model",
    "sparse_matrix_fine_tuning_torch.models.toy",
    "sparse_matrix_fine_tuning_torch.scripts.das_demo",
    "sparse_matrix_fine_tuning_torch.quant",
    "sparse_matrix_fine_tuning_torch.utils.testing",
    "sparse_matrix_fine_tuning_torch.utils.jax_bridge",
    "sparse_matrix_fine_tuning_torch.utils.device",
    "sparse_matrix_fine_tuning_torch.utils.benchlib",
    "sparse_matrix_fine_tuning_torch.utils.config",
    "sparse_matrix_fine_tuning_torch.utils.metrics",
    "sparse_matrix_fine_tuning_torch.utils.logging",
    "sparse_matrix_fine_tuning_torch.utils.profiling",
    "sparse_matrix_fine_tuning_torch.training.optim",
    "sparse_matrix_fine_tuning_torch.training.adam8bit",
    "sparse_matrix_fine_tuning_torch.training.checkpoint",
    "sparse_matrix_fine_tuning_torch.training.trainer",
    "sparse_matrix_fine_tuning_torch.training.hpo",
]
FORBIDDEN = ("jax", "flax", "triton", "transformers", "safetensors", "tokenizers", "regex",
             "sentencepiece", "sparse_matrix_fine_tuning_tpu")

_PROBE = """
import importlib, json, subprocess, sys
calls = []
real_popen = subprocess.Popen
def spy(*a, **k):
    calls.append(a)
    return real_popen(*a, **k)
subprocess.Popen = spy
for name in {modules!r}:
    importlib.import_module(name)
from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda
print(json.dumps({{"loaded": sorted(sys.modules), "popen": len(calls),
                  "ops": monarch_cuda._ops is not None}}))
"""


def test_torch_package_imports_no_jax_and_builds_nothing():
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(modules=MODULES)], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    bad = [m for m in report["loaded"] if m.split(".")[0] in FORBIDDEN]
    assert bad == []
    assert report["popen"] == 0 and report["ops"] is False


def test_torch_models_export_the_jax_names():
    """``models.__all__`` is the JAX package's, BLIP's five names among them."""
    import sparse_matrix_fine_tuning_torch.models as port_models
    import sparse_matrix_fine_tuning_tpu.models as jax_models

    assert sorted(port_models.__all__) == sorted(jax_models.__all__)
    assert all(hasattr(port_models, name) for name in port_models.__all__)


def test_torch_cuda_kernels_refuse_cpu_tensors():
    from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda
    from sparse_matrix_fine_tuning_torch.kernels.experimental import more_linear as ml
    from sparse_matrix_fine_tuning_torch.kernels.experimental import tiled_matmul as tm

    x, w1, w2 = torch.randn(4, 16), torch.randn(4, 2, 4), torch.randn(2, 8, 4)
    before, ml_before = dict(monarch_cuda.LAUNCHES), dict(ml.LAUNCHES)
    tm_before = dict(tm.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        monarch_cuda.monarch_fwd_tile(x, w1, w2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tm.tiled_matmul(torch.randn(4, 16).bfloat16(), torch.randn(16, 8).bfloat16())
    with pytest.raises(ValueError, match="CUDA"):
        monarch_cuda.monarch_kernel(x, w1, w2)
    with pytest.raises(ValueError, match="CUDA"):
        monarch_cuda.monarch_add(torch.randn(4, 16), x, w1, w2)
    with pytest.raises(ValueError, match="CUDA"):
        monarch_cuda.monarch_bwd(x, w1, w2, torch.randn(4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        monarch_cuda.monarch_dw_fused(x, torch.randn(4, 16), w1, w2)
    with pytest.raises(ValueError, match="CUDA"):
        monarch_cuda.monarch_dw_tile(x, torch.randn(4, 16), w1, w2, 256)
    with pytest.raises(ValueError, match="CUDA"):
        monarch_cuda.monarch_dw_merged(x, torch.randn(4, 16), w1, w2)
    wd, dout = torch.randn(16, 16), torch.randn(4, 16)
    for call in (lambda: ml.more_linear_fwd(x, wd, w1, w2),
                 lambda: ml.more_linear_dx(dout, wd, w1, w2),
                 lambda: ml.more_linear_dw(x, dout, w1, w2)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert monarch_cuda.LAUNCHES == before and ml.LAUNCHES == ml_before
    assert tm.LAUNCHES == tm_before and monarch_cuda._ops is None


def test_torch_quant_kernels_refuse_cpu_tensors():
    """K5-K8's and K16's wrappers raise on CPU tensors and launch nothing
    (K16's also on x that is not bf16 and on an unknown variant, before any
    build); the device dispatch sends a CPU tensor to the plain version."""
    from sparse_matrix_fine_tuning_torch import quant
    from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda, quant_cuda

    w = torch.randn(32, 64)
    q8, s8 = (torch.from_numpy(a) for a in quant.quantize_int8(w))
    p4, s4 = (torch.from_numpy(a) for a in quant.quantize_int4(w, 16))
    x, dy = torch.randn(4, 64), torch.randn(4, 32)
    before = dict(quant_cuda.LAUNCHES)
    for call in (lambda: quant_cuda.int8_matmul(x, q8, s8),
                 lambda: quant_cuda.int8_matmul_dx(dy, q8, s8),
                 lambda: quant_cuda.int4_matmul(x, p4, s4, 16),
                 lambda: quant_cuda.int4_matmul_dx(dy, p4, s4, 16),
                 lambda: quant_cuda.int4_variant_matmul(x.bfloat16(), p4, s4, 16, "ugdot")):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="bfloat16"):
        quant_cuda.int4_variant_matmul(x, p4, s4, 16, "f32mul")
    for variant in ("lut", "F32MUL", ""):
        with pytest.raises(ValueError, match="unknown int4 variant"):
            quant_cuda.int4_variant_matmul(x.bfloat16(), p4, s4, 16, variant)
    assert quant_cuda.LAUNCHES == before and monarch_cuda._ops is None
    torch.testing.assert_close(quant_cuda.int8_mm(x, q8, s8),
                               quant_cuda.int8_matmul_reference(x, q8, s8), rtol=0, atol=0)
    torch.testing.assert_close(quant_cuda.int4_mm(x, p4, s4, 16),
                               quant_cuda.int4_matmul_reference(x, p4, s4, 16), rtol=0, atol=0)
    xb = x.bfloat16()
    torch.testing.assert_close(quant_cuda.int4_variant(xb, p4, s4, 16, "bf16mul"),
                               quant_cuda.int4_variant_reference(xb, p4, s4, 16, "bf16mul"),
                               rtol=0, atol=0)


def test_torch_entry_points_default_to_the_card():
    """With no device the entry points build on ``cuda``; where there is no
    card that fails, and nothing falls back to the CPU."""
    from sparse_matrix_fine_tuning_torch.layers.monarch_linear import MonarchLinear
    from sparse_matrix_fine_tuning_torch.models.config import LlamaConfig
    from sparse_matrix_fine_tuning_torch.models.llama import LlamaForCausalLM, init_caches
    from sparse_matrix_fine_tuning_torch.utils.device import resolve_device

    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    constructors = [lambda: LlamaForCausalLM(LlamaConfig.tiny()),
                lambda: MonarchLinear(16, 8, as_adapter=False),
                lambda: init_caches(LlamaConfig.tiny(), 1, 4)]
    for build_one in constructors:
        if torch.cuda.is_available():
            out = build_one()
            first = out[0][0] if isinstance(out, list) else next(out.parameters())
            assert first.is_cuda
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                build_one()
    assert next(LlamaForCausalLM(LlamaConfig.tiny(), device="cpu").parameters()).device.type \
        == "cpu"


def test_torch_build_key_follows_sources(tmp_path, monkeypatch):
    from sparse_matrix_fine_tuning_torch.kernels import build

    key = build.build_key()
    assert key == build.build_key() and len(key) == 16
    compiles, link, _ = build._commands(tmp_path)
    nvcc = [c for c in compiles if c[0].endswith("nvcc")]
    assert nvcc and all("-gencode=arch=compute_90a,code=sm_90a" in c for c in nvcc)
    assert all("-std=c++17" in c for c in compiles)
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    assert build.build_key() == key
    for name in ("monarch_fwd.cu", "monarch_bwd.cu", "quant_matmul.cu", "more_linear.cu",
                 "tiled_matmul.cu", "quant_wgmma.cu", "flash_attention.cu", "hopper.cuh"):
        src = csrc / name
        src.write_text(src.read_text() + "\n// edited\n")
        edited = build.build_key()
        assert edited != key
        key = edited
