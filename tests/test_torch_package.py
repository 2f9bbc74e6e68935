"""Import hygiene of the PyTorch port: importing it pulls in no JAX, Flax,
Triton, transformers or JAX-package module and builds no kernel; its CUDA
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
    "sparse_matrix_fine_tuning_torch.kernels.build",
    "sparse_matrix_fine_tuning_torch.kernels.monarch_cuda",
    "sparse_matrix_fine_tuning_torch.kernels.merged",
    "sparse_matrix_fine_tuning_torch.layers.monarch_linear",
    "sparse_matrix_fine_tuning_torch.models.config",
    "sparse_matrix_fine_tuning_torch.models.llama",
    "sparse_matrix_fine_tuning_torch.models.generate",
    "sparse_matrix_fine_tuning_torch.peft.surgery",
    "sparse_matrix_fine_tuning_torch.utils.testing",
    "sparse_matrix_fine_tuning_torch.utils.jax_bridge",
    "sparse_matrix_fine_tuning_torch.utils.device",
    "sparse_matrix_fine_tuning_torch.training.optim",
    "sparse_matrix_fine_tuning_torch.training.checkpoint",
    "sparse_matrix_fine_tuning_torch.training.trainer",
]
FORBIDDEN = ("jax", "flax", "triton", "transformers", "sparse_matrix_fine_tuning_tpu")

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


def test_torch_cuda_kernels_refuse_cpu_tensors():
    from sparse_matrix_fine_tuning_torch.kernels import monarch_cuda

    x, w1, w2 = torch.randn(4, 16), torch.randn(4, 2, 4), torch.randn(2, 8, 4)
    before = dict(monarch_cuda.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        monarch_cuda.monarch_kernel(x, w1, w2)
    with pytest.raises(ValueError, match="CUDA"):
        monarch_cuda.monarch_add(torch.randn(4, 16), x, w1, w2)
    with pytest.raises(ValueError, match="CUDA"):
        monarch_cuda.monarch_bwd(x, w1, w2, torch.randn(4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        monarch_cuda.monarch_dw_fused(x, torch.randn(4, 16), w1, w2)
    assert monarch_cuda.LAUNCHES == before and monarch_cuda._ops is None


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
    for name in ("monarch_fwd.cu", "monarch_bwd.cu"):
        src = csrc / name
        src.write_text(src.read_text() + "\n// edited\n")
        edited = build.build_key()
        assert edited != key
        key = edited
