"""Build the port's CUDA kernels from the sources in ``kernels/csrc/``.

The build runs at the first call that needs a kernel, never at import: the
package imports on machines with no CUDA toolkit.  It takes one route:

  * ``nvcc -gencode=arch=compute_90a,code=sm_90a -O3 -std=c++17`` compiles
    the ``.cu`` sources, which include no PyTorch header and take seconds;
  * the host C++ compiler compiles the ``.cpp`` binding against PyTorch's
    headers (``TORCH_LIBRARY``), in parallel with nvcc;
  * nvcc links both into one shared library, which
    ``torch.ops.load_library`` loads.

The library goes into ``kernels/_build/<key>/``, which ``.gitignore``
lists, with the compilers' output beside it (``build.log``: ptxas's
registers and spills of every kernel).  The key hashes the sources, the compile commands, the PyTorch and
CUDA versions and the arch, so a stale library is never reused.  A failed
build raises with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
GENCODE = "-gencode=arch=compute_90a,code=sm_90a"
LIB_NAME = "libsmft_kernels.so"
LOG_NAME = "build.log"  # the compilers' output (ptxas's registers and spills), beside the library


def _cuda_home() -> Path:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return Path(home)
    nvcc = shutil.which("nvcc")
    if nvcc:
        return Path(nvcc).resolve().parent.parent
    return Path("/usr/local/cuda")


def _sources() -> tuple[list[Path], list[Path]]:
    cu = sorted(CSRC.glob("*.cu"))
    cpp = sorted(CSRC.glob("*.cpp"))
    return cu, cpp


def _commands(out_dir: Path) -> tuple[list[list[str]], list[str], list[Path]]:
    """(compile commands, link command, object files)."""
    cuda = _cuda_home()
    nvcc = str(cuda / "bin" / "nvcc")
    torch_dir = Path(torch.__file__).resolve().parent
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    cu, cpp = _sources()
    compiles, objs = [], []
    for src in cu:
        obj = out_dir / (src.stem + ".cu.o")
        compiles.append([
            nvcc, GENCODE, "-O3", "-std=c++17",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", str(src), "-o", str(obj)])
        objs.append(obj)
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++") or "c++"
    for src in cpp:
        obj = out_dir / (src.stem + ".o")
        compiles.append([
            cxx, "-O2", "-std=c++17", "-fPIC", f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
            "-I", str(torch_dir / "include"),
            "-I", str(torch_dir / "include" / "torch" / "csrc" / "api" / "include"),
            "-I", str(cuda / "include"), "-c", str(src), "-o", str(obj)])
        objs.append(obj)
    lib = torch_dir / "lib"
    link = [nvcc, "-shared", GENCODE,
            *map(str, objs), "-o", str(out_dir / LIB_NAME),
            "-L", str(lib), "-lc10", "-lc10_cuda", "-ltorch_cpu", "-ltorch",
            "-Xlinker", f"-rpath={lib}"]
    return compiles, link, objs


def build_key() -> str:
    """Hash of everything the library depends on: the sources, the commands
    (with the arch) and the PyTorch and CUDA versions."""
    h = hashlib.sha256()
    cu, cpp = _sources()
    for src in cu + cpp + sorted(CSRC.glob("*.cuh")) + sorted(CSRC.glob("*.h")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    compiles, link, _ = _commands(Path("."))
    h.update(repr((compiles, link)).replace(str(CSRC), "csrc").encode())
    h.update(torch.__version__.encode())
    h.update(str(torch.version.cuda).encode())
    return h.hexdigest()[:16]


def _run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}")
    return proc.stdout


def build(verbose: bool = False) -> Path:
    """Build the kernel library if it is not built yet; return its path."""
    out_dir = BUILD_ROOT / build_key()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    # Build into a private directory and rename it into place, so that a
    # process that finds the directory finds a whole library.
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        compiles, link, _ = _commands(tmp)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in compiles]
        logs = []
        for cmd, proc in zip(compiles, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                for other in procs:
                    if other.poll() is None:
                        other.kill()
                        other.wait()
                raise RuntimeError(f"kernel build failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{out}")
            logs.append(out)
        logs.append(_run(link))
        (tmp / LOG_NAME).write_text("".join(logs))
        if verbose:
            print(f"built {LIB_NAME} in {time.perf_counter() - t0:.1f} s", flush=True)
            print("".join(logs), flush=True)
        try:
            tmp.rename(out_dir)
        except OSError:
            if not lib.exists():  # not a concurrent build that got there first
                raise
    finally:
        if tmp.exists():
            shutil.rmtree(tmp, ignore_errors=True)
    return lib
