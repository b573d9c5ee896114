"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` exposes a plain C interface. At first use it is
compiled by nvcc for sm_90a into `cmcd_tpu_torch/_build/`, under a name keyed
on a hash of the source, the shared headers (`csrc/*.cuh`) and the flags,
and loaded with ctypes. Nothing is
built when a module is imported, so the CPU-only test runs never need nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels build only where the CUDA "
            "toolkit is installed (set CUDA_HOME)"
        )
    return nvcc


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its keyed library exists; returns the
    library's path. nvcc's output (ptxas register and shared-memory report
    included) is kept beside it as <library>.log."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    so = os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    with open(so[:-3] + ".log", "w") as f:
        f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; one handle per process."""
    return ctypes.CDLL(build(name))
