"""Build a CUDA source of ``cvnets_tpu_torch/csrc`` into a shared library with a
plain C interface and load it with ``ctypes``.

``nvcc`` compiles for ``sm_90a`` (Hopper) at first use, into
``<repo>/build/cvnets_tpu_torch/``; a library newer than its source is reused.
Nothing here runs at import time, so the package imports on machines without
CUDA.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "cvnets_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found under {cuda_home}/bin or on PATH")
    return found


def build_library(source: str) -> str:
    """Compile ``csrc/<source>`` (if stale) and return the library's path."""
    src = os.path.join(CSRC_DIR, source)
    lib = os.path.join(BUILD_DIR, os.path.splitext(source)[0] + ".so")
    if os.path.isfile(lib) and os.path.getmtime(lib) >= os.path.getmtime(src):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def load_library(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(build_library(source))
