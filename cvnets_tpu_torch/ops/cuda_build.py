"""Build a CUDA source of ``cvnets_tpu_torch/csrc`` into a shared library with a
plain C interface and load it with ``ctypes``.

``nvcc`` compiles for ``sm_90a`` (Hopper) at first use, into
``<repo>/build/cvnets_tpu_torch/``; a library newer than its source and the
shared headers (``csrc/*.cuh``) is reused. A source that calls a CUDA library
names it in ``LINK_FLAGS`` (nvJPEG for ``jpeg_decode.cu``).
Nothing here runs at import time, so the package imports on machines without
CUDA. ``KernelEntry`` binds one C entry point of such a library; every kernel
wrapper of the port launches through one.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from typing import Sequence

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "cvnets_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
# the libraries a source links beyond the CUDA runtime, found at run time
# through the toolkit's library directory
LINK_FLAGS = {"jpeg_decode.cu": ["-lnvjpeg"]}


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
    # the source or any shared header of csrc/ newer than the library: rebuild
    newest = max(os.path.getmtime(os.path.join(CSRC_DIR, f)) for f in os.listdir(CSRC_DIR)
                 if f == source or f.endswith(".cuh"))
    if os.path.isfile(lib) and os.path.getmtime(lib) >= newest:
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    if source in LINK_FLAGS:
        lib_dir = os.path.join(os.path.dirname(os.path.dirname(cmd[0])), "lib64")
        cmd += [*LINK_FLAGS[source], f"-L{lib_dir}", f"-Xlinker=-rpath={lib_dir}"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


def load_library(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(build_library(source))


class KernelEntry:
    """One entry point ``symbol`` of the library built from ``csrc/<source>``,
    bound with ctypes (``argtypes`` for every argument but the trailing CUDA
    stream). The library is built at the first launch, or by ``load``;
    ``launch`` passes the current stream of ``device``, raises on a nonzero
    cudaError the entry point returns, and counts the launch in ``launches``."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence) -> None:
        self.launches = 0
        self._source = source
        self._symbol = symbol
        self._argtypes = list(argtypes) + [ctypes.c_void_p]
        self._fn = None

    def load(self) -> None:
        if self._fn is None:
            fn = getattr(load_library(self._source), self._symbol)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            self._fn = fn

    def launch(self, device: torch.device, *args) -> None:
        self.load()
        with torch.cuda.device(device):
            err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self._symbol} launch failed: cudaError {err}")
        self.launches += 1
