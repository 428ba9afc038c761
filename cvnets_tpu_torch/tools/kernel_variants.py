"""What the variant timers (``time_mha_forward``, ``time_window_backward``)
share: build one CUDA source of several ``csrc`` trees, bind a kernel wrapper
to each build, and time a callable with CUDA events and on the host.

A tree is a directory holding the source and the ``attention_tiles.cuh`` it
includes: a checkout's ``cvnets_tpu_torch/csrc``, such as the parent commit's
unpacked with ``git archive`` into a git-ignored directory.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from cvnets_tpu_torch.ops.cuda_build import BUILD_DIR, NVCC_FLAGS, KernelEntry, _nvcc

LAUNCHES = 20  # launches between two CUDA events


def build(label: str, csrc: str, source: str, out_dir: str) -> tuple:
    """nvcc of ``csrc/source`` with ``-Xptxas -v`` into ``out_dir/label.so``;
    returns (library, ptxas's report). Raises if nvcc fails."""
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"{label}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", lib, os.path.join(csrc, source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: nvcc failed\n{proc.stderr[-4000:]}")
    return lib, proc.stderr


def build_all(trees: dict, source: str, out_dir: str) -> dict:
    """``build`` of every {label: csrc} at once; {label: (library, report) or
    the exception}."""
    def one(item):
        try:
            return build(*item, source, out_dir)
        except RuntimeError as exc:
            return exc

    with ThreadPoolExecutor(len(trees)) as pool:
        return dict(zip(trees, pool.map(one, trees.items())))


def registers(report: str) -> dict:
    """{entry function (mangled): (registers, spill store bytes)} from ptxas -v."""
    out, name, spill = {}, "", 0
    for line in report.splitlines():
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = int(m.group(1))
        elif m := re.search(r"Used (\d+) registers", line):
            out[name] = (int(m.group(1)), spill)
    return out


def bind(lib: str, kernel: KernelEntry) -> KernelEntry:
    """Point ``kernel`` (a fresh wrapper) at the entry point of ``lib``."""
    fn = getattr(ctypes.CDLL(lib), kernel._symbol)
    fn.argtypes = kernel._argtypes
    fn.restype = ctypes.c_int
    kernel._fn = fn
    return kernel


def time_once(fn, launches: int = LAUNCHES) -> float:
    """ms a call: CUDA events around ``launches`` back-to-back calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def host_once(fn, launches: int = LAUNCHES) -> float:
    """ms of the host's time to enqueue a call: a host clock around
    ``launches`` back-to-back calls that nothing synchronises. Where it nears
    ``time_once``, the host's launch, not the kernel, sets the pace."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(launches):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / launches
    torch.cuda.synchronize()
    return ms


def build_dir(tool: str) -> str:
    """The git-ignored directory a timer builds into."""
    return os.path.join(os.path.dirname(BUILD_DIR), tool)
