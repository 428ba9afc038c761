"""Build and time the bf16 MHA forward of several source trees in one process.

    python3 -m cvnets_tpu_torch.tools.time_mha_forward [LABEL=CSRC_DIR ...]

Each CSRC_DIR holds a ``mha_attention.cu`` and the ``attention_tiles.cuh`` it
includes: a checkout's ``cvnets_tpu_torch/csrc``, such as the parent commit's
unpacked with ``git archive`` into a git-ignored directory. Without arguments
it takes this tree's. Every tree is built with nvcc at once (``-Xptxas -v``,
for the registers) into ``build/time_mha_forward/LABEL.so`` and bound as
``ops/mha_attention.py``'s ``MHAForwardKernel`` is. At ViT-B/16's shapes at
224² (B 128, S 197) and at 512² without the CLS token (B 32, S 1024), H 12,
D 64, bf16, no mask, q, k, v column slices of one qkv tensor, each build's
output and statistics are checked against the plain versions; then the builds
and SDPA's cuDNN and flash backends are timed in alternating rounds (CUDA
events around 20 launches a sample, the median of all samples). One line a
shape and build: ms a call, TFLOP/s, the ratio to each backend; then each
build's registers and spills by forward kernel and head dim. ptxas's notes
that it serialized a forward's wgmma products are printed as the builds end.
"""

from __future__ import annotations

import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from cvnets_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC_DIR, NVCC_FLAGS, _nvcc
from cvnets_tpu_torch.ops.mha_attention import (
    MHAForwardKernel,
    mha_attention_plain,
    mha_attention_stats_plain,
)

SHAPES = [(128, 197, 12, 64), (32, 1024, 12, 64)]  # (B, S, H, D)
ROUNDS, LAUNCHES, SAMPLES = 5, 20, 3
OUT_DIR = os.path.join(os.path.dirname(BUILD_DIR), "time_mha_forward")


def build(label: str, csrc: str) -> tuple:
    """nvcc of ``csrc/mha_attention.cu``; returns (library, {"kernel D": "regs (spill)"})."""
    os.makedirs(OUT_DIR, exist_ok=True)
    lib = os.path.join(OUT_DIR, f"{label}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", lib,
           os.path.join(csrc, "mha_attention.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: nvcc failed\n{proc.stderr[-4000:]}")
    regs, name, spill = {}, "", ""
    for line in proc.stderr.splitlines():
        if "Performance Loss" in line and "mha_fwd_" in line:  # ptxas serialized wgmma
            print(f"{label}: {line.strip()[:300]}", flush=True)
        if m := re.search(r"Compiling entry function '(\S+)'", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores", line):
            spill = m.group(1)
        elif (m := re.search(r"Used (\d+) registers", line)) and "mha_fwd_" in name:
            kind = "wgmma" if "wgmma" in name else ("f32" if "f32" in name else "mma")
            d = re.search(r"ILi(\d+)E", name)
            regs[f"{kind} D{d.group(1) if d else '?'}"] = f"{m.group(1)} ({spill} spilled)"
    return lib, regs


def bind(lib: str) -> MHAForwardKernel:
    import ctypes

    kernel = MHAForwardKernel()
    fn = ctypes.CDLL(lib).mha_attention_forward
    fn.argtypes = kernel._argtypes
    fn.restype = ctypes.c_int
    kernel._fn = fn
    return kernel


def time_once(fn) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / LAUNCHES


def main(argv) -> int:
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if not torch.cuda.is_available():
        print("time_mha_forward: no CUDA device", file=sys.stderr)
        return 2
    trees = dict(a.split("=", 1) for a in argv) or {"this": CSRC_DIR}
    with ThreadPoolExecutor(len(trees)) as pool:
        built = dict(zip(trees, pool.map(lambda kv: build(*kv), trees.items())))
    kernels = {label: bind(lib) for label, (lib, _) in built.items()}
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(0)
    for b, s, h, d in SHAPES:
        qkv = torch.randn((b, s, 3 * h * d), generator=g, device="cuda").to(torch.bfloat16)
        q, k, v = qkv.chunk(3, dim=-1)
        q = q * d ** -0.5
        ref = mha_attention_plain(q, k, v, h).float()
        ref_stats = mha_attention_stats_plain(q, k, v, h)
        fns = {}
        for label, kernel in kernels.items():
            out, stats = kernel(q, k, v, h)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            serr = ((stats - ref_stats).abs() / ref_stats.abs().clamp(min=1)).max().item()
            # bf16 output rounding and P rounded to bf16; statistics in float32
            if not (err <= 2e-2 * ref.abs().max().item() and serr <= 1e-2):
                raise RuntimeError(f"{label} B={b} S={s}: out err {err}, stats err {serr}")
            fns[label] = lambda kernel=kernel: kernel(q, k, v, h)
        qh, kh, vh = (t.reshape(b, s, h, d).transpose(1, 2).contiguous() for t in (q, k, v))
        for backend in ("CUDNN_ATTENTION", "FLASH_ATTENTION"):
            def sdpa(backend=backend):
                with sdpa_kernel([getattr(SDPBackend, backend)]):
                    F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
            fns[backend] = sdpa
        times = {name: [] for name in fns}
        for name, fn in fns.items():  # warm up
            for _ in range(3):
                fn()
        for _ in range(ROUNDS):
            for name, fn in fns.items():
                times[name] += [time_once(fn) for _ in range(SAMPLES)]
        ms = {name: statistics.median(t) for name, t in times.items()}
        flops = 4 * b * h * s * s * d
        for name in fns:
            print(f"fwd B={b} S={s} H={h} D={d} [{name}] ms={ms[name]:.4f} "
                  f"tflops={flops / ms[name] / 1e9:.1f} "
                  f"/cudnn={ms[name] / ms['CUDNN_ATTENTION']:.3f} "
                  f"/flash={ms[name] / ms['FLASH_ATTENTION']:.3f} | {card}", flush=True)
    for label, (_, regs) in built.items():
        print(f"registers [{label}] " + " ".join(f"{k_}={v_}" for k_, v_ in sorted(regs.items())))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
