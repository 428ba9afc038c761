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

import re
import statistics
import sys

import torch

from cvnets_tpu_torch.ops.cuda_build import CSRC_DIR
from cvnets_tpu_torch.ops.mha_attention import (
    MHAForwardKernel,
    mha_attention_plain,
    mha_attention_stats_plain,
)
from cvnets_tpu_torch.tools.kernel_variants import (
    bind,
    build_all,
    build_dir,
    registers,
    time_once,
)

SHAPES = [(128, 197, 12, 64), (32, 1024, 12, 64)]  # (B, S, H, D)
ROUNDS, SAMPLES = 5, 3
OUT_DIR = build_dir("time_mha_forward")


def forward_registers(label: str, report: str) -> dict:
    """{"kernel D": "regs (spill)"} of the forward kernels; prints ptxas's notes
    that it serialized a forward's wgmma products."""
    for line in report.splitlines():
        if "Performance Loss" in line and "mha_fwd_" in line:
            print(f"{label}: {line.strip()[:300]}", flush=True)
    regs = {}
    for name, (n, spill) in registers(report).items():
        if "mha_fwd_" in name:
            kind = "wgmma" if "wgmma" in name else ("f32" if "f32" in name else "mma")
            d = re.search(r"ILi(\d+)E", name)
            regs[f"{kind} D{d.group(1) if d else '?'}"] = f"{n} ({spill} spilled)"
    return regs


def main(argv) -> int:
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if not torch.cuda.is_available():
        print("time_mha_forward: no CUDA device", file=sys.stderr)
        return 2
    trees = dict(a.split("=", 1) for a in argv) or {"this": CSRC_DIR}
    built = build_all(trees, "mha_attention.cu", OUT_DIR)
    for result in built.values():
        if isinstance(result, Exception):
            raise result
    built = {label: (lib, forward_registers(label, report))
             for label, (lib, report) in built.items()}
    kernels = {label: bind(lib, MHAForwardKernel()) for label, (lib, _) in built.items()}
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
