"""Build and time the bf16 window-attention backward, or with ``--forward`` the
forward, of several source trees in one process.

    python3 -m cvnets_tpu_torch.tools.time_window_backward [--forward] [LABEL=CSRC_DIR ...]

Run from the repository root (it takes Swin-T's stage table, inputs, bounds and
SDPA yardstick from ``chip_smoke.py``). Each CSRC_DIR holds a
``window_attention.cu`` and the ``attention_tiles.cuh`` it includes: a
checkout's ``cvnets_tpu_torch/csrc``, such as the parent commit's unpacked with
``git archive`` into a git-ignored directory. Without arguments it takes this
tree's. Every tree is built with nvcc at once (``-Xptxas -v``) into
``build/time_window_backward/LABEL.so`` and bound as the
``WindowBackwardKernel`` (``WindowForwardKernel``) of the checkout's
``ops/window_attention.py`` beside CSRC_DIR (so each build launches with its
own wrapper's chunk of images), or of this tree where there is none.
At Swin-T's four stage shapes at batch 128 (S 49, D 32), with the stage's
shift mask and without, each build's dq, dk, dv and dbias (the output) are
checked against ``window_attention_backward_plain`` (``window_attention_plain``)
at 2e-2 of max |ref|, as ``chip_smoke.py``'s bf16 bound, and dbias (the
output) for the same bits on a second call; then the builds and SDPA's
backward (forward) with the bias as a float mask are timed in alternating
rounds (CUDA events around 20 launches a sample, the median of all samples).
One line a case and build: ms a call, ÷ the bound, ÷ SDPA, and the host's
time to enqueue a call (``host_ms``: where it nears ms, the host's launch sets
the pace, not the kernel); then each build's
Swin-T step sum (each case times its blocks a step, as
``chip_smoke.SWIN_STAGES`` weights them) and ptxas's registers, spills and the
blocks an SM the registers allow, by head dim. A tree that fails to build or
to match is named and left out, and the exit code is then 1.
"""

from __future__ import annotations

import importlib.util
import os
import re
import statistics
import sys

import torch

from chip_smoke import SWIN_STAGES, window_bounds, window_inputs, window_sdpa
from cvnets_tpu_torch.ops.cuda_build import CSRC_DIR
from cvnets_tpu_torch.ops.window_attention import (
    WindowBackwardKernel,
    WindowForwardKernel,
    window_attention_backward_plain,
    window_attention_plain,
)
from cvnets_tpu_torch.tools.kernel_variants import (
    bind,
    build_all,
    build_dir,
    host_once,
    registers,
    time_once,
)

ROUNDS, SAMPLES = 5, 3
OUT_DIR = build_dir("time_window_backward")
SDPA = "sdpa"


def kernel_registers(report: str, kernel: str) -> str:
    """"D16=regs/spill/blocks ..." of the bf16 ``kernel`` (``win_fwd_bf16`` or
    ``win_bwd_bf16``) instances; blocks an SM as the registers allow (65,536 a
    SM, allocated 256 a warp, 4 warps a block), before shared memory."""
    out = []
    for name, (n, spill) in sorted(registers(report).items()):
        if kernel in name:
            d = re.search(r"ILi(\d+)E", name)
            per_warp = -(-n * 32 // 256) * 256
            out.append(f"D{d.group(1) if d else '?'}={n} regs/{spill} B spilled/"
                       f"{65536 // (4 * per_warp)} blocks")
    return " ".join(out)


def wrapper(label: str, csrc: str, forward: bool):
    """A fresh ``WindowForwardKernel`` or ``WindowBackwardKernel`` of the
    checkout that holds ``csrc``."""
    name = "WindowForwardKernel" if forward else "WindowBackwardKernel"
    path = os.path.join(os.path.dirname(os.path.abspath(csrc)), "ops", "window_attention.py")
    if not os.path.isfile(path):
        return (WindowForwardKernel if forward else WindowBackwardKernel)()
    spec = importlib.util.spec_from_file_location(f"window_attention_{label}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return getattr(module, name)()


def check_forward(label: str, kernel, inputs: tuple, h: int) -> None:
    q, k, v, bias, mask, _ = inputs
    out = kernel(q, k, v, h, bias, mask)
    again = kernel(q, k, v, h, bias, mask)
    torch.cuda.synchronize()
    ref = window_attention_plain(q, k, v, h, bias, mask)
    err = (out.float() - ref.float()).abs().max().item()
    tol = 2e-2 * ref.float().abs().max().item()  # P rounded to bf16, the output too
    if not (bool(torch.isfinite(out).all()) and err <= tol):
        raise RuntimeError(f"{label}: out err {err} > {tol}")
    if not torch.equal(out, again):
        raise RuntimeError(f"{label}: the output differs between two calls")


def check_backward(label: str, kernel, inputs: tuple, h: int) -> None:
    q, k, v, bias, mask, dout = inputs
    got = kernel(q, k, v, h, bias, mask, dout)
    again = kernel(q, k, v, h, bias, mask, dout)[3]
    torch.cuda.synchronize()
    ref = window_attention_plain(q, k, v, h, bias, mask)
    want = window_attention_backward_plain(q, k, v, h, bias, mask, ref, dout)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        err = (a.float() - b.float()).abs().max().item()
        tol = 2e-2 * b.float().abs().max().item()  # P and dS rounded to bf16, outputs too
        if not (bool(torch.isfinite(a).all()) and err <= tol):
            raise RuntimeError(f"{label}: {name} err {err} > {tol}")
    if not torch.equal(got[3], again):
        raise RuntimeError(f"{label}: dbias differs between two calls")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("time_window_backward: no CUDA device", file=sys.stderr)
        return 2
    forward = "--forward" in argv
    direction = "fwd" if forward else "bwd"
    check = check_forward if forward else check_backward
    trees = dict(a.split("=", 1) for a in argv if a != "--forward") or {"this": CSRC_DIR}
    failed = False
    kernels, regs = {}, {}
    for label, result in build_all(trees, "window_attention.cu", OUT_DIR).items():
        if isinstance(result, Exception):
            print(f"FAILED {result}", flush=True)
            failed = True
            continue
        kernels[label] = bind(result[0], wrapper(label, trees[label], forward))
        regs[label] = kernel_registers(result[1], f"win_{direction}_bf16")
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(3)
    step = {}  # label -> {"ms", "stage1", "stage4", ...}
    for stage, side, h, n_plain, n_shift in SWIN_STAGES:
        for shifted, n_blocks in ((False, n_plain), (True, n_shift)):
            if not n_blocks:
                continue
            inputs = window_inputs(g, side, h, torch.bfloat16, shifted)
            for label in list(kernels):
                try:
                    check(label, kernels[label], inputs, h)
                except RuntimeError as exc:
                    print(f"FAILED {stage} shift={shifted} {exc}", flush=True)
                    failed = True
                    del kernels[label]
            q, k, v, bias, mask, dout = inputs
            args = (q, k, v, h, bias, mask) if forward else (q, k, v, h, bias, mask, dout)
            fns = {label: (lambda kernel=kernel: kernel(*args))
                   for label, kernel in kernels.items()}
            fns[SDPA] = window_sdpa(q, k, v, dout, h, bias, mask)[0 if forward else 1]
            times = {name: [] for name in fns}
            for fn in fns.values():  # warm up
                for _ in range(3):
                    fn()
            for _ in range(ROUNDS):
                for name, fn in fns.items():
                    times[name] += [time_once(fn) for _ in range(SAMPLES)]
            ms = {name: statistics.median(t) for name, t in times.items()}
            host = {name: statistics.median(host_once(fn) for _ in range(SAMPLES))
                    for name, fn in fns.items()}
            bound_ms = window_bounds(q, h, mask)[direction][0]
            for name in fns:
                rec = step.setdefault(name, {"ms": 0.0})
                rec["ms"] += n_blocks * ms[name]
                rec[f"{stage}{'s' if shifted else ''}"] = ms[name]
                print(f"{direction} {stage} BnW={q.shape[0]} H={h} shift={shifted} [{name}] "
                      f"ms={ms[name]:.4f} /bound={ms[name] / bound_ms:.3f} "
                      f"/sdpa={ms[name] / ms[SDPA]:.3f} host_ms={host[name]:.4f} | {card}",
                      flush=True)
            step.setdefault("bound", {"ms": 0.0})["ms"] += n_blocks * bound_ms
    for name, rec in step.items():
        if name in kernels or name == SDPA:
            print(f"{direction} swin-t step [{name}] ms={rec['ms']:.4f} "
                  f"/bound={rec['ms'] / step['bound']['ms']:.3f} "
                  f"/sdpa={rec['ms'] / step[SDPA]['ms']:.3f} stage1={rec['stage1']:.4f} "
                  f"stage4={rec['stage4']:.4f} | {card}", flush=True)
    print(f"{direction} swin-t step [bound] ms={step['bound']['ms']:.4f}", flush=True)
    for label in kernels:
        print(f"registers [{label}] {regs[label]}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
