"""Build and time the seg-CE backward of several source trees in one process.

    python3 -m cvnets_tpu_torch.tools.time_seg_ce_backward [LABEL=CSRC_DIR ...]

Run from the repository root (it takes DeepLabv3's seg-CE shapes, inputs,
bounds and calls a step from ``chip_smoke.py``). Each CSRC_DIR holds a
``seg_ce.cu``: a checkout's ``cvnets_tpu_torch/csrc``, such as the parent
commit's unpacked with ``git archive`` into a git-ignored directory. Without
arguments it takes this tree's. Every tree is built with nvcc at once
(``-Xptxas -v``) into ``build/time_seg_ce_backward/LABEL.so`` and bound as the
``SegCEBackwardKernel`` of the checkout's ``ops/seg_ce_kernel.py`` beside
CSRC_DIR, with that module's ``interp_taps`` tables (the C signature and the
tables change between trees), or of this tree where there is none.

At DeepLabv3's shape (hmid (8, 512, 32, C) float32 from head logits
(8, 32, 32, C) → labels (8, 512, 512), 5% ignored pixels and one fully
ignored image, ls 0, no class weights) with C 150 (ADE20k) and C 21
(pascal_voc), each build's dhm is checked against ``seg_ce_bwd_plain`` (1e-6
of its largest value, as the card tests hold it) and for the same bits on a
second call; then the builds are timed in alternating rounds (CUDA events
around 20 launches a sample, the median of all samples). One line a case and
build: ms a call, ms a step (× ``chip_smoke.SEG_CALLS``) and the ratio to the
bound of ``chip_smoke.seg_ce_bounds``; then each build's ptxas registers and
spills of every instance of the backward kernel at 2 taps, and the blocks an
SM that the registers and the shared memory at C allow. A tree that fails to
build or to match is named and left out, and the exit code is then 1.
"""

from __future__ import annotations

import importlib.util
import os
import re
import statistics
import sys

import torch

from chip_smoke import (
    SEG_C,
    SEG_C_VOC,
    SEG_CALLS,
    SEG_FULL,
    SEG_HEAD,
    no_tf32,
    seg_ce_bounds,
    seg_ce_inputs,
)
from cvnets_tpu_torch.ops import seg_ce_kernel
from cvnets_tpu_torch.ops.cuda_build import CSRC_DIR
from cvnets_tpu_torch.ops.seg_ce import resize_matrix, resize_matrix_weights
from cvnets_tpu_torch.ops.seg_ce_kernel import h_interp, seg_ce_bwd_plain
from cvnets_tpu_torch.tools.kernel_variants import (
    bind,
    build_all,
    build_dir,
    registers,
    time_once,
)

ROUNDS, SAMPLES = 5, 3
OUT_DIR = build_dir("time_seg_ce_backward")
SM_SMEM, BLOCK_RESERVE = 233472, 1024  # bytes of shared memory an SM, reserved a block


def checkout_module(label: str, csrc: str):
    """The ``ops/seg_ce_kernel.py`` of the checkout that holds ``csrc``."""
    path = os.path.join(os.path.dirname(os.path.abspath(csrc)), "ops", "seg_ce_kernel.py")
    if not os.path.isfile(path):
        return seg_ce_kernel
    spec = importlib.util.spec_from_file_location(f"seg_ce_kernel_{label}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module  # its dataclasses look their module up
    spec.loader.exec_module(module)
    return module


def block_smem(module, taps, w: int, big_w: int, c: int):
    """(threads, shared memory bytes) of a backward block: the band walk's
    (the row and the slots of its plan, 256 threads), the transposed lists'
    (the row, its accumulator, the G tile and four per-pixel arrays, 512
    threads), or None for a tree whose wrapper is neither."""
    if hasattr(module, "_bwd_plan"):
        plan = module._bwd_plan(taps, w, c)
        return 32 * module._BWD_WARPS, module._bwd_smem(w, c, plan.n_slots)
    if hasattr(module, "_CHUNK"):
        return 512, (2 * w * c + c * (module._CHUNK + 1) + 4 * big_w) * 4
    return None


def occupancy(report: str, shape) -> str:
    """Registers, spills and blocks an SM of every instance of the backward
    kernel at 2 taps (its template arguments in brackets): 65,536 registers an
    SM allocated 256 a warp, and the SM's shared memory for ``shape``."""
    out = []
    for name, (regs, spill) in sorted(registers(report).items()):
        m = re.search(r"seg_ce_bwd_kernelILi2E((?:Li\d+E)*)E", name)
        if not m:
            continue
        args = ",".join(["2"] + re.findall(r"Li(\d+)E", m.group(1)))
        line = f"<{args}> {regs} regs/{spill} B spilled"
        if shape is not None:
            threads, smem = shape
            by_regs = 65536 // (threads // 32 * (-(-regs * 32 // 256) * 256))
            by_smem = SM_SMEM // (smem + BLOCK_RESERVE)
            line += f"/{min(by_regs, by_smem)} blocks ({by_regs} by registers, {by_smem} by {smem} B)"
        out.append(line)
    return "; ".join(out)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("time_seg_ce_backward: no CUDA device", file=sys.stderr)
        return 2
    trees = dict(a.split("=", 1) for a in argv) or {"this": CSRC_DIR}
    failed = False
    kernels, modules, reports = {}, {}, {}
    for label, result in build_all(trees, "seg_ce.cu", OUT_DIR).items():
        if isinstance(result, Exception):
            print(f"FAILED {result}", flush=True)
            failed = True
            continue
        modules[label] = checkout_module(label, trees[label])
        kernels[label] = bind(result[0], modules[label].SegCEBackwardKernel())
        reports[label] = result[1]
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(2)
    dev = torch.device("cuda")
    ah = aw = resize_matrix(SEG_FULL, SEG_HEAD, dev)
    a_cpu = resize_matrix_weights(SEG_FULL, SEG_HEAD)
    taps = {label: m.interp_taps(a_cpu).to(dev) for label, m in modules.items()}
    scale = torch.full((1,), 1e-6, device=dev)
    occ = {label: [] for label in kernels}
    for c in (SEG_C, SEG_C_VOC):
        logits, target = seg_ce_inputs(g, c)
        hmid = h_interp(logits, ah)
        with no_tf32():
            ref = seg_ce_bwd_plain(hmid, aw, target, None, scale, 255, 0.0)
        tol = 1e-6 * ref.abs().max().item()
        for label in list(kernels):
            dhm = kernels[label](hmid, target, taps[label], None, scale, 255, 0.0)
            again = kernels[label](hmid, target, taps[label], None, scale, 255, 0.0)
            err = (dhm - ref).abs().max().item()
            if not (bool(torch.isfinite(dhm).all()) and err <= tol):
                print(f"FAILED C={c} [{label}] dhm err {err} > {tol}", flush=True)
            elif not torch.equal(dhm, again):
                print(f"FAILED C={c} [{label}] dhm differs between two calls", flush=True)
            else:
                shape = block_smem(modules[label], taps[label], SEG_HEAD, SEG_FULL, c)
                occ[label].append(f"C={c}: {occupancy(reports[label], shape)}")
                continue
            failed = True
            del kernels[label]
        fns = {label: (lambda k=kernel, t=taps[label]: k(hmid, target, t, None, scale, 255, 0.0))
               for label, kernel in kernels.items()}
        times = {label: [] for label in fns}
        for fn in fns.values():  # warm up
            for _ in range(3):
                fn()
        for _ in range(ROUNDS):
            for label, fn in fns.items():
                times[label] += [time_once(fn) for _ in range(SAMPLES)]
        bound_ms = seg_ce_bounds(hmid, target)["bwd"][0]
        for label, t in times.items():
            ms = statistics.median(t)
            print(f"bwd C={c} [{label}] ms={ms:.4f} step_ms={SEG_CALLS * ms:.4f} "
                  f"/bound={ms / bound_ms:.3f} (bound {bound_ms:.4f} ms) | {card}", flush=True)
        del ref, hmid
    for label in kernels:
        print(f"registers [{label}] {'; '.join(occ[label])}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
