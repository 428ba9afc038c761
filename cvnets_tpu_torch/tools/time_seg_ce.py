"""Build and time the seg-CE backward, or with ``--forward`` the forward, of
several source trees in one process.

    python3 -m cvnets_tpu_torch.tools.time_seg_ce [--forward] [LABEL=CSRC_DIR ...]

Run from the repository root (it takes DeepLabv3's seg-CE shapes, inputs,
bounds and calls a step from ``chip_smoke.py``). Each CSRC_DIR holds a
``seg_ce.cu``: a checkout's ``cvnets_tpu_torch/csrc``, such as the parent
commit's unpacked with ``git archive`` into a git-ignored directory. Without
arguments it takes this tree's. Every tree is built with nvcc at once
(``-Xptxas -v``) into ``build/time_seg_ce/LABEL.so`` and bound as the
``SegCEBackwardKernel`` (``SegCEForwardKernel``) of the checkout's
``ops/seg_ce_kernel.py`` beside CSRC_DIR, with that module's ``interp_taps``
tables (the C signature and the tables change between trees), or of this tree
where there is none.

At DeepLabv3's shape (hmid (8, 512, 32, C) float32 from head logits
(8, 32, 32, C) → labels (8, 512, 512), 5% ignored pixels and one fully
ignored image, ls 0, no class weights) with C 150 (ADE20k) and C 21
(pascal_voc), each build's dhm is checked against ``seg_ce_bwd_plain`` (1e-6
of its largest value, as the card tests hold it) and for the same bits on a
second call; with ``--forward``, each build's (loss_sum, n_valid) against
``seg_ce_fwd_plain`` (1e-6 relative, the count exact) and for the same bits on
a second call, there and on spread logits (``chip_smoke.seg_ce_spread``, where
a bound on each pixel's max lies far above it). Then the builds are timed in
alternating rounds (CUDA events around 20 launches a sample, the median of all
samples; with ``--forward`` the loss's forward is timed, ``h_interp`` and the
kernel for a tree whose wrapper takes hmid (and its kernel alone, as
``LABEL:kernel``), the kernel alone for one that forms hmid itself from the
logits, and also the device time a call by ``torch.profiler``,
``dev``, every kernel of the call summed, the kernels a call, and ``host_ms``,
the host's time to enqueue a call: where it nears ms, the wrapper's launch
sets the events' pace). One line a
case and build: ms a call, ms a step (× ``chip_smoke.SEG_CALLS``) and the
ratio to the bound of ``chip_smoke.seg_ce_bounds``; then each build's ptxas
registers and spills of every instance of the kernel at 2 taps, and the blocks
an SM that the registers and the shared memory at C allow. A tree that fails
to build or to match is named and left out, and the exit code is then 1.
"""

from __future__ import annotations

import importlib.util
import inspect
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
    seg_ce_spread,
)
from cvnets_tpu_torch.ops import seg_ce_kernel
from cvnets_tpu_torch.ops.cuda_build import CSRC_DIR
from cvnets_tpu_torch.ops.seg_ce import resize_matrix, resize_matrix_weights
from cvnets_tpu_torch.ops.seg_ce_kernel import h_interp, seg_ce_bwd_plain, seg_ce_fwd_plain
from cvnets_tpu_torch.tools.kernel_variants import (
    bind,
    build_all,
    build_dir,
    host_once,
    registers,
    time_once,
)

ROUNDS, SAMPLES = 5, 3
OUT_DIR = build_dir("time_seg_ce")
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


def block_smem(module, taps, w: int, big_w: int, c: int, forward: bool):
    """(threads, shared memory bytes) of a block: the forward's (256 threads,
    the module's ``_fwd_smem``), or the backward's: the band walk's (the row
    and the slots of its plan, 256 threads), the transposed lists' (the row,
    its accumulator, the G tile and four per-pixel arrays, 512 threads), or
    None for a tree whose wrapper is neither."""
    if forward:
        return 256, module._fwd_smem(w, c)
    if hasattr(module, "_bwd_plan"):
        plan = module._bwd_plan(taps, w, c)
        return 32 * module._BWD_WARPS, module._bwd_smem(w, c, plan.n_slots)
    if hasattr(module, "_CHUNK"):
        return 512, (2 * w * c + c * (module._CHUNK + 1) + 4 * big_w) * 4
    return None


def occupancy(report: str, shape, forward: bool) -> str:
    """Registers, spills and blocks an SM of every instance of the kernel at 2
    taps (its template arguments in brackets): 65,536 registers an SM
    allocated 256 a warp, and the SM's shared memory for ``shape``."""
    out = []
    for name, (regs, spill) in sorted(registers(report).items()):
        kind = "fwd" if forward else "bwd"
        m = re.search(rf"seg_ce_{kind}_kernelILi2E((?:L[ib]\d+E)*)E", name)
        if not m:
            continue
        args = ",".join(["2"] + re.findall(r"L[ib](\d+)E", m.group(1)))
        line = f"<{args}> {regs} regs/{spill} B spilled"
        if shape is not None:
            threads, smem = shape
            by_regs = 65536 // (threads // 32 * (-(-regs * 32 // 256) * 256))
            by_smem = SM_SMEM // (smem + BLOCK_RESERVE)
            line += f"/{min(by_regs, by_smem)} blocks ({by_regs} by registers, {by_smem} by {smem} B)"
        out.append(line)
    return "; ".join(out)


def device_ms(fn, calls: int = 10) -> tuple:
    """(ms of device time a call, kernels a call): every CUDA kernel's,
    memcpy's and memset's time in ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in events) / 1e3 / calls,
            sum(e.count for e in events) / calls)


def check_backward(label: str, kernel, taps, hmid, target, aw, what: str) -> bool:
    """dhm against ``seg_ce_bwd_plain`` within 1e-6 of its largest value, and
    the same bits on a second call; prints and returns False on a failure."""
    scale = torch.full((1,), 1e-6, device=hmid.device)
    with no_tf32():
        ref = seg_ce_bwd_plain(hmid, aw, target, None, scale, 255, 0.0)
    tol = 1e-6 * ref.abs().max().item()
    dhm = kernel(hmid, target, taps, None, scale, 255, 0.0)
    again = kernel(hmid, target, taps, None, scale, 255, 0.0)
    err = (dhm - ref).abs().max().item()
    if not (bool(torch.isfinite(dhm).all()) and err <= tol):
        print(f"FAILED {what} [{label}] dhm err {err} > {tol}", flush=True)
    elif not torch.equal(dhm, again):
        print(f"FAILED {what} [{label}] dhm differs between two calls", flush=True)
    else:
        return True
    return False


def takes_logits(module) -> bool:
    """Whether the tree's forward wrapper forms hmid itself from the head
    logits (and both resize tables), or takes hmid. Only trees from before
    the forward read the logits take hmid: this check, the hmid branch of
    ``forward_call`` and the ``LABEL:kernel`` timing go once no tree to be
    compared is that old."""
    return "logits" in inspect.signature(module.SegCEForwardKernel.__call__).parameters


def forward_call(module, kernel, taps, logits, hmid, target):
    """A call of the tree's forward wrapper on the DeepLabv3 inputs."""
    if takes_logits(module):
        return lambda: kernel(logits, target, taps, taps, None, 255, 0.0)
    return lambda: kernel(hmid, target, taps, None, 255, 0.0)


def check_forward(label: str, call, hmid, target, aw, what: str) -> bool:
    """(loss_sum, n_valid) of ``call`` against ``seg_ce_fwd_plain``: the sum
    within 1e-6 relative, the count exact, and the same bits on a second call;
    prints and returns False on a failure."""
    with no_tf32():
        ref_sum, ref_n = seg_ce_fwd_plain(hmid, aw, target, None, 255, 0.0)
    loss_sum, n_valid = call()
    again = call()
    err = abs(loss_sum.item() - ref_sum.item())
    if not (err <= 1e-6 * abs(ref_sum.item()) and n_valid.item() == ref_n.item()):
        print(f"FAILED {what} [{label}] loss_sum {loss_sum.item()} against {ref_sum.item()}, "
              f"n_valid {n_valid.item()} against {ref_n.item()}", flush=True)
    elif not (torch.equal(loss_sum, again[0]) and torch.equal(n_valid, again[1])):
        print(f"FAILED {what} [{label}] (loss_sum, n_valid) differ between two calls",
              flush=True)
    else:
        print(f"{what} [{label}] loss_sum rel err {err / abs(ref_sum.item()):.3e}, n_valid "
              f"exact, same bits on a rerun", flush=True)
        return True
    return False


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("time_seg_ce: no CUDA device", file=sys.stderr)
        return 2
    forward = "--forward" in argv
    direction = "fwd" if forward else "bwd"
    trees = dict(a.split("=", 1) for a in argv if a != "--forward") or {"this": CSRC_DIR}
    failed = False
    kernels, modules, reports = {}, {}, {}
    for label, result in build_all(trees, "seg_ce.cu", OUT_DIR).items():
        if isinstance(result, Exception):
            print(f"FAILED {result}", flush=True)
            failed = True
            continue
        modules[label] = checkout_module(label, trees[label])
        module = modules[label]
        wrapper = module.SegCEForwardKernel if forward else module.SegCEBackwardKernel
        kernels[label] = bind(result[0], wrapper())
        reports[label] = result[1]
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(2)
    dev = torch.device("cuda")
    ah = aw = resize_matrix(SEG_FULL, SEG_HEAD, dev)
    a_cpu = resize_matrix_weights(SEG_FULL, SEG_HEAD)
    taps = {label: m.interp_taps(a_cpu).to(dev) for label, m in modules.items()}
    scale = torch.full((1,), 1e-6, device=dev)
    occ = {label: [] for label in kernels}

    def check(label, logits, hmid, target, what):
        if forward:
            call = forward_call(modules[label], kernels[label], taps[label], logits, hmid, target)
            return check_forward(label, call, hmid, target, aw, what)
        return check_backward(label, kernels[label], taps[label], hmid, target, aw, what)

    if forward:  # the spread logits, where the bound lies far above the max
        logits, target = seg_ce_spread(g, SEG_C)
        hmid = h_interp(logits, ah)
        for label in list(kernels):
            if not check(label, logits, hmid, target, f"fwd spread C={SEG_C}"):
                failed = True
                del kernels[label]
        del hmid
    for c in (SEG_C, SEG_C_VOC):
        logits, target = seg_ce_inputs(g, c)
        hmid = h_interp(logits, ah)
        for label in list(kernels):
            if check(label, logits, hmid, target, f"{direction} C={c}"):
                shape = block_smem(modules[label], taps[label], SEG_HEAD, SEG_FULL, c, forward)
                occ[label].append(f"C={c}: {occupancy(reports[label], shape, forward)}")
            else:
                failed = True
                del kernels[label]
        fns = {}
        for label, kernel in kernels.items():
            if not forward:
                fns[label] = (lambda k=kernel, t=taps[label]: k(hmid, target, t, None, scale, 255,
                                                                0.0))
                continue
            fns[label] = forward_call(modules[label], kernel, taps[label], logits, hmid, target)
            if not takes_logits(modules[label]):  # the loss's forward: h_interp, then the kernel
                fns[f"{label}:kernel"] = fns[label]
                fns[label] = lambda k=kernel, t=taps[label]: k(h_interp(logits, ah), target, t,
                                                                None, 255, 0.0)
        times = {label: [] for label in fns}
        for fn in fns.values():  # warm up
            for _ in range(3):
                fn()
        for _ in range(ROUNDS):
            for label, fn in fns.items():
                times[label] += [time_once(fn) for _ in range(SAMPLES)]
        dev_ms = {label: device_ms(fn) for label, fn in fns.items()} if forward else {}
        host_ms = ({label: statistics.median(host_once(fn) for _ in range(SAMPLES))
                    for label, fn in fns.items()} if forward else {})
        bound_ms = seg_ce_bounds(logits, target)[direction][0]
        for label, t in times.items():
            ms = statistics.median(t)
            extra = ""
            if label in dev_ms:
                d, n = dev_ms[label]
                extra = (f" dev_ms={d:.4f} dev_step_ms={SEG_CALLS * d:.4f} "
                         f"dev/bound={d / bound_ms:.3f} kernels_a_call={n:g} "
                         f"host_ms={host_ms[label]:.4f}")
            print(f"{direction} C={c} [{label}] ms={ms:.4f} step_ms={SEG_CALLS * ms:.4f} "
                  f"/bound={ms / bound_ms:.3f}{extra} (bound {bound_ms:.4f} ms) | {card}",
                  flush=True)
        del hmid
    for label in kernels:
        print(f"registers [{label}] {'; '.join(occ[label])}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
