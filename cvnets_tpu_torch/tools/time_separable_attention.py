"""Build and time the separable attention (forward, backward, both) of several
checkouts in one process.

    python3 -m cvnets_tpu_torch.tools.time_separable_attention [LABEL=CHECKOUT ...]

Run from the repository root (it takes the flagship's and DeepLabv3's shapes,
``SEP_FLAGSHIP`` and ``SEP_DEEPLAB``, and ``bound`` from ``chip_smoke.py``).
Each CHECKOUT is the root of a tree that holds ``cvnets_tpu_torch/``: such as
the parent commit unpacked with ``git archive`` into a git-ignored directory.
Without arguments it takes this tree. Every tree's ``csrc/separable_attention.cu``
is built with nvcc at once (``-Xptxas -v``) into
``build/time_separable_attention/LABEL.so``, and the checkout's own
``ops/separable_attention.py`` is loaded and its kernel wrappers bound to that
build, so each tree runs with its own wrapper and autograd Function.

At each shape, q, k and v are column slices of one bf16 qkv tensor
(BP, N, 1 + 2C), as ``LinearSelfAttention`` makes them. Each tree's output and
its gradient of qkv are checked against the plain versions of this tree
(``separable_attention_plain``, ``separable_attention_backward``; 2e-2 relative
for the output, 2e-2 of the largest gradient, as ``chip_smoke.py`` holds bf16)
and the gradient for the same bits on a second call. Then, in alternating rounds
(CUDA events around 20 calls a sample, the median of all samples), three things
a tree: the forward under ``torch.no_grad``; the backward alone
(``torch.autograd.grad`` of the forward's output, which for a tree whose
Function takes q, k and v includes autograd's concatenation of dq, dk and dv
into the gradient of qkv); and the forward and backward together on a qkv leaf.
One line a case and tree: ms a call of each, ÷ its bound (the forward: qkv read
and the output written once; the backward: g, k and v read and dk, dv written
once, 10 bytes an element in bf16, plus q read and dq written), and the same
three as device time by ``torch.profiler`` (``dev``: the sum of every kernel's
time over 10 calls, with no gap the host leaves between launches, which the
event timing counts where the host's enqueue is the slower); then each
tree's flagship and DeepLabv3 step sums (each shape times its blocks a step)
and ptxas's registers, spills and blocks an SM by registers (256 threads a
block). A tree that fails to build or to match is named and left out, and the
exit code is then 1.
"""

from __future__ import annotations

import importlib.util
import inspect
import os
import statistics
import sys

import torch

from chip_smoke import SEP_DEEPLAB, SEP_FLAGSHIP, bound
from cvnets_tpu_torch.ops.cuda_build import KernelEntry
from cvnets_tpu_torch.ops.separable_attention import (
    separable_attention_backward,
    separable_attention_plain,
)
from cvnets_tpu_torch.tools.kernel_variants import (
    bind,
    build_all,
    build_dir,
    registers,
    time_once,
)

ROUNDS, SAMPLES = 5, 3
OUT_DIR = build_dir("time_separable_attention")
THIS = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def checkout_module(label: str, root: str):
    """The checkout's ``ops/separable_attention.py`` as a module of its own."""
    path = os.path.join(root, "cvnets_tpu_torch", "ops", "separable_attention.py")
    spec = importlib.util.spec_from_file_location(f"separable_attention_{label}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def entry(module):
    """qkv, C → the attention output through the module's autograd Function,
    whichever inputs it takes: the qkv tensor and C, or q, k and v. The q, k, v
    form is the Function of the trees before the qkv form (the parent this
    tool was written to time against); it can go once no tree timed here
    predates the qkv form."""
    params = inspect.signature(module.SeparableAttention.forward).parameters
    if "qkv" in params:
        return lambda qkv, c: module.SeparableAttention.apply(qkv, c)
    return lambda qkv, c: module.SeparableAttention.apply(*qkv.split([1, c, c], dim=-1))


def device_ms(fn, calls: int = 10) -> float:
    """ms of device time a call: every CUDA kernel's, memcpy's and memset's
    time in ``torch.profiler`` over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / calls


def occupancy(report: str) -> str:
    out = []
    for name, (regs, spill) in sorted(registers(report).items()):
        per_warp = -(-regs * 32 // 256) * 256
        out.append(f"{name} {regs} regs/{spill} B spilled/{65536 // (8 * per_warp)} blocks")
    return "; ".join(out)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("time_separable_attention: no CUDA device", file=sys.stderr)
        return 2
    trees = dict(a.split("=", 1) for a in argv) or {"this": THIS}
    failed = False
    fns, reports = {}, {}
    csrcs = {label: os.path.join(root, "cvnets_tpu_torch", "csrc") for label, root in trees.items()}
    for label, result in build_all(csrcs, "separable_attention.cu", OUT_DIR).items():
        if isinstance(result, Exception):
            print(f"FAILED {result}", flush=True)
            failed = True
            continue
        module = checkout_module(label, trees[label])
        for obj in vars(module).values():
            if isinstance(obj, KernelEntry):
                bind(result[0], obj)
        fns[label] = entry(module)
        reports[label] = result[1]
    card = torch.cuda.get_device_name(0)
    g = torch.Generator(device="cuda").manual_seed(0)
    steps = {label: {} for label in fns}
    for recipe, (bp, blocks) in (("flagship", SEP_FLAGSHIP), ("deeplab", SEP_DEEPLAB)):
        for (n, c), per_step in blocks.items():
            qkv = torch.randn((bp, n, 1 + 2 * c), generator=g, device="cuda").bfloat16()
            dout = torch.randn((bp, n, c), generator=g, device="cuda").bfloat16()
            q, k, v = qkv.split([1, c, c], dim=-1)
            ref = separable_attention_plain(q, k, v).float()
            ref_grad = torch.cat(separable_attention_backward(q, k, v, dout), dim=-1).float()
            tol = 2e-2 * ref_grad.abs().max().item()
            leaf = qkv.detach().requires_grad_()
            for label in list(fns):
                fn = fns[label]
                out = fn(leaf, c)
                grad = torch.autograd.grad(out, leaf, dout, retain_graph=True)[0]
                again = torch.autograd.grad(out, leaf, dout)[0]
                err = ((out.float() - ref).abs() / (ref.abs() + 1e-5)).max().item()
                gerr = (grad.float() - ref_grad).abs().max().item()
                if err > 2e-2 or gerr > tol or not torch.equal(grad, again):
                    print(f"FAILED {recipe} N={n} C={c} [{label}] out rel err {err:.3e}, "
                          f"grad err {gerr:.3e} (tol {tol:.3e}), same bits "
                          f"{torch.equal(grad, again)}", flush=True)
                    failed = True
                    del fns[label]
            esize = qkv.element_size()
            b_fwd = bound(qkv.numel() * esize + bp * n * c * esize)[0]
            b_bwd = bound((5 * c + 2) * bp * n * esize)[0]
            outs = {label: fn(leaf, c) for label, fn in fns.items()}

            def fwd(fn):
                with torch.no_grad():
                    fn(qkv, c)

            cases = {}
            for label, fn in fns.items():
                cases[label] = {
                    "fwd": lambda fn=fn: fwd(fn),
                    "bwd": lambda o=outs[label]: torch.autograd.grad(o, leaf, dout, retain_graph=True),
                    "both": lambda fn=fn: torch.autograd.grad(fn(leaf, c), leaf, dout),
                }
            times = {label: {p: [] for p in ("fwd", "bwd", "both")} for label in cases}
            for parts in cases.values():  # warm up
                for f in parts.values():
                    for _ in range(3):
                        f()
            for _ in range(ROUNDS):
                for label, parts in cases.items():
                    for p, f in parts.items():
                        times[label][p] += [time_once(f) for _ in range(SAMPLES)]
            for label, t in times.items():
                ms = {p: statistics.median(x) for p, x in t.items()}
                dev = {p: device_ms(f) for p, f in cases[label].items()}
                for p in ms:
                    for key, x in (((recipe, p), ms[p]), ((recipe, p + "_dev"), dev[p])):
                        steps[label][key] = steps[label].get(key, 0.0) + per_step * x
                print(f"{recipe} BP={bp} N={n} C={c} [{label}] "
                      + " ".join(f"{p}_ms={ms[p]:.4f} {p}_dev={dev[p]:.4f} /bound={dev[p] / b:.2f}"
                                 for p, b in (("fwd", b_fwd), ("bwd", b_bwd),
                                              ("both", b_fwd + b_bwd)))
                      + f" (bounds {b_fwd:.4f}, {b_bwd:.4f}; x{per_step} a step) | {card}",
                      flush=True)
            del outs, cases, leaf
    for label, s in steps.items():
        print(f"step [{label}] " + " ".join(f"{r}_{p}_ms={v:.4f}" for (r, p), v in s.items()),
              flush=True)
    for label in fns:
        print(f"registers [{label}] {occupancy(reports[label])}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
