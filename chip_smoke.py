#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cvnets_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each or more (any failure exits non-zero):

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: compiles csrc/separable_attention.cu and csrc/mha_attention.cu for
   sm_90a, one nvcc each, started together;
3. kernel: the separable-attention kernel against its plain torch version at the
   flagship's shapes (BP = 128·4, (N, C) of each MobileViTv2 stage), bfloat16 and
   float32, forward and grads, and both timed with CUDA events;
4. mha kernel: the fused multi-head attention forward and backward kernels
   against their plain versions at ViT-B/16's shapes (B = 128, S = 197, H = 12,
   D = 64; q, k, v column slices of one qkv tensor), the micro ViT's D = 16 and
   S = 512; bfloat16 and float32, with and without a key mask (one batch element
   fully masked); output, dq, dk and dv; kernels and plain versions timed at
   ViT-B. TF32 is off for the comparisons;
5. train: MobileViTv2-1.0 train steps at batch 128 × 256² with the flagship yaml's
   settings passed as flags (bf16 autocast, AdamW, EMA, clip 10, label smoothing
   0.1) on random weights and uint8 batches from a seeded generator on the card;
   checks 9 kernel launches a step, finite losses, that params and EMA moved, and
   that the kernel path's logits match the plain attention path's;
6. vit train: the same for ViT-B/16 at batch 128 × 224² with vit.yaml's settings
   (AdamW with weight decay 0.2, clip 1.0, EMA 0.0005, GELU, BN in the stem);
   checks 12 forward and 12 backward MHA launches a step;
7. vit a/b: whole ViT-B steps through the kernels against the plain (einsum)
   attention path, in alternating blocks in this one run; both medians;
8. profile: ``torch.profiler`` over 3 ViT-B steps: device time a step, busy
   share, the top kernels; the whole table goes to results/vit_profile.txt.

The second-to-last line is the kernels' JSON record (``ms``/``plain_ms``: a
kernel's and its plain version's time for one train step's launches at bf16:
the separable attention's 9 from the per-shape medians, each MHA kernel's 12 at
ViT-B); the last line is ``{"ok": true, "device": {...}}``. Without a CUDA card
it exits 2 before any result.
"""

from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

SHAPES = [(256, 128), (64, 192), (16, 256)]  # (N, C) of layer_3, layer_4, layer_5
BLOCKS = {(256, 128): 2, (64, 192): 4, (16, 256): 3}  # attention blocks a step
BP = 128 * 4  # batch 128 × patch area 2·2
WARMUP_STEPS, TIMED_STEPS = 2, 5
VIT_BLOCKS = 12  # ViT-B/16's transformer blocks, one MHA each
# (label, B, S, H, D) for the MHA kernel checks; the first is ViT-B/16 at 224²
MHA_CASES = [("vit_base", 128, 197, 12, 64), ("vit_micro", 128, 197, 4, 16),
             ("seq512", 32, 512, 12, 64)]
AB_BLOCKS, AB_STEPS = ("plain", "kernel", "kernel", "plain"), 8

FLAGSHIP_ARGS = [  # config/classification/imagenet/mobilevit_v2.yaml, as flags
    "--model.classification.name", "mobilevit_v2",
    "--model.classification.n-classes", "1000",
    "--model.classification.mitv2.width-multiplier", "1.0",
    "--model.classification.mitv2.attn-norm-layer", "layer_norm_2d",
    "--model.activation.name", "swish",
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.conv-init-std-dev", "0.02",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--loss.category", "classification",
    "--loss.classification.name", "cross_entropy",
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.05",
    "--optim.no-decay-bn-filter-bias",
    "--optim.adamw.beta1", "0.9",
    "--optim.adamw.beta2", "0.999",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "300",
    "--scheduler.warmup-iterations", "20000",
    "--scheduler.warmup-init-lr", "1e-6",
    "--scheduler.cosine.max-lr", "0.002",
    "--scheduler.cosine.min-lr", "0.0002",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--common.mixed-precision-dtype", "bfloat16",
    "--common.grad-clip", "10.0",
    "--dataset.train-batch-size0", "128",
    "--sampler.bs.crop-size-width", "256",
    "--sampler.bs.crop-size-height", "256",
    "--common.seed", "0",
]

VIT_ARGS = [  # config/classification/imagenet/vit.yaml, as flags
    "--model.classification.name", "vit",
    "--model.classification.n-classes", "1000",
    "--model.classification.vit.mode", "base",
    "--model.classification.vit.norm-layer", "layer_norm",
    "--model.activation.name", "gelu",
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--loss.category", "classification",
    "--loss.classification.name", "cross_entropy",
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.2",
    "--optim.no-decay-bn-filter-bias",
    "--optim.adamw.beta1", "0.9",
    "--optim.adamw.beta2", "0.999",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "300",
    "--scheduler.warmup-iterations", "7500",
    "--scheduler.warmup-init-lr", "1e-6",
    "--scheduler.cosine.max-lr", "0.002",
    "--scheduler.cosine.min-lr", "2e-5",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--common.mixed-precision-dtype", "bfloat16",
    "--common.grad-clip", "1.0",
    "--dataset.train-batch-size0", "128",
    "--sampler.bs.crop-size-width", "224",
    "--sampler.bs.crop-size-height", "224",
    "--common.seed", "0",
]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def time_ms(fn, launches: int = 20, samples: int = 11, warmup: int = 5) -> float:
    """Median over ``samples`` of the mean time of ``launches`` back-to-back calls
    between two CUDA events: a single call between events would also time the
    host's launch overhead of a kernel that runs for tens of microseconds."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


class no_tf32:
    """TF32 off for convs and matmuls inside the block (it rounds their inputs to
    10 mantissa bits, so two float32 paths that differ by ~1e-7 would show ~1e-3);
    the previous settings come back afterwards."""

    def __enter__(self):
        import torch

        self.saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = self.saved


def set_use_kernel(model, on: bool) -> None:
    for m in model.modules():
        if hasattr(m, "use_kernel"):
            m.use_kernel = on


def phase_device() -> str:
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    return smi


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from cvnets_tpu_torch.ops.cuda_build import BUILD_DIR, build_library
    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel
    from cvnets_tpu_torch.ops.separable_attention import separable_attention_kernel

    def build(source: str) -> str:
        lib = os.path.join(BUILD_DIR, os.path.splitext(source)[0] + ".so")
        before = os.path.isfile(lib)
        t0 = time.perf_counter()
        build_library(source)
        return (f"{source} in {time.perf_counter() - t0:.2f} s"
                f"{' (library found from an earlier build)' if before else ''}")

    sources = ("separable_attention.cu", "mha_attention.cu")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
        done = list(pool.map(build, sources))
    print(f"build: {'; '.join(done)}; {time.perf_counter() - t0:.2f} s in all", flush=True)
    for kernel in (separable_attention_kernel, mha_fwd_kernel, mha_bwd_kernel):
        kernel.load()


def phase_kernel(card: str) -> dict:
    import torch

    from cvnets_tpu_torch.ops.separable_attention import (
        SeparableAttention,
        separable_attention_kernel,
        separable_attention_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(0)
    record = {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0}
    for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        for n, c in SHAPES:
            # q, k, v as column slices of one qkv projection, as on the main path
            qkv = torch.randn((BP, n, 1 + 2 * c), generator=g, device="cuda").to(dtype)
            q, k, v = qkv.split([1, c, c], dim=-1)
            out = separable_attention_kernel(q, k, v)
            ref = separable_attention_plain(q, k, v)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs()
            abs_err = err.max().item()
            # relative to |ref| + 1e-5: where ctx cancels to ~0 the two f32 sum
            # orders differ by ~1e-7 absolute but not relatively
            rel_err = (err / (ref.float().abs() + 1e-5)).max().item()
            if dtype == torch.float32:
                check(abs_err <= 1e-5, f"f32 ({n},{c}) max abs err {abs_err}")
            else:
                # bf16 output rounding of nearly the same f32 value: 2^-8 relative
                check(rel_err <= 2e-2, f"bf16 ({n},{c}) max rel err {rel_err}")
                record["max_abs_err"] = max(record["max_abs_err"], abs_err)

            # grads: the Function's hand-written backward against autograd of plain
            w = torch.randn((BP, n, c), generator=g, device="cuda").to(dtype)
            grads = []
            for fn in (SeparableAttention.apply, separable_attention_plain):
                x = qkv.detach().clone().requires_grad_()
                (fn(*x.split([1, c, c], dim=-1)).float() * w.float()).sum().backward()
                grads.append(x.grad.float())
            gerr = (grads[0] - grads[1]).abs().max().item()
            gtol = 1e-4 if dtype == torch.float32 else 2e-2 * grads[1].abs().max().item()
            check(gerr <= gtol, f"{name} ({n},{c}) grad err {gerr} > {gtol}")

            k_ms = time_ms(lambda: separable_attention_kernel(q, k, v))
            p_ms = time_ms(lambda: separable_attention_plain(q, k, v))
            if dtype == torch.bfloat16:
                record["ms"] += BLOCKS[(n, c)] * k_ms
                record["plain_ms"] += BLOCKS[(n, c)] * p_ms
            print(f"kernel: {name} BP={BP} N={n} C={c} max_abs_err={abs_err:.3e} "
                  f"max_rel_err={rel_err:.3e} grad_err={gerr:.3e} kernel_ms={k_ms:.4f} "
                  f"plain_ms={p_ms:.4f} | {card}", flush=True)
    return record


def phase_mha_kernel(card: str) -> dict:
    """Returns {"fwd": record, "bwd": record} for the JSON line."""
    import torch

    from cvnets_tpu_torch.ops.mha_attention import (
        mha_attention_backward_plain,
        mha_attention_plain,
        mha_bwd_kernel,
        mha_fwd_kernel,
    )

    g = torch.Generator(device="cuda").manual_seed(1)
    records = {p: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0} for p in ("fwd", "bwd")}
    with no_tf32():
        for label, b, s, h, d in MHA_CASES:
            e = h * d
            for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                for masked in (False, True):
                    # q, k, v as column slices of one qkv projection, q scaled,
                    # as MultiHeadAttention hands them over
                    qkv = torch.randn((b, s, 3 * e), generator=g, device="cuda").to(dtype)
                    q, k, v = qkv.chunk(3, dim=-1)
                    q = q * d ** -0.5
                    mask = None
                    if masked:  # -1e30 as the layer makes it; batch element 0 fully masked
                        mask = torch.where(torch.rand((b, s), generator=g, device="cuda")
                                           < 0.2, -1e30, 0.0)
                        mask[0] = -1e30
                    dout = torch.randn((b, s, e), generator=g, device="cuda").to(dtype)
                    out, stats = mha_fwd_kernel(q, k, v, h, mask)
                    grads = mha_bwd_kernel(q, k, v, mask, out, dout, stats, h)
                    torch.cuda.synchronize()
                    ref = mha_attention_plain(q, k, v, h, mask)
                    ref_grads = mha_attention_backward_plain(q, k, v, mask, ref, dout, h)
                    errs = {}
                    for what, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads),
                                               (ref, *ref_grads)):
                        check(bool(torch.isfinite(got).all()), f"{label} {name} {what} finite")
                        err = (got.float() - want.float()).abs().max().item()
                        # float32: the same math in another order; bf16: P and dS
                        # rounded to bf16 before their products, outputs rounded
                        tol = ((1e-5 if what == "out" else 1e-4) if dtype == torch.float32
                               else 2e-2 * want.float().abs().max().item())
                        check(err <= tol, f"{label} {name} mask={masked} {what} err "
                                          f"{err} > {tol}")
                        errs[what] = err
                    if dtype == torch.bfloat16:
                        records["fwd"]["max_abs_err"] = max(records["fwd"]["max_abs_err"],
                                                            errs["out"])
                        records["bwd"]["max_abs_err"] = max(
                            records["bwd"]["max_abs_err"], errs["dq"], errs["dk"], errs["dv"])
                    times = ""
                    if label == "vit_base":
                        t = {"fwd": time_ms(lambda: mha_fwd_kernel(q, k, v, h, mask)),
                             "fwd_plain": time_ms(lambda: mha_attention_plain(q, k, v, h, mask)),
                             "bwd": time_ms(lambda: mha_bwd_kernel(q, k, v, mask, out, dout,
                                                                   stats, h)),
                             "bwd_plain": time_ms(lambda: mha_attention_backward_plain(
                                 q, k, v, mask, ref, dout, h))}
                        if dtype == torch.bfloat16 and not masked:
                            for p in ("fwd", "bwd"):
                                records[p]["ms"] = VIT_BLOCKS * t[p]
                                records[p]["plain_ms"] = VIT_BLOCKS * t[f"{p}_plain"]
                        flops = 4 * b * s * s * e  # QK^T and PV; the backward does 2.5x
                        times = (f" fwd_ms={t['fwd']:.4f} fwd_plain_ms={t['fwd_plain']:.4f} "
                                 f"bwd_ms={t['bwd']:.4f} bwd_plain_ms={t['bwd_plain']:.4f} "
                                 f"fwd_tflops={flops / t['fwd'] / 1e9:.1f} "
                                 f"bwd_tflops={2.5 * flops / t['bwd'] / 1e9:.1f}")
                    print(f"mha kernel: {label} {name} B={b} S={s} H={h} D={d} "
                          f"mask={masked} " + " ".join(f"{w}_err={x:.3e}"
                                                       for w, x in errs.items())
                          + times + f" | {card}", flush=True)
    return records


def phase_train(card: str, label: str, args, kernels: dict, per_step: dict):
    """Train steps of the model of ``args``; ``kernels`` are the wrappers of the
    path, whose counts are set to 0 just before the steps and read just after.
    Returns the counts and what the A/B phase needs."""
    import torch

    from cvnets_tpu_torch.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.optim.scheduler import build_scheduler
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=args)
    device = torch.device("cuda:0")
    batch = getattr(opts, "dataset.train_batch_size0")
    hw = (getattr(opts, "sampler.bs.crop_size_height"),
          getattr(opts, "sampler.bs.crop_size_width"))
    model = get_model(opts).to(device)
    state = create_train_state(model, build_optimizer(opts, model),
                               ema_enabled=getattr(opts, "ema.enable"))
    train_step = make_train_step(model, build_loss_fn(opts), opts)
    scheduler = build_scheduler(opts)
    n_classes = getattr(opts, "model.classification.n_classes")
    g = torch.Generator(device=device).manual_seed(getattr(opts, "common.seed"))
    batches = [{"samples": torch.randint(0, 256, (batch, 3, *hw), generator=g,
                                         device=device, dtype=torch.uint8),
                "targets": torch.randint(0, n_classes, (batch,), generator=g,
                                         device=device)}
               for _ in range(WARMUP_STEPS + TIMED_STEPS)]
    params0 = [p.detach().clone() for p in model.parameters()]
    ema0 = [t.detach().clone() for t in state.ema.model.state_dict().values()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for kernel in kernels.values():
        kernel.launches = 0
    losses, step_s = [], []
    for b in batches:
        t0 = time.perf_counter()
        state, metrics = train_step(state, b, scheduler.retrieve_lr(0, state.step))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
    launches = {name: kernel.launches for name, kernel in kernels.items()}

    n_steps = len(batches)
    for name, count in launches.items():
        check(count == per_step[name] * n_steps,
              f"{label}: {count} {name} launches in {n_steps} steps, "
              f"want {per_step[name]} a step")
    check(all(map(math.isfinite, losses)), f"{label}: losses not finite: {losses}")
    check(any(not torch.equal(a, b) for a, b in zip(params0, model.parameters())),
          f"{label}: params did not change")
    check(any(not torch.equal(a, b) for a, b in zip(
        ema0, state.ema.model.state_dict().values())), f"{label}: EMA did not change")
    del params0, ema0
    timed = step_s[WARMUP_STEPS:]
    img_s = batch * len(timed) / sum(timed)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"train: {label} batch={batch} {hw[0]}x{hw[1]} bf16 steps={n_steps} "
          f"losses={[round(x, 4) for x in losses]} step_s={[round(x, 4) for x in step_s]} "
          f"img_s={img_s:.1f} peak_mem_gib={peak_gib:.2f} launches={launches} "
          f"| {card}", flush=True)

    # reference: the trained model's logits through the kernels and through the
    # plain attention path (float32, eval mode, TF32 off), on a small batch
    x = batches[0]["samples"][:8].float() / 255.0
    model.eval()
    with no_tf32(), torch.no_grad():
        with_kernel = model(x)
        set_use_kernel(model, False)
        plain = model(x)
    set_use_kernel(model, True)
    diff = (with_kernel - plain).abs().max().item()
    scale = plain.abs().max().item()
    check(with_kernel.shape == (x.shape[0], n_classes) and bool(torch.isfinite(with_kernel).all()),
          f"{label}: logits shape or finiteness")
    check(diff <= 1e-4 * max(1.0, scale), f"{label}: kernel vs plain logits differ by {diff}")
    print(f"reference: {label} kernel-path vs plain-path logits max diff {diff:.3e} "
          f"(max |logit| {scale:.3e})", flush=True)
    return launches, (state, train_step, scheduler, batches)


def phase_ab(card: str, label: str, run) -> None:
    """Whole train steps with the kernels against the plain attention path, in
    alternating blocks (plain, kernel, kernel, plain) in this one run."""
    import torch

    state, train_step, scheduler, batches = run
    model = state.model
    times = {"plain": [], "kernel": []}
    peak = {"plain": 0, "kernel": 0}
    set_use_kernel(model, False)
    train_step(state, batches[0], scheduler.retrieve_lr(0, state.step))  # plain warm-up
    for mode in AB_BLOCKS:
        set_use_kernel(model, mode == "kernel")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(AB_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(state, batches[i % len(batches)], scheduler.retrieve_lr(0, state.step))
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t0)
        peak[mode] = max(peak[mode], torch.cuda.max_memory_allocated())
    set_use_kernel(model, True)
    batch = batches[0]["samples"].shape[0]
    parts = []
    for mode, ts in times.items():
        ms = 1e3 * statistics.median(ts)
        q1, _, q3 = statistics.quantiles(ts, n=4)
        parts.append(f"{mode}_ms={ms:.3f} (q1 {1e3 * q1:.3f}, q3 {1e3 * q3:.3f}; "
                     f"{batch / ms * 1e3:.1f} img/s; peak {peak[mode] / 2**30:.2f} GiB)")
    print(f"a/b: {label} {len(AB_BLOCKS)} blocks of {AB_STEPS} steps, "
          f"medians: {'; '.join(parts)} | {card}", flush=True)


def phase_profile(card: str, label: str, run, path: str) -> None:
    """torch.profiler over 3 steps: device time by kernel into ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state, train_step, scheduler, batches = run
    n = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            train_step(state, batches[i], scheduler.retrieve_lr(0, state.step))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n
    # kernels, memcpys and memsets on the card; a user annotation's range on the
    # device timeline (Optimizer.step) would count its kernels twice
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    device_s = sum(e.self_device_time_total for e in events) / 1e6 / n
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(f"{label}: {n} profiled steps | {card}\n")
        f.write(f"device_ms_per_step={device_s * 1e3:.3f} wall_ms_per_step={wall * 1e3:.3f} "
                f"busy_share={device_s / wall:.3f} kernels_per_step={sum(e.count for e in events) / n:.0f}\n")
        for e in events:
            f.write(f"{e.self_device_time_total / 1e3 / n:10.3f} ms/step {e.count // n:6d}x  "
                    f"{e.key[:160]}\n")
    print(f"profile: {label} device_ms_per_step={device_s * 1e3:.3f} wall_ms_per_step="
          f"{wall * 1e3:.3f} busy_share={device_s / wall:.3f} (table in {path}) | {card}",
          flush=True)
    for e in events[:12]:
        print(f"profile:   {e.self_device_time_total / 1e3 / n:9.3f} ms/step "
              f"{e.count // n:5d}x {e.key[:110]}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import cvnets_tpu_torch  # noqa: F401  (fails here, before any output, outside the repo)
    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel
    from cvnets_tpu_torch.ops.separable_attention import separable_attention_kernel

    card = phase_device()
    phase_build()
    sep_record = phase_kernel(card)
    mha_records = phase_mha_kernel(card)
    sep_launches, sep_run = phase_train(card, "MobileViTv2-1.0", FLAGSHIP_ARGS,
                                        {"separable_attention": separable_attention_kernel},
                                        {"separable_attention": sum(BLOCKS.values())})
    del sep_run  # the ViT phase's peak memory is its own
    gc.collect()
    torch.cuda.empty_cache()
    vit_launches, vit_run = phase_train(
        card, "ViT-B/16", VIT_ARGS,
        {"mha_attention_fwd": mha_fwd_kernel, "mha_attention_bwd": mha_bwd_kernel},
        {"mha_attention_fwd": VIT_BLOCKS, "mha_attention_bwd": VIT_BLOCKS})
    phase_ab(card, "ViT-B/16", vit_run)
    phase_profile(card, "ViT-B/16", vit_run, os.path.join("results", "vit_profile.txt"))

    def entry(name, source, replaces, launches, record):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": record["max_abs_err"],
                "ms": record["ms"], "plain_ms": record["plain_ms"]}

    print(json.dumps({"kernels": [
        entry("separable_attention", "cvnets_tpu_torch/csrc/separable_attention.cu",
              "cvnets_tpu/ops/pallas/mobilevit_attn.py:44",
              sep_launches["separable_attention"], sep_record),
        entry("mha_attention_fwd", "cvnets_tpu_torch/csrc/mha_attention.cu",
              "cvnets_tpu/ops/pallas/mha_attn.py:134",
              vit_launches["mha_attention_fwd"], mha_records["fwd"]),
        entry("mha_attention_bwd", "cvnets_tpu_torch/csrc/mha_attention.cu",
              "cvnets_tpu/ops/pallas/mha_attn.py:153",
              vit_launches["mha_attention_bwd"], mha_records["bwd"]),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
