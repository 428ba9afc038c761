#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cvnets_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero):

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: compiles csrc/separable_attention.cu for sm_90a;
3. kernel: the separable-attention kernel against its plain torch version at the
   flagship's shapes (BP = 128·4, (N, C) of each MobileViTv2 stage), bfloat16 and
   float32, forward and grads, and both timed with CUDA events;
4. train: MobileViTv2-1.0 train steps at batch 128 × 256² with the flagship yaml's
   settings passed as flags (bf16 autocast, AdamW, EMA, clip 10, label smoothing
   0.1) on random weights and uint8 batches from a seeded generator on the card;
   checks 9 kernel launches a step, finite losses, that params and EMA moved, and
   that the kernel path's logits match the plain attention path's.

The second-to-last line is the kernels' JSON record (``ms``/``plain_ms``: the
kernel's and the plain version's time for one train step's 9 bf16 launches, from
the per-shape medians); the last line is
``{"ok": true, "device": {...}}``. Without a CUDA card it exits 2 before any
result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

SHAPES = [(256, 128), (64, 192), (16, 256)]  # (N, C) of layer_3, layer_4, layer_5
BLOCKS = {(256, 128): 2, (64, 192): 4, (16, 256): 3}  # attention blocks a step
BP = 128 * 4  # batch 128 × patch area 2·2
WARMUP_STEPS, TIMED_STEPS = 2, 5

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
    import os

    from cvnets_tpu_torch.ops.cuda_build import BUILD_DIR
    from cvnets_tpu_torch.ops.separable_attention import separable_attention_kernel

    built_before = os.path.isfile(os.path.join(BUILD_DIR, "separable_attention.so"))
    t0 = time.perf_counter()
    separable_attention_kernel.load()
    print(f"build: separable_attention.cu in {time.perf_counter() - t0:.2f} s"
          f"{' (library found from an earlier build)' if built_before else ''}", flush=True)


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


def phase_train(card: str) -> int:
    import torch

    from cvnets_tpu_torch.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.ops.separable_attention import separable_attention_kernel
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.optim.scheduler import build_scheduler
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=FLAGSHIP_ARGS)
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
    torch.cuda.reset_peak_memory_stats()

    separable_attention_kernel.launches = 0
    losses, step_s = [], []
    for i, b in enumerate(batches):
        t0 = time.perf_counter()
        state, metrics = train_step(state, b, scheduler.retrieve_lr(0, state.step))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
    launches = separable_attention_kernel.launches

    n_steps = len(batches)
    per_step = sum(BLOCKS.values())
    check(launches == per_step * n_steps,
          f"{launches} kernel launches in {n_steps} steps, want {per_step} a step")
    check(all(map(math.isfinite, losses)), f"losses not finite: {losses}")
    check(any(not torch.equal(a, b) for a, b in zip(params0, model.parameters())),
          "params did not change")
    check(any(not torch.equal(a, b) for a, b in zip(
        ema0, state.ema.model.state_dict().values())), "EMA did not change")
    timed = step_s[WARMUP_STEPS:]
    img_s = batch * len(timed) / sum(timed)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"train: MobileViTv2-1.0 batch={batch} {hw[0]}x{hw[1]} bf16 steps={n_steps} "
          f"losses={[round(x, 4) for x in losses]} step_s={[round(x, 4) for x in step_s]} "
          f"img_s={img_s:.1f} peak_mem_gib={peak_gib:.2f} kernel_launches={launches} "
          f"| {card}", flush=True)

    # reference: the trained model's logits through the kernel and through the
    # plain attention path (float32, eval mode), on a small batch. TF32 is off:
    # it rounds conv and matmul inputs to 10 mantissa bits, so the two paths'
    # ~1e-7 differences would flip roundings and show as ~1e-3.
    x = batches[0]["samples"][:8].float() / 255.0
    model.eval()
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        with_kernel = model(x)
        for m in model.modules():
            if hasattr(m, "use_kernel"):
                m.use_kernel = False
        plain = model(x)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    diff = (with_kernel - plain).abs().max().item()
    scale = plain.abs().max().item()
    check(with_kernel.shape == (x.shape[0], n_classes) and bool(torch.isfinite(with_kernel).all()),
          "logits shape or finiteness")
    check(diff <= 1e-4 * max(1.0, scale), f"kernel vs plain logits differ by {diff}")
    print(f"reference: kernel-path vs plain-path logits max diff {diff:.3e} "
          f"(max |logit| {scale:.3e})", flush=True)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import cvnets_tpu_torch  # noqa: F401  (fails here, before any output, outside the repo)

    card = phase_device()
    phase_build()
    record = phase_kernel(card)
    launches = phase_train(card)
    print(json.dumps({"kernels": [{
        "name": "separable_attention",
        "route": "cuda",
        "source": "cvnets_tpu_torch/csrc/separable_attention.cu",
        "replaces": "cvnets_tpu/ops/pallas/mobilevit_attn.py:30",
        "launches": launches,
        "max_abs_err": record["max_abs_err"],
        "ms": record["ms"],
        "plain_ms": record["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
