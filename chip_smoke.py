#!/usr/bin/env python3
"""Smoke run of the PyTorch port (cvnets_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--deeplab]

``--deeplab`` runs only phases 1, 10 and 11 (DeepLabv3's train, a/b and
profile; about a minute) and prints neither JSON line: run in turns from two
checkouts in one call (parent, change, change, parent, ...), it compares their
DeepLabv3 steps on one card, as the whole script does with five recipes.

Phases, one line each or more (any failure exits non-zero):

1. device: the card's name and ``nvidia-smi`` name and power limit;
2. build: compiles csrc/separable_attention.cu, csrc/mha_attention.cu,
   csrc/seg_ce.cu and csrc/window_attention.cu for sm_90a, one nvcc each,
   started together;
3. kernel: the separable-attention forward and backward kernels against their
   plain torch versions at the flagship's shapes (BP = 128·4, (N, C) of each
   MobileViTv2 stage) and at DeepLabv3's (BP = 8·4 at 512² and output stride
   16), bfloat16 and float32: the output, the autograd Function's gradient of
   qkv, the backward kernel's dqkv against ``separable_attention_backward``
   and the same bits on a rerun; each kernel and its plain version timed with
   CUDA events;
4. mha kernel: the fused multi-head attention forward and backward kernels
   against their plain versions at ViT-B/16's shapes (B = 128, S = 197, H = 12,
   D = 64; q, k, v column slices of one qkv tensor), the micro ViT's D = 16 and
   S = 512; bfloat16 and float32, with and without a key mask (one batch element
   fully masked); output, the forward's row statistics (max and log-sum),
   dq, dk and dv, and the backward's dq, dk and dv the same bit for bit on a
   second call. The bf16 forward is the Hopper design: 128 query rows a block,
   a cp.async ring of 64-key tiles with one barrier a tile, exp2 with log2 e
   folded in, and at D = 64 and 128 wgmma products in two warpgroups (K and V
   in the 128-byte swizzle, P from registers); D = 16 and 32 take mma.sync with
   ldmatrix fragments in eight warps. The backward is a pre-pass, a dQ and a
   dK/dV kernel. Kernels, plain versions
   and ``F.scaled_dot_product_attention`` (the library yardstick, under its
   cuDNN and its flash backend, each named on the line) timed at ViT-B, with
   the forward's and the backward's TFLOP/s and ratio to each. TF32 is off for
   the comparisons;
5. seg ce kernel: the fused resize + pixel CE forward and backward kernels
   against the plain unfused version at DeepLabv3's shapes (head logits
   (8, 32, 32, 150) → labels (8, 512, 512)), 5% ignored pixels and one fully
   ignored image, label smoothing 0 and 0.1, class weights off and on, float32
   and bfloat16 logits: loss and dlogits; under each float32 case the forward
   kernel's (loss_sum, n_valid) against ``seg_ce_fwd_plain`` (1e-6 relative,
   the count exact, the same bits on a rerun), and at the yaml's case the
   backward kernel's dhm against ``seg_ce_bwd_plain`` and the same bits on a
   rerun; the forward again on logits spread over ±100 with one class at 300
   in a fifth of the head pixels, where the kernel's bound on a pixel's max
   lies far above it (the count of pixels that take its exact fallback is
   printed, and must not be 0); the same checks at C 21 (the pascal_voc
   recipes); kernels and plain versions timed, at C 21 too;
6. train: MobileViTv2-1.0 train steps at batch 128 × 256² with the flagship yaml's
   settings passed as flags (bf16 autocast, AdamW, EMA, clip 10, label smoothing
   0.1) on random weights and uint8 batches from a seeded generator on the card;
   checks 9 forward and 9 backward separable-attention launches a step, finite
   losses, that params and EMA moved, and that the kernel path's logits match
   the plain attention path's; then its a/b and profile as for ViT-B
   (results/mobilevit_profile.txt);
7. vit train: the same for ViT-B/16 at batch 128 × 224² with vit.yaml's settings
   (AdamW with weight decay 0.2, clip 1.0, EMA 0.0005, GELU, BN in the stem);
   checks 12 forward and 12 backward MHA launches a step;
8. vit a/b: whole ViT-B steps through the kernels against the plain (einsum)
   attention path, in alternating blocks in this one run; both medians, and
   the host's time to enqueue a step;
9. vit profile: ``torch.profiler`` over 3 ViT-B steps: device time a step, busy
   share, the top kernels; the whole table goes to results/vit_profile.txt;
10. deeplab train: DeepLabv3-MobileViTv2-1.0 at batch 8 × 512² with
   deeplabv3_mobilevitv2.yaml's settings (150 classes, OS 16, aux head, ASPP
   512 at rates 6/12/18, dropouts 0.1, BN for SyncBN, SGD 0.9 with weight decay
   1e-4 and the head's LR ×10, clip 10, EMA 0.0005, bf16) and labels with 5%
   ignored pixels; checks 2 seg-CE forward, 2 backward and 9 + 9 separable-attention
   launches a step, finite losses (total, seg, aux), that params and EMA moved,
   the kernel path's loss against the plain path's on the same outputs, and the
   eval logits through the kernels against the plain attention path;
11. deeplab a/b and deeplab profile, as for ViT-B (results/deeplab_profile.txt);
12. window kernel: the window-attention forward and backward kernels against
   their plain versions at Swin-T's four stage shapes at batch 128 (S = 49,
   D = 32; B·nW, H = 8192, 3 / 2048, 6 / 512, 12 / 128, 24; q, k, v column
   thirds of one qkv tensor), with the stage's real shift mask and without,
   bfloat16 and float32: output, dq, dk, dv and dbias, and dbias the same bit
   for bit on a second run; kernels, plain versions and
   ``F.scaled_dot_product_attention`` with the bias as a float mask timed, the
   forward's and the backward's ratio to its bound and to SDPA on each bf16
   line. Both bf16 kernels are the Hopper design: the next window's tiles
   copied by cp.async while this one computes, ldmatrix fragments for every
   product, exp2 with log2 e folded into the bias, held in shared memory in
   fragment order, and as few images a block as fill one wave of the card;
13. mha long kernel: the same kernels (the Hopper forward of phase 4 serves
   every S) against the plain versions at S = 1024 (ViT-B/16 at 512² without
   the CLS token, B = 32) and S = 4096 (B = 2), H = 12, D = 64, with and
   without a key mask (one batch element fully masked), bfloat16 and float32:
   output, statistics and grads, the backward the same bit for bit on a
   second call; timed at S = 1024 as in phase 4, the backward's time split
   between its pre-pass, dQ and dK/dV kernels by ``torch.profiler``;
14. swin train, swin a/b, swin profile: Swin-T steps at batch 128 × 224² with
   swin.yaml's settings (AdamW with weight decay 0.05, cosine LR, clip 5,
   label smoothing 0.1, EMA 0.0005, GELU, LayerNorm, stochastic depth 0.2);
   checks 12 forward and 12 backward window-attention launches a step, then as
   for ViT-B (results/swin_profile.txt);
15. vit long train, a/b and profile: ViT-B/16 steps at batch 32 × 512² without
   the CLS token (S = 1024), vit.yaml's settings otherwise; checks 12 forward
   and 12 backward MHA launches a step at S = 1024 and the logits against the
   einsum path, then as for ViT-B (results/vit_long_profile.txt).

The second-to-last line is the kernels' JSON record, one entry for each TPU
kernel's counterpart: ``ms``/``plain_ms`` are a kernel's and its plain
version's time for one train step's launches (the separable attention's 9
forward and 9 backward at the flagship from the per-shape bf16 medians, each
MHA kernel's 12 at ViT-B and at ViT-B 512², each seg-CE kernel's 2 at
DeepLabv3, each window kernel's 12 at Swin-T from the per-stage medians), ``bound_ms`` the least time the card could
take for the same work (bytes over the HBM rate or operations over their unit's
peak, whichever is larger; the MHA backward's counts the function's work, 5
products of 2·S²·D a head and one exponential a logit, whatever the design
recomputes) and ``library_ms`` one PyTorch call that computes the same
function, where there is one (for the MHA kernels the faster SDPA backend,
named in ``library_backend``, every backend's time in
``library_ms_by_backend``). The two long-sequence backward rows share the
whole backward's bound, plain and library times by the gradients each writes
(``BWD_ROW_SHARE``), so their sum is the whole backward's. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA card it exits 2 before any
result.
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

# separable attention: (BP, {(N, C) of layer_3, layer_4, layer_5: attention blocks})
SEP_FLAGSHIP = (128 * 4, {(256, 128): 2, (64, 192): 4, (16, 256): 3})  # 128 × 256²
SEP_DEEPLAB = (8 * 4, {(1024, 128): 2, (256, 192): 4, (256, 256): 3})  # 8 × 512², OS 16
WARMUP_STEPS, TIMED_STEPS = 2, 5
VIT_BLOCKS = 12  # ViT-B/16's transformer blocks, one MHA each
# (label, B, S, H, D) for the MHA kernel checks; the first is ViT-B/16 at 224²
MHA_CASES = [("vit_base", 128, 197, 12, 64), ("vit_micro", 128, 197, 4, 16),
             ("seq512", 32, 512, 12, 64)]
AB_BLOCKS, AB_STEPS = ("plain", "kernel", "kernel", "plain"), 8
# seg CE at DeepLabv3's shapes: head logits (B, h, w, C) → labels (B, H, W)
SEG_B, SEG_HEAD, SEG_FULL, SEG_C = 8, 32, 512, 150
SEG_CALLS = 2  # main head and aux head, each one forward and one backward a step
SEG_C_VOC = 21  # config/segmentation/pascal_voc/*.yaml
# Swin-T at batch 128 × 224²: (label, map side, heads, unshifted and shifted
# blocks a step); windows of 7 × 7 = 49 tokens, D = 32, stage 4 never shifts
SWIN_BATCH, WIN, WIN_D = 128, 7, 32
SWIN_STAGES = [("stage1", 56, 3, 1, 1), ("stage2", 28, 6, 1, 1),
               ("stage3", 14, 12, 3, 3), ("stage4", 7, 24, 2, 0)]
SWIN_BLOCKS = 12
# the MHA kernels past S = 512: (label, B, S, H, D); the first is the main path's
MHA_LONG_CASES = [("vit_base_512", 32, 1024, 12, 64), ("vit_base_1024", 2, 4096, 12, 64)]
# the long backward's two rows (TPU kernels _pallas_dq and _pallas_dkv) share
# the whole backward's bound, plain and library times by the gradients each
# writes: dq one of three, dk and dv two
BWD_ROW_SHARE = {"dq": 1 / 3, "dkdv": 2 / 3}

# card peaks for the bounds (H100 SXM data sheet);
# the SFU rate is 16 exponentials a clock per SM (CUDA C++ programming guide,
# arithmetic instruction throughput, compute capability 9.0) at the 1,980 MHz
# boost clock of the 700 W part
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
BF16_TC_FLOP_S = 989e12
SFU_EXP_S = 132 * 16 * 1.98e9
# the SDPA backends the MHA kernels are timed against, by name: cuDNN's,
# PyTorch's own choice on the H100, and flash (FlashAttention-2, the mma.sync
# design the MHA kernels are held to); library_ms is the faster of the two
SDPA_BACKENDS = ("CUDNN_ATTENTION", "FLASH_ATTENTION")

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

DEEPLAB_ARGS = [  # config/segmentation/ade20k/deeplabv3_mobilevitv2.yaml, as flags
    "--dataset.category", "segmentation",
    "--model.segmentation.name", "encoder_decoder",
    "--model.segmentation.n-classes", "150",
    "--model.segmentation.lr-multiplier", "10",
    "--model.segmentation.seg-head", "deeplabv3",
    "--model.segmentation.output-stride", "16",
    "--model.segmentation.use-aux-head",
    "--model.segmentation.classifier-dropout", "0.1",
    "--model.segmentation.aux-dropout", "0.1",
    "--model.segmentation.deeplabv3.aspp-dropout", "0.1",
    "--model.segmentation.deeplabv3.aspp-out-channels", "512",
    "--model.segmentation.deeplabv3.aspp-rates", "6", "12", "18",
    "--model.classification.name", "mobilevit_v2",
    "--model.classification.mitv2.width-multiplier", "1.0",
    "--model.classification.mitv2.attn-norm-layer", "layer_norm_2d",
    # as bench_tasks.py:115 runs it: BN for SyncBN on one card; the JAX package
    # builds every layer with model.activation.name (relu), its
    # model.classification.activation.name (swish) is read by no layer
    "--model.normalization.name", "batch_norm",
    "--model.normalization.momentum", "0.1",
    "--model.activation.name", "relu",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "normal",
    "--loss.category", "segmentation",
    "--loss.segmentation.name", "cross_entropy",
    "--loss.segmentation.cross-entropy.aux-weight", "0.4",
    "--loss.segmentation.cross-entropy.ignore-index", "255",
    "--optim.name", "sgd",
    "--optim.weight-decay", "1e-4",
    "--optim.no-decay-bn-filter-bias",
    "--optim.sgd.momentum", "0.9",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "120",
    "--scheduler.warmup-iterations", "500",
    "--scheduler.warmup-init-lr", "0.0009",
    "--scheduler.cosine.max-lr", "0.02",
    "--scheduler.cosine.min-lr", "0.0002",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--common.mixed-precision-dtype", "bfloat16",
    "--common.grad-clip", "10.0",
    "--dataset.train-batch-size0", "8",  # bench_tasks.py:115 (the yaml: 4 a GPU × 8)
    "--sampler.bs.crop-size-width", "512",
    "--sampler.bs.crop-size-height", "512",
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

SWIN_ARGS = [  # config/classification/imagenet/swin.yaml, as flags
    "--model.classification.name", "swin",
    "--model.classification.n-classes", "1000",
    "--model.classification.swin.mode", "tiny",
    "--model.classification.swin.stochastic-depth-prob", "0.2",
    "--model.normalization.name", "layer_norm",
    "--model.activation.name", "gelu",
    "--model.layer.global-pool", "mean",
    "--model.layer.conv-init", "kaiming_normal",
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
    "--scheduler.cosine.max-lr", "0.001",
    "--scheduler.cosine.min-lr", "1e-5",
    "--ema.enable",
    "--ema.momentum", "0.0005",
    "--common.mixed-precision",
    "--common.mixed-precision-dtype", "bfloat16",
    "--common.grad-clip", "5.0",
    "--dataset.train-batch-size0", str(SWIN_BATCH),
    "--sampler.bs.crop-size-width", "224",
    "--sampler.bs.crop-size-height", "224",
    "--common.seed", "0",
]

# ViT-B/16 at 512² without the CLS token: S = 32² = 1024 tokens, the
# long-sequence kernels' range; the batch is vit.yaml's 128 at 224² scaled by
# the area and rounded up (128 · 224² / 512² = 24.5 → 32)
VIT_LONG_ARGS = VIT_ARGS + [
    "--model.classification.vit.no-cls-token",
    "--dataset.train-batch-size0", "32",
    "--sampler.bs.crop-size-width", "512",
    "--sampler.bs.crop-size-height", "512",
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


def set_use_kernel(model, on: bool, criteria=None) -> None:
    """Route every attention layer of ``model`` (and the loss, if it has a
    switch) through the kernels or through the plain versions."""
    for m in model.modules():
        if hasattr(m, "use_kernel"):
            m.use_kernel = on
    if hasattr(criteria, "use_kernel"):
        criteria.use_kernel = on


def bound(n_bytes: float, *ops) -> tuple:
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM rate
    and each (count, peak rate a second) of ``ops`` over its rate."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = max((count / rate for count, rate in ops), default=0.0)
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_yardstick(qh, kh, vh, dh, **kwargs) -> tuple:
    """The library yardstick: ``F.scaled_dot_product_attention`` forward and
    backward on (B, H, S, D) tensors that require grad, timed under each of
    ``SDPA_BACKENDS`` by name. Returns ({backend: {"fwd": ms, "bwd": ms}} of
    those that took the inputs, {backend: why} of those that refused)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times, refused = {}, {}
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]):
                out = F.scaled_dot_product_attention(qh, kh, vh, **kwargs)
                fwd = time_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, **kwargs))
                bwd = time_ms(lambda: torch.autograd.grad(out, (qh, kh, vh), dh,
                                                          retain_graph=True))
        except RuntimeError as err:  # no kernel of this backend takes the inputs
            refused[name] = str(err).splitlines()[0][:80]
            continue
        times[name] = {"fwd": fwd, "bwd": bwd}
    check(bool(times), f"an SDPA backend ran: {refused}")
    return times, refused


def _records(*parts) -> dict:
    """An empty kernel record for the JSON line, for each of ``parts``."""
    return {p: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "bound_by": "bytes", "library_ms": None} for p in parts}


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
    from cvnets_tpu_torch.ops.seg_ce_kernel import seg_ce_bwd_kernel, seg_ce_fwd_kernel
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_bwd_kernel,
        separable_attention_kernel,
    )
    from cvnets_tpu_torch.ops.window_attention import window_bwd_kernel, window_fwd_kernel

    def build(source: str) -> str:
        lib = os.path.join(BUILD_DIR, os.path.splitext(source)[0] + ".so")
        before = os.path.isfile(lib)
        t0 = time.perf_counter()
        build_library(source)
        return (f"{source} in {time.perf_counter() - t0:.2f} s"
                f"{' (library found from an earlier build)' if before else ''}")

    sources = ("separable_attention.cu", "mha_attention.cu", "seg_ce.cu",
               "window_attention.cu")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:  # one nvcc per source, together
        done = list(pool.map(build, sources))
    print(f"build: {'; '.join(done)}; {time.perf_counter() - t0:.2f} s in all", flush=True)
    for kernel in (separable_attention_kernel, separable_attention_bwd_kernel,
                   mha_fwd_kernel, mha_bwd_kernel,
                   seg_ce_fwd_kernel, seg_ce_bwd_kernel, window_fwd_kernel,
                   window_bwd_kernel):
        kernel.load()


def check_qkv_grads(got, ref, c: int, dtype, what: str) -> list:
    """Holds dq, dk and dv, the column parts of one (BP, N, 1 + 2C) gradient,
    each to its reference: finite, and float32 within 1e-4 absolute (three
    sums chained in another order), bfloat16 within 2e-2 of that part's
    largest value (each rounded to bf16 once, from float32 values that
    differ), and never under the float32 1e-4: where a part is zero in exact
    arithmetic (dq at N = 1, where s = 1) the two sides' float32
    cancellations leave ~1e-6. Each part has its own tolerance: dq runs about
    100 times larger than dk and dv, so one for the whole dqkv would let a
    wrong dk or dv pass. Returns (part, max abs err, tolerance) for each."""
    import torch

    check(bool(torch.isfinite(got).all()), f"{what} not finite")
    errs = []
    for part, a, b in zip(("dq", "dk", "dv"), got.float().split([1, c, c], dim=-1),
                          ref.float().split([1, c, c], dim=-1)):
        err = (a - b).abs().max().item()
        tol = 1e-4 if dtype == torch.float32 else max(2e-2 * b.abs().max().item(), 1e-4)
        check(err <= tol, f"{what} {part} err {err} > {tol}")
        errs.append((part, err, tol))
    return errs


def _separable_case(g, bp: int, n: int, c: int, dtype, name: str) -> dict:
    """The separable-attention kernels on one seeded qkv against the plain
    versions: the forward's output; the gradient of qkv through the Function
    (both kernels) against autograd of the plain forward; the backward kernel
    alone against the plain backward, and the same bits on a rerun. Raises on
    a fault; returns the inputs, the kernels' calls and the errors."""
    import torch

    from cvnets_tpu_torch.ops.separable_attention import (
        SeparableAttention,
        separable_attention_backward,
        separable_attention_bwd_kernel,
        separable_attention_kernel,
        separable_attention_plain,
    )

    # q, k, v as column slices of one qkv projection, as on the main path
    qkv = torch.randn((bp, n, 1 + 2 * c), generator=g, device="cuda").to(dtype)
    q, k, v = qkv.split([1, c, c], dim=-1)
    out, stats, ctx = separable_attention_kernel(q, k, v)
    ref = separable_attention_plain(q, k, v)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs()
    abs_err = err.max().item()
    # relative to |ref| + 1e-5: where ctx cancels to ~0 the two f32 sum
    # orders differ by ~1e-7 absolute but not relatively
    rel_err = (err / (ref.float().abs() + 1e-5)).max().item()
    if dtype == torch.float32:
        check(abs_err <= 1e-5, f"f32 ({bp},{n},{c}) max abs err {abs_err}")
    else:
        # bf16 output rounding of nearly the same f32 value: 2^-8 relative
        check(rel_err <= 2e-2, f"bf16 ({bp},{n},{c}) max rel err {rel_err}")

    # grads: the Function (both kernels) against autograd of plain
    w = torch.randn((bp, n, c), generator=g, device="cuda").to(dtype)
    grads = []
    for fn in (lambda x: SeparableAttention.apply(x, c),
               lambda x: separable_attention_plain(*x.split([1, c, c], dim=-1))):
        x = qkv.detach().clone().requires_grad_()
        (fn(x).float() * w.float()).sum().backward()
        grads.append(x.grad)
    gerr = max(e for _, e, _ in check_qkv_grads(grads[0], grads[1], c, dtype,
                                                f"{name} ({bp},{n},{c}) grad"))

    # the backward kernel alone against the plain backward, and its bits
    dqkv, again = torch.empty_like(qkv), torch.empty_like(qkv)

    def bwd_kernel(dst=dqkv):
        separable_attention_bwd_kernel(q, k, v, w, stats, ctx, *dst.split([1, c, c], dim=-1))

    def bwd_plain():
        return torch.cat(separable_attention_backward(q, k, v, w), dim=-1)

    bwd_kernel()
    bwd_kernel(again)
    ref_grad = bwd_plain()
    torch.cuda.synchronize()
    errs = check_qkv_grads(dqkv, ref_grad, c, dtype, f"{name} ({bp},{n},{c}) backward kernel")
    check(torch.equal(dqkv, again), f"{name} ({bp},{n},{c}) backward differs on a rerun")
    return dict(qkv=qkv, q=q, k=k, v=v, out=out, abs_err=abs_err, rel_err=rel_err, gerr=gerr,
                errs=errs, bwd_kernel=bwd_kernel, bwd_plain=bwd_plain)


# (BP, N, C) off the main path's shapes, checked but not timed: a ragged last
# run of each block (N not a multiple of the blocks a row times a step of
# tokens) with, on a 132-SM card, 1, 2, 4 and 8 blocks a row; N past the old
# 12,256 limit; a block with fewer tokens than a warp step; one token; C 512
SEP_RAGGED = ((512, 1000, 128), (200, 1000, 128), (100, 1000, 192), (32, 1000, 128),
              (32, 12257, 128), (4, 5, 64), (3, 1, 128), (16, 300, 512))


def phase_kernel(card: str) -> dict:
    """The separable-attention forward and backward kernels at the flagship's
    and DeepLabv3's shapes, checked and timed, and at SEP_RAGGED, checked;
    returns the flagship's records for the JSON line."""
    import torch

    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_kernel,
        separable_attention_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(0)
    records = _records("fwd", "bwd")
    for label, (bp, blocks) in (("flagship", SEP_FLAGSHIP), ("deeplab", SEP_DEEPLAB)):
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            for n, c in blocks:
                r = _separable_case(g, bp, n, c, dtype, name)
                q, k, v, qkv, out = r["q"], r["k"], r["v"], r["qkv"], r["out"]
                k_ms = time_ms(lambda: separable_attention_kernel(q, k, v))
                p_ms = time_ms(lambda: separable_attention_plain(q, k, v))
                kb_ms = time_ms(r["bwd_kernel"])
                pb_ms = time_ms(r["bwd_plain"])
                # reads q, k, v (the qkv columns) once, writes the output; 4 flops
                # an element of k/v (ctx, relu·ctx) and one exp a token
                b_ms, b_by = bound(qkv.numel() * qkv.element_size() + out.numel()
                                   * out.element_size(), (4 * bp * n * c, FP32_FLOP_S),
                                   (bp * n, SFU_EXP_S))
                # reads g, k, v and q once, writes dk, dv and dq once (10 bytes an
                # element in bf16, plus q and dq); 7 flops an element (dv, dctx,
                # dk, ds) and one exp a token
                bb_ms, bb_by = bound((5 * c + 2) * bp * n * qkv.element_size(),
                                     (7 * bp * n * c, FP32_FLOP_S), (bp * n, SFU_EXP_S))
                berr = max(e for _, e, _ in r["errs"])
                if dtype == torch.bfloat16 and label == "flagship":
                    for rec, e, t, pt, bt, by in (
                            (records["fwd"], r["abs_err"], k_ms, p_ms, b_ms, b_by),
                            (records["bwd"], berr, kb_ms, pb_ms, bb_ms, bb_by)):
                        rec["max_abs_err"] = max(rec["max_abs_err"], e)
                        rec["ms"] += blocks[(n, c)] * t
                        rec["plain_ms"] += blocks[(n, c)] * pt
                        rec["bound_ms"] += blocks[(n, c)] * bt
                        rec["bound_by"] = by
                print(f"kernel: {label} {name} BP={bp} N={n} C={c} max_abs_err={r['abs_err']:.3e} "
                      f"max_rel_err={r['rel_err']:.3e} grad_err={r['gerr']:.3e} "
                      f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) | "
                      f"bwd: {_grad_errs(r['errs'])} same_bits=True "
                      f"bwd_ms={kb_ms:.4f} bwd_plain_ms={pb_ms:.4f} bwd_bound_ms={bb_ms:.4f} "
                      f"({bb_by}) bwd/bound={kb_ms / bb_ms:.2f} | {card}", flush=True)
    for bp, n, c in SEP_RAGGED:
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            r = _separable_case(g, bp, n, c, dtype, name)
            print(f"kernel: ragged {name} BP={bp} N={n} C={c} max_abs_err={r['abs_err']:.3e} "
                  f"max_rel_err={r['rel_err']:.3e} grad_err={r['gerr']:.3e} | bwd: "
                  f"{_grad_errs(r['errs'])} same_bits=True", flush=True)
            del r
    return records


def _grad_errs(errs) -> str:
    return " ".join(f"{part}_err={e:.3e} (tol {t:.3e})" for part, e, t in errs)


def _mha_case(g, label: str, b: int, s: int, h: int, d: int, dtype, masked: bool):
    """The MHA kernels forward and backward against the plain versions on one
    seeded input; raises on a non-finite or wrong output. Returns the inputs,
    the kernel's output and statistics, the plain output and the errors."""
    import torch

    from cvnets_tpu_torch.ops.mha_attention import (
        mha_attention_backward_plain,
        mha_attention_plain,
        mha_attention_stats_plain,
        mha_bwd_kernel,
        mha_fwd_kernel,
    )

    e = h * d
    # q, k, v as column slices of one qkv projection, q scaled, as
    # MultiHeadAttention hands them over
    qkv = torch.randn((b, s, 3 * e), generator=g, device="cuda").to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    q = q * d ** -0.5
    mask = None
    if masked:  # -1e30 as the layer makes it; batch element 0 fully masked
        mask = torch.where(torch.rand((b, s), generator=g, device="cuda") < 0.2, -1e30, 0.0)
        mask[0] = -1e30
    dout = torch.randn((b, s, e), generator=g, device="cuda").to(dtype)
    out, stats = mha_fwd_kernel(q, k, v, h, mask)
    grads = mha_bwd_kernel(q, k, v, mask, out, dout, stats, h)
    again = mha_bwd_kernel(q, k, v, mask, out, dout, stats, h)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(grads, again)),
          f"{label} dq, dk, dv differ between two calls")
    ref = mha_attention_plain(q, k, v, h, mask)
    ref_grads = mha_attention_backward_plain(q, k, v, mask, ref, dout, h)
    errs = {}
    for what, got, want in zip(("out", "dq", "dk", "dv"), (out, *grads), (ref, *ref_grads)):
        check(bool(torch.isfinite(got).all()), f"{label} {what} finite")
        err = (got.float() - want.float()).abs().max().item()
        # float32: the same math in another order; bf16: P and dS rounded to
        # bf16 before their products, outputs rounded
        tol = ((1e-5 if what == "out" else 1e-4) if dtype == torch.float32
               else 2e-2 * want.float().abs().max().item())
        check(err <= tol, f"{label} {what} err {err} > {tol}")
        errs[what] = err
    # the statistics (row max and log-sum, which the backward reads), relative
    # to max(|ref|, 1): the log-sum is near 0 where one key dominates.
    # float32: the same float32 sums in another order (1e-5); bf16: the
    # logits and sums are float32 there too, from the bf16 inputs, so 1e-2
    # is loose; the line prints what the kernel reached
    ref_stats = mha_attention_stats_plain(q, k, v, h, mask)
    check(bool(torch.isfinite(stats).all()), f"{label} stats finite")
    err = ((stats - ref_stats).abs() / ref_stats.abs().clamp(min=1.0)).max().item()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    check(err <= tol, f"{label} stats rel err {err} > {tol}")
    errs["stats"] = err
    return q, k, v, mask, dout, out, stats, ref, errs


def mha_bounds(b: int, s: int, h: int, d: int, itemsize: int, tc_rate: float) -> dict:
    """The least time of the MHA functions, not of a design: each input read
    once and each output written once (forward: q, k, v in, O and the (2, B,
    H, S) statistics out; backward: q, k, v, O, dO and the statistics in, dq,
    dk, dv out); 2 products of 2·S²·D a head forward and 5 backward (S, dP,
    dV, dK, dQ, however many a design recomputes); one exponential a logit."""
    act = b * s * h * d * itemsize
    stats = 2 * b * h * s * 4
    prod = 2 * b * h * s * s * d
    exps = (b * h * s * s, SFU_EXP_S)
    return {"fwd": bound(4 * act + stats, (2 * prod, tc_rate), exps),
            "bwd": bound(8 * act + stats, (5 * prod, tc_rate), exps)}


def _mha_times(b, s, h, d, q, k, v, dout, out, stats, ref) -> dict:
    """One call's time of the MHA kernels, their plain versions and SDPA
    (each of ``SDPA_BACKENDS`` by name; ``lib_fwd`` and ``lib_bwd`` the
    faster one's, which ``lib_fwd_backend`` and ``lib_bwd_backend`` name) at
    a bf16 shape without a mask."""
    import torch

    from cvnets_tpu_torch.ops.mha_attention import (
        mha_attention_backward_plain,
        mha_attention_plain,
        mha_bwd_kernel,
        mha_fwd_kernel,
    )

    t = {"fwd": time_ms(lambda: mha_fwd_kernel(q, k, v, h, None)),
         "fwd_plain": time_ms(lambda: mha_attention_plain(q, k, v, h, None)),
         "bwd": time_ms(lambda: mha_bwd_kernel(q, k, v, None, out, dout, stats, h)),
         "bwd_plain": time_ms(lambda: mha_attention_backward_plain(q, k, v, None, ref, dout,
                                                                   h))}
    # SDPA on (B, H, S, D) copies
    qh, kh, vh, dh = (t_.detach().reshape(b, s, h, d).transpose(1, 2).contiguous()
                      .requires_grad_() for t_ in (q, k, v, dout))
    t["sdpa"], t["sdpa_refused"] = sdpa_yardstick(qh, kh, vh, dh, scale=1.0)
    for p in ("fwd", "bwd"):
        fastest = min(t["sdpa"], key=lambda name: t["sdpa"][name][p])
        t[f"lib_{p}"], t[f"lib_{p}_backend"] = t["sdpa"][fastest][p], fastest
    del qh, kh, vh, dh
    torch.cuda.empty_cache()
    return t


def _mha_library(record: dict, t: dict, p: str, scale: float) -> None:
    """``record``'s library fields from ``t``'s SDPA times of pass ``p``:
    ``library_ms`` the faster backend's, named in ``library_backend``, and
    every backend's in ``library_ms_by_backend``, each times ``scale``."""
    record["library_ms"] = scale * t[f"lib_{p}"]
    record["library_backend"] = t[f"lib_{p}_backend"]
    record["library_ms_by_backend"] = {name: scale * ms[p] for name, ms in t["sdpa"].items()}


def _mha_times_line(t: dict, bounds: dict, flops_fwd: float) -> str:
    return (" ".join(f"{k_}_ms={t[k_]:.4f}" for k_ in ("fwd", "fwd_plain", "bwd", "bwd_plain"))
            + "".join(f" {p}_bound_ms={bounds[p][0]:.4f} ({bounds[p][1]})" for p in bounds)
            + f" fwd_tflops={flops_fwd / t['fwd'] / 1e9:.1f}"
            f" bwd_tflops={2.5 * flops_fwd / t['bwd'] / 1e9:.1f}"
            + "".join(f" | sdpa [{name}] fwd_ms={ms['fwd']:.4f} bwd_ms={ms['bwd']:.4f}"
                      f" fwd_tflops={flops_fwd / ms['fwd'] / 1e9:.1f}"
                      f" bwd/sdpa={t['bwd'] / ms['bwd']:.3f} fwd/sdpa={t['fwd'] / ms['fwd']:.3f}"
                      for name, ms in t["sdpa"].items())
            + "".join(f" | sdpa [{name}] refused ({why})" for name, why in t["sdpa_refused"].items())
            + f" | library: fwd [{t['lib_fwd_backend']}] bwd [{t['lib_bwd_backend']}]"
            f" fwd/library={t['fwd'] / t['lib_fwd']:.3f} bwd/library={t['bwd'] / t['lib_bwd']:.3f}")


def phase_mha_kernel(card: str) -> dict:
    """Returns {"fwd": record, "bwd": record} for the JSON line."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(1)
    records = _records("fwd", "bwd")
    with no_tf32():
        for label, b, s, h, d in MHA_CASES:
            e = h * d
            for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                for masked in (False, True):
                    q, k, v, mask, dout, out, stats, ref, errs = _mha_case(
                        g, f"{label} {name} mask={masked}", b, s, h, d, dtype, masked)
                    if dtype == torch.bfloat16:
                        records["fwd"]["max_abs_err"] = max(records["fwd"]["max_abs_err"],
                                                            errs["out"])
                        records["bwd"]["max_abs_err"] = max(
                            records["bwd"]["max_abs_err"], errs["dq"], errs["dk"], errs["dv"])
                    times = ""
                    if label == "vit_base" and dtype == torch.bfloat16 and not masked:
                        bounds = mha_bounds(b, s, h, d, q.element_size(), BF16_TC_FLOP_S)
                        t = _mha_times(b, s, h, d, q, k, v, dout, out, stats, ref)
                        for p in ("fwd", "bwd"):
                            records[p]["ms"] = VIT_BLOCKS * t[p]
                            records[p]["plain_ms"] = VIT_BLOCKS * t[f"{p}_plain"]
                            records[p]["bound_ms"] = VIT_BLOCKS * bounds[p][0]
                            records[p]["bound_by"] = bounds[p][1]
                            _mha_library(records[p], t, p, VIT_BLOCKS)
                        times = " " + _mha_times_line(t, bounds, 4 * b * s * s * e)
                    print(f"mha kernel: {label} {name} B={b} S={s} H={h} D={d} "
                          f"mask={masked} " + " ".join(f"{w}_err={x:.3e}"
                                                       for w, x in errs.items())
                          + times + f" | {card}", flush=True)
    return records


def seg_ce_inputs(g, c: int) -> tuple:
    """Head logits (SEG_B, SEG_HEAD, SEG_HEAD, c) float32, a permuted view of
    NCHW storage as the loss passes them, and labels (SEG_B, SEG_FULL,
    SEG_FULL) int64 with 5% ignored pixels (255) and one fully ignored image,
    from the generator ``g`` on the card."""
    import torch

    logits = 2.0 * torch.randn((SEG_B, c, SEG_HEAD, SEG_HEAD), generator=g,
                               device="cuda").permute(0, 2, 3, 1)
    target = torch.randint(0, c, (SEG_B, SEG_FULL, SEG_FULL), generator=g, device="cuda")
    target[torch.rand(target.shape, generator=g, device="cuda") < 0.05] = 255
    target[SEG_B - 1] = 255  # one fully ignored image
    return logits, target


def seg_ce_spread(g, c: int) -> tuple:
    """Head logits spread uniformly over ±100 with, in a fifth of the head
    pixels, one class at 300, and labels as ``seg_ce_inputs`` makes them: an
    output pixel beside a hot head pixel lies tens of units under the bound
    on its max that the forward kernel shifts by (the weighted maxima of its
    input columns), so its sum of exponentials underflows and it takes the
    kernel's two passes with its true max."""
    import torch

    logits, target = seg_ce_inputs(g, c)
    logits = 100.0 * (2.0 * torch.rand(logits.shape, generator=g, device="cuda") - 1.0)
    logits = logits.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)  # as the loss's
    hot = torch.rand(logits.shape[:3], generator=g, device="cuda") < 0.2
    cls = torch.randint(0, c, logits.shape[:3] + (1,), generator=g, device="cuda")
    logits.scatter_(-1, cls, torch.where(hot[..., None], 300.0, logits.gather(-1, cls)))
    return logits, target


def seg_ce_underflows(hmid, aw, target) -> int:
    """The valid pixels whose sum of exponentials under the forward kernel's
    bound falls below its 2^-60 (kTiny in seg_ce.cu): those that take its
    two-pass fallback."""
    import torch

    col = torch.matmul(aw, hmid)
    bound = torch.matmul(aw, hmid.amax(-1, keepdim=True))
    s = torch.exp2((col - bound) * 1.4426950408889634).sum(-1)
    return int(((s < 2.0 ** -60) & (target != 255)).sum())


def seg_ce_bounds(logits, target) -> dict:
    """{"fwd": (ms, by), "bwd": (ms, by)}: each input read once, each output
    written once (the forward reads the head logits and the labels, the
    backward hmid, (B, H, w, C) float32, and the labels, and writes dhm); per
    logit of a pixel that is not ignored (both kernels skip the others) one
    exp, 2 taps (4 flops) and the max/sum/sub (3) forward, and the softmax, G
    and 2 taps back (7 more)."""
    b, _, w, c = logits.shape
    n = int((target != 255).sum()) * c
    label_bytes = target.numel() * target.element_size()
    hmid_bytes = b * target.shape[1] * w * c * 4
    return {"fwd": bound(logits.numel() * 4 + label_bytes + 8, (7 * n, FP32_FLOP_S),
                         (n, SFU_EXP_S)),
            "bwd": bound(2 * hmid_bytes + label_bytes, (14 * n, FP32_FLOP_S), (n, SFU_EXP_S))}


def _seg_dhm_check(label: str, hmid, target, aw, taps, cw, ls: float) -> float:
    """The backward kernel's dhm against ``seg_ce_bwd_plain`` (1e-6 of its
    largest value: sums of up to 32 terms in another order, as the card tests
    hold it) and the same bits on a rerun; returns the largest error."""
    import torch

    from cvnets_tpu_torch.ops.seg_ce_kernel import seg_ce_bwd_kernel, seg_ce_bwd_plain

    scale = torch.full((1,), 1.0 / target.numel(), device=hmid.device)
    dhm = seg_ce_bwd_kernel(hmid, target, taps, cw, scale, 255, ls)
    again = seg_ce_bwd_kernel(hmid, target, taps, cw, scale, 255, ls)
    ref = seg_ce_bwd_plain(hmid, aw, target, cw, scale, 255, ls)
    torch.cuda.synchronize()
    err = (dhm - ref).abs().max().item()
    tol = 1e-6 * ref.abs().max().item()
    check(bool(torch.isfinite(dhm).all()) and err <= tol,
          f"seg ce {label} dhm err {err} > {tol}")
    check(torch.equal(dhm, again), f"seg ce {label} dhm differs between two runs")
    return err


def _seg_fwd_check(label: str, logits, target, a, taps, cw, ls: float) -> float:
    """The forward kernel's (loss_sum, n_valid) against ``seg_ce_fwd_plain``
    of ``h_interp``'s hmid (``a`` and ``taps`` serve A_h and A_w: the resize
    is square): the sum within 1e-6 relative (float32 terms over up to 2 M
    pixels summed in another order), the count exact, and the same bits on a
    rerun; returns the error of the mean, loss_sum / n_valid."""
    import torch

    from cvnets_tpu_torch.ops.seg_ce_kernel import h_interp, seg_ce_fwd_kernel, seg_ce_fwd_plain

    loss_sum, n_valid = seg_ce_fwd_kernel(logits, target, taps, taps, cw, 255, ls)
    again = seg_ce_fwd_kernel(logits, target, taps, taps, cw, 255, ls)
    ref_sum, ref_n = seg_ce_fwd_plain(h_interp(logits, a), a, target, cw, 255, ls)
    err = abs(loss_sum.item() - ref_sum.item())
    check(bool(torch.isfinite(loss_sum)) and err <= 1e-6 * abs(ref_sum.item()),
          f"seg ce {label} loss_sum {loss_sum.item()} against {ref_sum.item()}")
    check(n_valid.item() == ref_n.item(),
          f"seg ce {label} n_valid {n_valid.item()} against {ref_n.item()}")
    check(torch.equal(loss_sum, again[0]) and torch.equal(n_valid, again[1]),
          f"seg ce {label} (loss_sum, n_valid) differ between two runs")
    print(f"seg ce kernel: fwd {label} loss_sum {loss_sum.item():.6e} rel err "
          f"{err / abs(ref_sum.item()):.3e}, n_valid {int(n_valid.item())} exact, same bits "
          f"on a rerun", flush=True)
    return err / max(ref_n.item(), 1.0)


def phase_seg_ce_kernel(card: str) -> dict:
    """The fused resize + CE kernels against the plain unfused version at
    DeepLabv3's shapes; the forward's (loss_sum, n_valid) and the backward's
    dhm each against its plain version, under the four label-smoothing and
    class-weight cases, on spread logits (the forward's fallback) and at C
    21; returns {"fwd": record, "bwd": record}."""
    import torch

    from cvnets_tpu_torch.loss.base_criteria import BaseCriteria
    from cvnets_tpu_torch.ops.seg_ce import (
        fused_resize_ce,
        resize_ce_plain,
        resize_matrix,
        resize_taps,
    )
    from cvnets_tpu_torch.ops.seg_ce_kernel import (
        h_interp,
        seg_ce_bwd_kernel,
        seg_ce_bwd_plain,
        seg_ce_fwd_kernel,
        seg_ce_fwd_plain,
    )

    g = torch.Generator(device="cuda").manual_seed(2)
    logits32, target = seg_ce_inputs(g, SEG_C)
    wts = BaseCriteria._class_weights(torch.where(target == 255, 0, target), SEG_C)
    dev = logits32.device
    ah = resize_matrix(SEG_FULL, SEG_HEAD, dev)
    aw = resize_matrix(SEG_FULL, SEG_HEAD, dev)
    taps = resize_taps(SEG_FULL, SEG_HEAD, dev)
    records = _records("fwd", "bwd")
    with no_tf32():
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            for ls in (0.0, 0.1):
                for cw in (None, wts):
                    errs = {}
                    losses, grads = [], []
                    for fn in (fused_resize_ce, resize_ce_plain):
                        x = logits32.to(dtype, copy=True).requires_grad_()
                        loss = fn(x, target, label_smoothing=ls, class_wts=cw)
                        loss.backward()
                        losses.append(loss.detach().float())
                        grads.append(x.grad.float())
                    torch.cuda.synchronize()
                    check(all(bool(torch.isfinite(t).all()) for t in losses + grads),
                          f"seg ce {name} ls={ls} finite")
                    errs["loss"] = (losses[0] - losses[1]).abs().item()
                    errs["dlogits"] = (grads[0] - grads[1]).abs().max().item()
                    gmax = grads[1].abs().max().item()
                    # float32: sums over 1.9 M pixels and over C in other orders;
                    # bfloat16: both grads rounded to bf16 from nearly equal floats
                    check(errs["loss"] <= 1e-5 * losses[1].abs().item(),
                          f"seg ce {name} ls={ls} wts={cw is not None} loss err {errs['loss']}")
                    gtol = (1e-4 if dtype == torch.float32 else 2 ** -7) * gmax
                    check(errs["dlogits"] <= gtol, f"seg ce {name} ls={ls} "
                          f"wts={cw is not None} dlogits err {errs['dlogits']} > {gtol}")
                    records["bwd"]["max_abs_err"] = max(records["bwd"]["max_abs_err"],
                                                        errs["dlogits"])
                    times = ""
                    if dtype == torch.float32:
                        records["fwd"]["max_abs_err"] = max(
                            records["fwd"]["max_abs_err"], _seg_fwd_check(
                                f"C={SEG_C} ls={ls} class_wts={cw is not None}", logits32,
                                target, aw, taps, cw, ls))
                    if dtype == torch.float32 and ls == 0.0 and cw is None:  # the yaml's case
                        hmid = h_interp(logits32, ah)
                        errs["dhm"] = _seg_dhm_check(f"C={SEG_C}", hmid, target, aw, taps,
                                                     None, 0.0)
                        scale = torch.full((1,), 1e-6, device=dev)
                        t = {"fwd": time_ms(lambda: seg_ce_fwd_kernel(logits32, target, taps,
                                                                      taps, None, 255, 0.0)),
                             "fwd_plain": time_ms(lambda: seg_ce_fwd_plain(
                                 h_interp(logits32, ah), aw, target, None, 255, 0.0)),
                             "bwd": time_ms(lambda: seg_ce_bwd_kernel(hmid, target, taps, None,
                                                                      scale, 255, 0.0)),
                             "bwd_plain": time_ms(lambda: seg_ce_bwd_plain(
                                 hmid, aw, target, None, scale, 255, 0.0))}
                        bounds = seg_ce_bounds(logits32, target)
                        for p in ("fwd", "bwd"):
                            records[p]["ms"] = SEG_CALLS * t[p]
                            records[p]["plain_ms"] = SEG_CALLS * t[f"{p}_plain"]
                            records[p]["bound_ms"] = SEG_CALLS * bounds[p][0]
                            records[p]["bound_by"] = bounds[p][1]
                        times = f" dhm_err={errs['dhm']:.3e} (same bits on a rerun)" + "".join(
                            f" {k}_ms={v:.4f}" for k, v in t.items()) + "".join(
                            f" {p}_bound_ms={bounds[p][0]:.4f} ({bounds[p][1]})"
                            for p in ("fwd", "bwd"))
                    print(f"seg ce kernel: {name} B={SEG_B} h=w={SEG_HEAD} H=W={SEG_FULL} "
                          f"C={SEG_C} ls={ls} class_wts={cw is not None} loss_err="
                          f"{errs['loss']:.3e} dlogits_err={errs['dlogits']:.3e} "
                          f"(max |dlogits| {gmax:.3e}){times} | {card}", flush=True)
        # spread logits: the forward's two-pass fallback, ls 0 and 0.1 with
        # class weights
        logits_sp, target_sp = seg_ce_spread(g, SEG_C)
        hmid_sp = h_interp(logits_sp, ah)
        n_under = seg_ce_underflows(hmid_sp, aw, target_sp)
        check(n_under > 0, "seg ce spread logits send no pixel to the fallback")
        print(f"seg ce kernel: spread logits C={SEG_C}: {n_under} valid pixels under the "
              f"bound's reach (the fallback) | {card}", flush=True)
        for ls, cw in ((0.0, None), (0.1, wts)):
            records["fwd"]["max_abs_err"] = max(records["fwd"]["max_abs_err"], _seg_fwd_check(
                f"spread C={SEG_C} ls={ls} class_wts={cw is not None}", logits_sp, target_sp,
                aw, taps, cw, ls))
        del hmid_sp
        # C 21: the loss, dlogits, forward and dhm checks at f32, ls 0, no class
        # weights
        logits21, target21 = seg_ce_inputs(g, SEG_C_VOC)
        losses, grads = [], []
        for fn in (fused_resize_ce, resize_ce_plain):
            x = logits21.clone().requires_grad_()
            loss = fn(x, target21)
            loss.backward()
            losses.append(loss.detach())
            grads.append(x.grad)
        hmid21 = h_interp(logits21, ah)
        records["fwd"]["max_abs_err"] = max(records["fwd"]["max_abs_err"], _seg_fwd_check(
            f"C={SEG_C_VOC}", logits21, target21, aw, taps, None, 0.0))
        dhm_err = _seg_dhm_check(f"C={SEG_C_VOC}", hmid21, target21, aw, taps, None, 0.0)
        loss_err = (losses[0] - losses[1]).abs().item()
        dl_err = (grads[0] - grads[1]).abs().max().item()
        gmax = grads[1].abs().max().item()
        check(loss_err <= 1e-5 * losses[1].abs().item(), f"seg ce C={SEG_C_VOC} loss err")
        check(dl_err <= 1e-4 * gmax, f"seg ce C={SEG_C_VOC} dlogits err {dl_err}")
        scale = torch.full((1,), 1e-6, device=dev)
        fwd_ms = time_ms(lambda: seg_ce_fwd_kernel(logits21, target21, taps, taps, None, 255,
                                                   0.0))
        bwd_ms = time_ms(lambda: seg_ce_bwd_kernel(hmid21, target21, taps, None, scale, 255,
                                                   0.0))
        bound21 = seg_ce_bounds(logits21, target21)
        print(f"seg ce kernel: f32 B={SEG_B} h=w={SEG_HEAD} H=W={SEG_FULL} C={SEG_C_VOC} "
              f"ls=0.0 class_wts=False loss_err={loss_err:.3e} dlogits_err={dl_err:.3e} "
              f"(max |dlogits| {gmax:.3e}) dhm_err={dhm_err:.3e} (same bits on a rerun) "
              f"fwd_ms={fwd_ms:.4f} fwd_bound_ms={bound21['fwd'][0]:.4f} "
              f"({bound21['fwd'][1]}) bwd_ms={bwd_ms:.4f} bwd_bound_ms={bound21['bwd'][0]:.4f} "
              f"({bound21['bwd'][1]}) | {card}", flush=True)
    return records


def window_inputs(g, side: int, h: int, dtype, shifted: bool) -> tuple:
    """q, k, v (column thirds of one qkv tensor, as WindowAttention makes them,
    q scaled), the bias, the stage's real shift mask or None, and dO, at a
    Swin-T stage at batch SWIN_BATCH."""
    import torch

    from cvnets_tpu_torch.modules.swin_transformer_block import shifted_window_mask

    s, e = WIN * WIN, h * WIN_D
    bnw = SWIN_BATCH * (side // WIN) ** 2
    qkv = torch.randn((bnw, s, 3 * e), generator=g, device="cuda").to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)
    q = q * WIN_D ** -0.5
    bias = 0.5 * torch.randn((h, s, s), generator=g, device="cuda")
    mask = (torch.from_numpy(shifted_window_mask(side, side, WIN, WIN // 2)).cuda()
            if shifted else None)
    dout = torch.randn((bnw, s, e), generator=g, device="cuda").to(dtype)
    return q, k, v, bias, mask, dout


def window_bounds(q, h: int, mask) -> dict:
    """{"fwd", "bwd": bound(...)} of the window kernels on these inputs: each
    input read once, each output written once (dbias too); 2 products
    forward, 5 backward, one exponential a logit."""
    bnw, s, e = q.shape
    act = bnw * s * e * q.element_size()
    small = (h + (0 if mask is None else mask.shape[0])) * s * s * 4
    flops = 4 * bnw * s * s * e
    exps = (bnw * h * s * s, SFU_EXP_S)
    return {"fwd": bound(4 * act + small, (flops, BF16_TC_FLOP_S), exps),
            "bwd": bound(7 * act + small + h * s * s * 4, (2.5 * flops, BF16_TC_FLOP_S), exps)}


def window_sdpa(q, k, v, dout, h: int, bias, mask) -> tuple:
    """The library yardstick: SDPA on (B·nW, H, S, D) copies with the bias
    (plus the mask) as a float attn_mask; (forward, backward) callables, the
    backward giving dq, dk and dv, not dbias."""
    import torch
    import torch.nn.functional as F

    bnw, s, e = q.shape
    qh, kh, vh, dh = (t_.detach().reshape(bnw, s, h, e // h).transpose(1, 2)
                      .contiguous().requires_grad_() for t_ in (q, k, v, dout))
    if mask is None:
        am = bias[None]
    else:
        nw = mask.shape[0]
        am = (bias[None, None] + mask[None, :, None]).expand(
            bnw // nw, nw, h, s, s).reshape(bnw, h, s, s)
    am = am.to(q.dtype)
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am, scale=1.0)
    return (lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=am, scale=1.0),
            lambda: torch.autograd.grad(lib_out, (qh, kh, vh), dh, retain_graph=True))


def phase_window_kernel(card: str) -> dict:
    """The window-attention kernels against their plain versions at Swin-T's
    stage shapes; returns {"fwd": record, "bwd": record} summed over one step's
    12 blocks (bf16, unshifted and shifted blocks at their own times). The bf16
    kernels prefetch the next window by cp.async, build every fragment by
    ldmatrix and take exp2 (csrc/window_attention.cu's head comment); each
    bf16 line ends with the forward's and the backward's time over its bound
    (``fwd/bound``, ``bwd/bound``) and over SDPA's (``fwd/library``,
    ``bwd/library``)."""
    import torch

    from cvnets_tpu_torch.ops.window_attention import (
        window_attention_backward_plain,
        window_attention_plain,
        window_bwd_kernel,
        window_fwd_kernel,
    )

    g = torch.Generator(device="cuda").manual_seed(3)
    records = _records("fwd", "bwd")
    records["fwd"]["library_ms"] = records["bwd"]["library_ms"] = 0.0
    s = WIN * WIN
    with no_tf32():
        for label, side, h, n_plain, n_shift in SWIN_STAGES:
            bnw = SWIN_BATCH * (side // WIN) ** 2
            for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                for shifted in (False, True):
                    if shifted and not n_shift:
                        continue
                    q, k, v, bias, mask, dout = window_inputs(g, side, h, dtype, shifted)
                    out = window_fwd_kernel(q, k, v, h, bias, mask)
                    grads = window_bwd_kernel(q, k, v, h, bias, mask, dout)
                    again = window_bwd_kernel(q, k, v, h, bias, mask, dout)[3]
                    torch.cuda.synchronize()
                    check(torch.equal(grads[3], again), f"window {label} {name} dbias differs "
                                                        f"between two runs")
                    ref = window_attention_plain(q, k, v, h, bias, mask)
                    ref_grads = window_attention_backward_plain(q, k, v, h, bias, mask, ref,
                                                                dout)
                    errs = {}
                    for what, got, want in zip(("out", "dq", "dk", "dv", "dbias"),
                                               (out, *grads), (ref, *ref_grads)):
                        check(bool(torch.isfinite(got).all()), f"window {label} {what} finite")
                        err = (got.float() - want.float()).abs().max().item()
                        big = want.float().abs().max().item()
                        # float32: the same math in another order (dbias sums
                        # B·nW windows, so relative to its size); bf16: P and dS
                        # rounded to bf16 before their products, outputs rounded
                        if dtype == torch.float32:
                            tol = {"out": 1e-5, "dbias": 1e-5 * max(1.0, big)}.get(what, 1e-4)
                        else:
                            tol = 2e-2 * big
                        check(err <= tol, f"window {label} {name} shift={shifted} {what} "
                                          f"err {err} > {tol}")
                        errs[what] = err
                    if dtype == torch.bfloat16:
                        records["fwd"]["max_abs_err"] = max(records["fwd"]["max_abs_err"],
                                                            errs["out"])
                        records["bwd"]["max_abs_err"] = max(
                            records["bwd"]["max_abs_err"],
                            *(errs[w] for w in ("dq", "dk", "dv", "dbias")))
                    times = ""
                    if dtype == torch.bfloat16:
                        t = {"fwd": time_ms(lambda: window_fwd_kernel(q, k, v, h, bias, mask)),
                             "fwd_plain": time_ms(lambda: window_attention_plain(
                                 q, k, v, h, bias, mask)),
                             "bwd": time_ms(lambda: window_bwd_kernel(q, k, v, h, bias, mask,
                                                                      dout)),
                             "bwd_plain": time_ms(lambda: window_attention_backward_plain(
                                 q, k, v, h, bias, mask, ref, dout))}
                        lib_fwd, lib_bwd = window_sdpa(q, k, v, dout, h, bias, mask)
                        t["lib_fwd"] = time_ms(lib_fwd)
                        t["lib_bwd"] = time_ms(lib_bwd)
                        bounds = window_bounds(q, h, mask)
                        n_blocks = n_shift if shifted else n_plain
                        for p in ("fwd", "bwd"):
                            records[p]["ms"] += n_blocks * t[p]
                            records[p]["plain_ms"] += n_blocks * t[f"{p}_plain"]
                            records[p]["bound_ms"] += n_blocks * bounds[p][0]
                            records[p]["bound_by"] = bounds[p][1]
                            records[p]["library_ms"] += n_blocks * t[f"lib_{p}"]
                        times = "".join(f" {k_}_ms={v_:.4f}" for k_, v_ in t.items()) + "".join(
                            f" {p}_bound_ms={bounds[p][0]:.4f} ({bounds[p][1]})"
                            for p in ("fwd", "bwd")) + "".join(
                            f" {p}/bound={t[p] / bounds[p][0]:.3f}"
                            f" {p}/library={t[p] / t[f'lib_{p}']:.3f}" for p in ("fwd", "bwd"))
                        del lib_fwd, lib_bwd
                    print(f"window kernel: {label} {name} BnW={bnw} S={s} H={h} D={WIN_D} "
                          f"shift={shifted} " + " ".join(f"{w}_err={x:.3e}"
                                                         for w, x in errs.items())
                          + times + f" | {card}", flush=True)
    return records


def phase_mha_long_kernel(card: str) -> dict:
    """The MHA kernels at S = 1024 and 4096; returns {"fwd", "dq", "dkdv"}
    records for one ViT-B 512² step's 12 launches. The wrapper's backward runs
    a pre-pass (the statistics scaled and delta), a dQ kernel and a dK/dV
    kernel: its event-timed total is split between them by their device times
    in ``torch.profiler``, the pre-pass counting in the dQ row. The whole
    backward's bound, plain and library times are split between the two rows
    by the gradients each writes (``BWD_ROW_SHARE``), so that the rows add up
    to the whole backward and nothing is counted twice; the printed line
    carries the whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel

    g = torch.Generator(device="cuda").manual_seed(4)
    records = _records("fwd", "dq", "dkdv")
    with no_tf32():
        for label, b, s, h, d in MHA_LONG_CASES:
            e = h * d
            for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
                for masked in (False, True):
                    q, k, v, mask, dout, out, stats, ref, errs = _mha_case(
                        g, f"{label} {name} mask={masked}", b, s, h, d, dtype, masked)
                    if dtype == torch.bfloat16:
                        records["fwd"]["max_abs_err"] = max(records["fwd"]["max_abs_err"],
                                                            errs["out"])
                        for p in ("dq", "dkdv"):
                            records[p]["max_abs_err"] = max(
                                records[p]["max_abs_err"],
                                *(errs[w] for w in (("dq",) if p == "dq" else ("dk", "dv"))))
                    times = ""
                    if label == MHA_LONG_CASES[0][0] and dtype == torch.bfloat16 and not masked:
                        t = _mha_times(b, s, h, d, q, k, v, dout, out, stats, ref)
                        with profile(activities=[ProfilerActivity.CUDA]) as prof:
                            for _ in range(5):
                                mha_bwd_kernel(q, k, v, None, out, dout, stats, h)
                            torch.cuda.synchronize()
                        dev = {"prep": 0.0, "dq": 0.0, "dkdv": 0.0}
                        for ev in prof.key_averages():
                            for p in dev:
                                if f"mha_bwd_{p}_" in ev.key:
                                    dev[p] += ev.self_device_time_total
                        check(all(v_ > 0 for v_ in dev.values()),
                              f"profiler saw the backward kernels: {dev}")
                        share = {p: dev[p] / sum(dev.values()) for p in dev}
                        bounds = mha_bounds(b, s, h, d, q.element_size(), BF16_TC_FLOP_S)
                        kernel_ms = {"fwd": t["fwd"],
                                     "dq": (share["prep"] + share["dq"]) * t["bwd"],
                                     "dkdv": share["dkdv"] * t["bwd"]}
                        for p in ("fwd", "dq", "dkdv"):
                            src = "fwd" if p == "fwd" else "bwd"
                            scale = VIT_BLOCKS * BWD_ROW_SHARE.get(p, 1.0)
                            records[p]["ms"] = VIT_BLOCKS * kernel_ms[p]
                            records[p]["plain_ms"] = scale * t[f"{src}_plain"]
                            records[p]["bound_ms"] = scale * bounds[src][0]
                            records[p]["bound_by"] = bounds[src][1]
                            _mha_library(records[p], t, src, scale)
                        times = (" " + _mha_times_line(t, bounds, 4 * b * s * s * e)
                                 + " | bwd split: " + " ".join(
                                     f"{p}_ms={share[p] * t['bwd']:.4f} ({100 * share[p]:.1f}%)"
                                     for p in share))
                    print(f"mha long kernel: {label} {name} B={b} S={s} H={h} D={d} "
                          f"mask={masked} " + " ".join(f"{w}_err={x:.3e}"
                                                       for w, x in errs.items())
                          + times + f" | {card}", flush=True)
                    del out, stats, ref
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
    category = getattr(opts, "dataset.category")
    batch = getattr(opts, "dataset.train_batch_size0")
    hw = (getattr(opts, "sampler.bs.crop_size_height"),
          getattr(opts, "sampler.bs.crop_size_width"))
    model = get_model(opts)  # on the card
    state = create_train_state(
        model, build_optimizer(opts, model, model.get_lr_multipliers(opts)),
        ema_enabled=getattr(opts, "ema.enable"))
    criteria = build_loss_fn(opts)
    train_step = make_train_step(model, criteria, opts)
    scheduler = build_scheduler(opts)
    n_classes = getattr(opts, f"model.{category}.n_classes")
    g = torch.Generator(device=device).manual_seed(getattr(opts, "common.seed"))

    def targets():
        if category == "classification":
            return torch.randint(0, n_classes, (batch,), generator=g, device=device)
        # per-pixel labels with 5% ignored, as bench_tasks.py:128-130 makes them
        t = torch.randint(0, n_classes, (batch, *hw), generator=g, device=device)
        t[torch.rand(t.shape, generator=g, device=device) < 0.05] = 255
        return t

    batches = [{"samples": torch.randint(0, 256, (batch, 3, *hw), generator=g,
                                         device=device, dtype=torch.uint8),
                "targets": targets()}
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
        losses.append({k: v.item() for k, v in metrics.items()})
    launches = {name: kernel.launches for name, kernel in kernels.items()}

    n_steps = len(batches)
    for name, count in launches.items():
        check(count == per_step[name] * n_steps,
              f"{label}: {count} {name} launches in {n_steps} steps, "
              f"want {per_step[name]} a step")
    # the loss and, for segmentation, its seg and aux parts, and the grad norm
    check(all(math.isfinite(v) for m in losses for v in m.values()),
          f"{label}: losses not finite: {losses}")
    parts = {k: [round(m[k], 4) for m in losses] for k in losses[0] if k != "total_loss"}
    check(any(not torch.equal(a, b) for a, b in zip(params0, model.parameters())),
          f"{label}: params did not change")
    check(any(not torch.equal(a, b) for a, b in zip(
        ema0, state.ema.model.state_dict().values())), f"{label}: EMA did not change")
    del params0, ema0
    timed = step_s[WARMUP_STEPS:]
    img_s = batch * len(timed) / sum(timed)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"train: {label} batch={batch} {hw[0]}x{hw[1]} bf16 steps={n_steps} "
          f"losses={parts} step_s={[round(x, 4) for x in step_s]} "
          f"img_s={img_s:.1f} peak_mem_gib={peak_gib:.2f} launches={launches} "
          f"| {card}", flush=True)

    # reference: the trained model's logits through the kernels and through the
    # plain attention path (float32, eval mode, TF32 off), on a small batch
    x = batches[0]["samples"][:8 if category == "classification" else 2].float() / 255.0
    model.eval()
    with no_tf32(), torch.no_grad():
        with_kernel = model(x)
        set_use_kernel(model, False)
        plain = model(x)
    set_use_kernel(model, True)
    diff = (with_kernel - plain).abs().max().item()
    scale = plain.abs().max().item()
    want = (x.shape[0], n_classes) + (() if category == "classification" else hw)
    check(with_kernel.shape == want and bool(torch.isfinite(with_kernel).all()),
          f"{label}: logits shape or finiteness")
    check(diff <= 1e-4 * max(1.0, scale), f"{label}: kernel vs plain logits differ by {diff}")
    print(f"reference: {label} kernel-path vs plain-path logits max diff {diff:.3e} "
          f"(max |logit| {scale:.3e})", flush=True)
    if category == "segmentation":
        # the loss through the seg-CE kernels and through the plain unfused CE, on
        # the same train-mode (head-resolution) outputs of the whole batch
        model.train()
        with no_tf32(), torch.no_grad():
            out = model(batches[0]["samples"].float() / 255.0)
            both = []
            for on in (True, False):
                set_use_kernel(model, on, criteria)
                both.append(criteria(None, out, batches[0]["targets"]))
        set_use_kernel(model, True, criteria)
        for key in both[0]:
            got, ref = both[0][key].item(), both[1][key].item()
            check(abs(got - ref) <= 1e-5 * abs(ref), f"{label}: {key} kernel {got} vs "
                                                     f"plain {ref}")
        print(f"reference: {label} kernel-path vs plain-path loss " + " ".join(
            f"{k}={both[0][k].item():.7f}/{both[1][k].item():.7f}" for k in both[0]),
            flush=True)
    return launches, (state, train_step, scheduler, batches, criteria)


def phase_ab(card: str, label: str, run) -> None:
    """Whole train steps through the kernels against the plain path (attention
    and, for segmentation, the unfused CE), in alternating blocks (plain,
    kernel, kernel, plain) in this one run. Beside each median step time, the
    median time until ``train_step`` returns: where it nears the step time,
    the host's launches, not the card, set the pace."""
    import torch

    state, train_step, scheduler, batches, criteria = run
    model = state.model
    times = {"plain": [], "kernel": []}
    host = {"plain": [], "kernel": []}  # until train_step returns: the host's enqueue
    peak = {"plain": 0, "kernel": 0}
    set_use_kernel(model, False, criteria)
    train_step(state, batches[0], scheduler.retrieve_lr(0, state.step))  # plain warm-up
    for mode in AB_BLOCKS:
        set_use_kernel(model, mode == "kernel", criteria)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(AB_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(state, batches[i % len(batches)], scheduler.retrieve_lr(0, state.step))
            host[mode].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            times[mode].append(time.perf_counter() - t0)
        peak[mode] = max(peak[mode], torch.cuda.max_memory_allocated())
    set_use_kernel(model, True, criteria)
    batch = batches[0]["samples"].shape[0]
    parts = []
    for mode, ts in times.items():
        ms = 1e3 * statistics.median(ts)
        q1, _, q3 = statistics.quantiles(ts, n=4)
        parts.append(f"{mode}_ms={ms:.3f} (q1 {1e3 * q1:.3f}, q3 {1e3 * q3:.3f}; "
                     f"{batch / ms * 1e3:.1f} img/s; peak {peak[mode] / 2**30:.2f} GiB; "
                     f"host enqueue {1e3 * statistics.median(host[mode]):.3f} ms)")
    ratio = statistics.median(times["kernel"]) / statistics.median(times["plain"])
    print(f"a/b: {label} {len(AB_BLOCKS)} blocks of {AB_STEPS} steps, "
          f"medians: {'; '.join(parts)}; kernel/plain={ratio:.4f} | {card}", flush=True)


def phase_profile(card: str, label: str, run, path: str) -> None:
    """torch.profiler over 3 steps: device time by kernel into ``path``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    state, train_step, scheduler, batches, _ = run
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


def phase_deeplab(card: str) -> dict:
    """DeepLabv3's train, a/b and profile phases; returns the launch counts."""
    from cvnets_tpu_torch.ops.seg_ce_kernel import seg_ce_bwd_kernel, seg_ce_fwd_kernel
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_bwd_kernel,
        separable_attention_kernel,
    )

    sep = {"separable_attention": separable_attention_kernel,
           "separable_attention_bwd": separable_attention_bwd_kernel}
    launches, run = phase_train(
        card, "DeepLabv3-MobileViTv2-1.0", DEEPLAB_ARGS,
        {"seg_ce_fwd": seg_ce_fwd_kernel, "seg_ce_bwd": seg_ce_bwd_kernel, **sep},
        {"seg_ce_fwd": SEG_CALLS, "seg_ce_bwd": SEG_CALLS,
         **{name: sum(SEP_DEEPLAB[1].values()) for name in sep}})
    phase_ab(card, "DeepLabv3-MobileViTv2-1.0", run)
    phase_profile(card, "DeepLabv3-MobileViTv2-1.0", run,
                  os.path.join("results", "deeplab_profile.txt"))
    return launches


def main(argv) -> int:
    import torch

    if argv not in ([], ["--deeplab"]):
        print(f"chip_smoke: unknown arguments {argv}; usage: chip_smoke.py [--deeplab]",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import cvnets_tpu_torch  # noqa: F401  (fails here, before any output, outside the repo)
    from cvnets_tpu_torch.ops.mha_attention import mha_bwd_kernel, mha_fwd_kernel
    from cvnets_tpu_torch.ops.separable_attention import (
        separable_attention_bwd_kernel,
        separable_attention_kernel,
    )
    from cvnets_tpu_torch.ops.window_attention import window_bwd_kernel, window_fwd_kernel

    def release() -> None:  # each phase's peak memory is its own
        gc.collect()
        torch.cuda.empty_cache()

    card = phase_device()
    if argv:
        phase_deeplab(card)
        return 0
    phase_build()
    sep_records = phase_kernel(card)
    mha_records = phase_mha_kernel(card)
    seg_records = phase_seg_ce_kernel(card)
    win_records = phase_window_kernel(card)
    release()
    mha_long_records = phase_mha_long_kernel(card)
    release()
    sep_kernels = {"separable_attention": separable_attention_kernel,
                   "separable_attention_bwd": separable_attention_bwd_kernel}
    sep_launches, run = phase_train(card, "MobileViTv2-1.0", FLAGSHIP_ARGS, sep_kernels,
                                    {name: sum(SEP_FLAGSHIP[1].values()) for name in sep_kernels})
    phase_ab(card, "MobileViTv2-1.0", run)
    phase_profile(card, "MobileViTv2-1.0", run,
                  os.path.join("results", "mobilevit_profile.txt"))
    run = None
    release()
    vit_launches, run = phase_train(
        card, "ViT-B/16", VIT_ARGS,
        {"mha_attention_fwd": mha_fwd_kernel, "mha_attention_bwd": mha_bwd_kernel},
        {"mha_attention_fwd": VIT_BLOCKS, "mha_attention_bwd": VIT_BLOCKS})
    phase_ab(card, "ViT-B/16", run)
    phase_profile(card, "ViT-B/16", run, os.path.join("results", "vit_profile.txt"))
    run = None
    release()
    seg_launches = phase_deeplab(card)
    release()
    win_kernels = {"window_attention_fwd": window_fwd_kernel,
                   "window_attention_bwd": window_bwd_kernel}
    swin_launches, run = phase_train(card, "Swin-T", SWIN_ARGS, win_kernels,
                                     {name: SWIN_BLOCKS for name in win_kernels})
    phase_ab(card, "Swin-T", run)
    phase_profile(card, "Swin-T", run, os.path.join("results", "swin_profile.txt"))
    run = None
    release()
    vit_long_launches, run = phase_train(
        card, "ViT-B/16 512² no CLS", VIT_LONG_ARGS,
        {"mha_attention_fwd": mha_fwd_kernel, "mha_attention_bwd": mha_bwd_kernel},
        {"mha_attention_fwd": VIT_BLOCKS, "mha_attention_bwd": VIT_BLOCKS})
    vit = run[0].model
    with torch.no_grad():  # every one of those launches saw S = 1024 tokens
        stem = vit.patch_emb_2(vit.patch_emb_1(vit.patch_emb_0(
            torch.zeros((1, 3, 512, 512), device="cuda"))))
    check(stem.shape[-2] * stem.shape[-1] == 1024 and not vit.use_cls_token,
          f"ViT-B/16 512²: {stem.shape[-2] * stem.shape[-1]} tokens")
    phase_ab(card, "ViT-B/16 512² no CLS", run)
    phase_profile(card, "ViT-B/16 512² no CLS", run,
                  os.path.join("results", "vit_long_profile.txt"))
    run = vit = None
    release()

    def entry(name, source, replaces, launches, record):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, **record}

    print(json.dumps({"kernels": [
        entry("separable_attention", "cvnets_tpu_torch/csrc/separable_attention.cu",
              "cvnets_tpu/ops/pallas/mobilevit_attn.py:44",
              sep_launches["separable_attention"], sep_records["fwd"]),
        entry("separable_attention_bwd", "cvnets_tpu_torch/csrc/separable_attention.cu",
              "cvnets_tpu/ops/pallas/mobilevit_attn.py:120",
              sep_launches["separable_attention_bwd"], sep_records["bwd"]),
        entry("mha_attention_fwd", "cvnets_tpu_torch/csrc/mha_attention.cu",
              "cvnets_tpu/ops/pallas/mha_attn.py:134",
              vit_launches["mha_attention_fwd"], mha_records["fwd"]),
        entry("mha_attention_bwd", "cvnets_tpu_torch/csrc/mha_attention.cu",
              "cvnets_tpu/ops/pallas/mha_attn.py:153",
              vit_launches["mha_attention_bwd"], mha_records["bwd"]),
        entry("seg_ce_fwd", "cvnets_tpu_torch/csrc/seg_ce.cu",
              "cvnets_tpu/ops/pallas/seg_ce_kernel.py:159",
              seg_launches["seg_ce_fwd"], seg_records["fwd"]),
        entry("seg_ce_bwd", "cvnets_tpu_torch/csrc/seg_ce.cu",
              "cvnets_tpu/ops/pallas/seg_ce_kernel.py:200",
              seg_launches["seg_ce_bwd"], seg_records["bwd"]),
        entry("mha_attention_fwd_long", "cvnets_tpu_torch/csrc/mha_attention.cu",
              "cvnets_tpu/ops/pallas/mha_attn_long.py:142",
              vit_long_launches["mha_attention_fwd"], mha_long_records["fwd"]),
        entry("mha_attention_bwd_long_dq", "cvnets_tpu_torch/csrc/mha_attention.cu",
              "cvnets_tpu/ops/pallas/mha_attn_long.py:257",
              vit_long_launches["mha_attention_bwd"], mha_long_records["dq"]),
        entry("mha_attention_bwd_long_dkdv", "cvnets_tpu_torch/csrc/mha_attention.cu",
              "cvnets_tpu/ops/pallas/mha_attn_long.py:279",
              vit_long_launches["mha_attention_bwd"], mha_long_records["dkdv"]),
        entry("window_attention_fwd", "cvnets_tpu_torch/csrc/window_attention.cu",
              "cvnets_tpu/ops/pallas/window_attn.py:279",
              swin_launches["window_attention_fwd"], win_records["fwd"]),
        entry("window_attention_bwd", "cvnets_tpu_torch/csrc/window_attention.cu",
              "cvnets_tpu/ops/pallas/window_attn.py:300",
              swin_launches["window_attention_bwd"], win_records["bwd"]),
    ]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
