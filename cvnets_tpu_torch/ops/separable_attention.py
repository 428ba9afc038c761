"""MobileViTv2 separable self-attention core (counterpart of
cvnets_tpu/ops/pallas/mobilevit_attn.py).

Shapes: q (BP, N, 1), k and v (BP, N, C), where BP = batch·patch_area.

* ``separable_attention_kernel``: the hand-written CUDA kernel
  (csrc/separable_attention.cu) that replaces the Pallas ``_attn_kernel``. It
  takes CUDA tensors only and counts its launches.
* ``separable_attention_plain``: the same function in plain torch ops, for CPU
  tensors and as the kernel's reference.
* ``separable_attention_eligible``: the token counts the kernel takes.
* ``SeparableAttention``: the autograd Function. Forward is the kernel on a
  CUDA tensor and the plain version on a CPU tensor; backward is plain torch
  ops, as the JAX package's ``_bwd`` (mobilevit_attn.py:120-134) is plain XLA.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from cvnets_tpu_torch.ops.cuda_build import KernelEntry

# bytes of shared memory a block may use without opting in to more
_DEFAULT_SMEM = 48 * 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def separable_attention_eligible(n: int) -> bool:
    """What the kernel takes: N tokens whose softmax row and 32 floats of
    scratch fit the 48 KB of shared memory a block has without opting in
    ((N + 32)·4 bytes, N ≤ 12,256). The JAX package's non-TPU route computes
    any N; ``LinearSelfAttention`` sends every other N to its plain branch."""
    return (n + 32) * 4 <= _DEFAULT_SMEM


def separable_attention_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor) -> torch.Tensor:
    """Softmax over tokens, context, relu(v)·context, all in float32 as the
    Pallas body computes it (mobilevit_attn.py:32-41); output in v's dtype.
    (The JAX ``_reference_forward`` instead rounds the scores to q's dtype
    before the context sum; under float32 the two agree.)"""
    s = torch.softmax(q.float(), dim=1)
    ctx = (k.float() * s).sum(dim=1, keepdim=True)
    return (torch.relu(v.float()) * ctx).to(v.dtype)


def separable_attention_backward(q, k, v, g) -> Tuple[torch.Tensor, ...]:
    """The VJP of mobilevit_attn.py:120-134, in float32; grads in input dtypes."""
    g = g.float()
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.softmax(qf, dim=1)                       # (BP, N, 1)
    ctx = (kf * s).sum(dim=1, keepdim=True)            # (BP, 1, C)
    dv = g * ctx * (vf > 0)
    dctx = (g * torch.relu(vf)).sum(dim=1, keepdim=True)
    dk = s * dctx
    ds = (dctx * kf).sum(dim=-1, keepdim=True)         # (BP, N, 1)
    dq = s * (ds - (s * ds).sum(dim=1, keepdim=True))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class SeparableAttentionKernel(KernelEntry):
    """The CUDA kernel's wrapper: checks its inputs, then launches it."""

    def __init__(self) -> None:
        super().__init__("separable_attention.cu", "separable_attention_forward",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                         + [ctypes.c_longlong] * 6 + [ctypes.c_int])

    def __call__(self, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
        bp, n, c = k.shape
        for name, t, width in (("q", q, 1), ("k", k, c), ("v", v, c)):
            if t.device.type != "cuda" or t.device != k.device:
                raise ValueError(f"{name} must be on k's CUDA device; got {t.device}")
            if t.dtype not in _DTYPE_CODE or t.dtype != k.dtype:
                raise TypeError(f"{name}: dtype {t.dtype}; the kernel takes float32 "
                                f"or bfloat16, the same for q, k and v")
            if t.shape != (bp, n, width):
                raise ValueError(f"{name}: shape {tuple(t.shape)}, want {(bp, n, width)}")
            if width > 1 and t.stride(-1) != 1:
                raise ValueError(f"{name}: the channel dim must be contiguous; "
                                 f"strides {t.stride()}")
        if not separable_attention_eligible(n):
            raise ValueError(f"N={n} tokens exceed the kernel's shared memory")
        out = torch.empty((bp, n, c), dtype=v.dtype, device=v.device)
        if out.numel() == 0:
            return out
        self.launch(k.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    bp, n, c, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                    v.stride(0), v.stride(1), _DTYPE_CODE[k.dtype])
        return out


separable_attention_kernel = SeparableAttentionKernel()


class SeparableAttention(torch.autograd.Function):
    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v):
        ctx.save_for_backward(q, k, v)
        if k.device.type == "cpu":
            return separable_attention_plain(q, k, v)
        return separable_attention_kernel(q, k, v)

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        return separable_attention_backward(*ctx.saved_tensors, g)


def separable_attention_bphw(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """(B, P, N, ·) wrapper used by LinearSelfAttention; q, k and v may be
    column slices of one qkv tensor (no copy is made)."""
    b, p, n, c = v.shape
    out = SeparableAttention.apply(
        q.reshape(b * p, n, 1), k.reshape(b * p, n, c), v.reshape(b * p, n, c))
    return out.reshape(b, p, n, c)
