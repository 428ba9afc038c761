"""MobileViTv2 separable self-attention core (counterpart of
cvnets_tpu/ops/pallas/mobilevit_attn.py).

Shapes: q (BP, N, 1), k and v (BP, N, C), where BP = batch·patch_area; on the
main path all three are column views of one qkv tensor (BP, N, 1 + 2C).

* ``separable_attention_kernel``: the hand-written CUDA forward
  (csrc/separable_attention.cu) that replaces the Pallas ``_attn_kernel``; it
  also writes the softmax's max and sum and ctx in float32 for the backward.
* ``separable_attention_bwd_kernel``: the CUDA backward, the JAX package's
  ``_bwd`` (mobilevit_attn.py:120-134, plain XLA there) in one kernel, reading
  the forward's statistics; it writes dq, dk and dv, column views of one dqkv
  on the main path. Both take CUDA tensors only and count their launches.
* ``separable_attention_plain`` and ``separable_attention_backward``: the
  same functions in plain torch ops, for CPU tensors and as the kernels'
  references.
* ``separable_attention_eligible``: the widths the kernels take.
* ``separable_attention_fwd`` (``torch.ops.cvnets_tpu_torch.separable_attention_fwd``):
  the inference forward as a custom op, so that ``torch.export`` records it
  as one node: the forward kernel on a CUDA tensor, the plain version (with
  the same saved statistics) on a CPU tensor, and a fake that gives the
  shapes (a meta tensor outside fake mode goes to the wrapper, which raises
  as on any device but a card). A program exported through it loads where
  ``cvnets_tpu_torch`` is imported.
* ``SeparableAttention``: the autograd Function on qkv, its forward the op,
  its backward the backward kernel on a CUDA tensor and the plain version on
  a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from cvnets_tpu_torch.ops.cuda_build import KernelEntry

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# channels a lane of the kernels reads at once, and the most two such groups
# a lane of 32 cover
_VEC, _MAX_C = 8, 512


def separable_attention_eligible(c: int) -> bool:
    """What the kernels take: C a multiple of 8 up to 512 (every MobileViTv2
    width up to a width multiplier of 2.0), any N. The JAX package's non-TPU
    route computes any C; ``LinearSelfAttention`` sends every other C to its
    plain branch."""
    return 0 < c <= _MAX_C and c % _VEC == 0


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


def _check(names: str, views: Sequence[torch.Tensor], c: int) -> None:
    """Raise on what the kernels do not take: every tensor on the first's CUDA
    device, one dtype (float32 or bfloat16), shape (BP, N, 1) for the q-like
    (names "q", "dq") and (BP, N, C) for the rest, the channel dim contiguous."""
    bp, n = views[0].shape[:2]
    device, dtype = views[0].device, views[0].dtype
    for name, t in zip(names.split(), views):
        width = 1 if name in ("q", "dq") else c
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name} must be on one CUDA device; got {t.device}")
        if t.dtype not in _DTYPE_CODE or t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}; the kernels take float32 "
                            f"or bfloat16, the same for every tensor")
        if t.shape != (bp, n, width):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {(bp, n, width)}")
        if width > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: the channel dim must be contiguous; "
                             f"strides {t.stride()}")
    if not separable_attention_eligible(c):
        raise ValueError(f"C={c}: the kernels take a multiple of {_VEC} up to {_MAX_C}")


def _pointers(views: Sequence[torch.Tensor]) -> tuple:
    """The C entry points' ptrs and (row, token) strides arrays."""
    ptrs = (ctypes.c_void_p * len(views))(*(t.data_ptr() for t in views))
    strides = (ctypes.c_longlong * (2 * len(views)))(*(s for t in views for s in t.stride()[:2]))
    return ptrs, strides


_ARGTYPES = ([ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
              ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 4)


class SeparableAttentionKernel(KernelEntry):
    """The forward kernel's wrapper: checks its inputs, then launches it.
    Returns the output (BP, N, C) in v's dtype and, for the backward, the
    softmax's max and sum (BP, 2) and ctx (BP, C) in float32."""

    def __init__(self) -> None:
        super().__init__("separable_attention.cu", "separable_attention_forward", _ARGTYPES)

    def __call__(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
        bp, n, c = k.shape
        _check("q k v", (q, k, v), c)
        out = torch.empty((bp, n, c), dtype=v.dtype, device=v.device)
        stats = torch.empty((bp, 2), dtype=torch.float32, device=v.device)
        ctx = torch.empty((bp, c), dtype=torch.float32, device=v.device)
        if out.numel() == 0:
            return out, stats, ctx
        self.launch(k.device, *_pointers((q, k, v, out)), stats.data_ptr(), ctx.data_ptr(),
                    bp, n, c, _DTYPE_CODE[k.dtype])
        return out, stats, ctx


class SeparableAttentionBackwardKernel(KernelEntry):
    """The backward kernel's wrapper: checks its inputs, then launches it to
    write dq, dk and dv from g and the forward's ``stats`` and ``ctx``."""

    def __init__(self) -> None:
        super().__init__("separable_attention.cu", "separable_attention_backward", _ARGTYPES)

    def __call__(self, q, k, v, g, stats, ctx, dq, dk, dv) -> None:
        bp, n, c = k.shape
        views = (q, k, v, g, dq, dk, dv)
        _check("q k v g dq dk dv", views, c)
        for name, t, shape in (("stats", stats, (bp, 2)), ("ctx", ctx, (bp, c))):
            if (t.dtype != torch.float32 or t.shape != shape or not t.is_contiguous()
                    or t.device != k.device):
                raise ValueError(f"{name}: the forward's float32 {shape} on {k.device}")
        if k.numel() == 0:
            return
        self.launch(k.device, *_pointers(views), stats.data_ptr(), ctx.data_ptr(),
                    bp, n, c, _DTYPE_CODE[k.dtype])


separable_attention_kernel = SeparableAttentionKernel()
separable_attention_bwd_kernel = SeparableAttentionBackwardKernel()


@torch.library.custom_op("cvnets_tpu_torch::separable_attention_fwd", mutates_args=(),
                         device_types="cuda")
def separable_attention_fwd(qkv: torch.Tensor, c: int) -> List[torch.Tensor]:
    """The forward kernel on qkv (BP, N, 1 + 2C): [out (BP, N, C), the
    softmax's (max, sum) (BP, 2) and ctx (BP, C) in float32]."""
    return list(separable_attention_kernel(*qkv.split([1, c, c], dim=-1)))


@separable_attention_fwd.register_kernel("cpu")
def _separable_attention_fwd_cpu(qkv: torch.Tensor, c: int) -> List[torch.Tensor]:
    q, k, v = qkv.split([1, c, c], dim=-1)
    qf = q.float()
    m = qf.amax(dim=1)                                             # (BP, 1)
    total = torch.exp(qf - m[:, None]).sum(dim=1)                  # (BP, 1)
    ctx = (k.float() * torch.softmax(qf, dim=1)).sum(dim=1)        # (BP, C)
    return [separable_attention_plain(q, k, v), torch.cat([m, total], dim=1), ctx]


@separable_attention_fwd.register_fake
def _separable_attention_fwd_fake(qkv: torch.Tensor, c: int) -> List[torch.Tensor]:
    if qkv.device.type == "meta":  # a real meta tensor, not a fake one: no kernel runs there
        return list(separable_attention_kernel(*qkv.split([1, c, c], dim=-1)))
    bp, n = qkv.shape[:2]
    return [qkv.new_empty((bp, n, c)), qkv.new_empty((bp, 2), dtype=torch.float32),
            qkv.new_empty((bp, c), dtype=torch.float32)]


class SeparableAttention(torch.autograd.Function):
    """The core on one qkv tensor (BP, N, 1 + 2C), as the qkv projection makes
    it; q, k and v are its column views, and the backward writes one dqkv, so
    autograd has no dq, dk and dv to concatenate."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, qkv, c):
        ctx.c = c
        out, stats, context = separable_attention_fwd(qkv, c)
        ctx.save_for_backward(qkv, stats, context)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        qkv, *saved = ctx.saved_tensors
        c = ctx.c
        q, k, v = qkv.split([1, c, c], dim=-1)
        if qkv.device.type == "cpu":
            return torch.cat(separable_attention_backward(q, k, v, g), dim=-1), None
        dqkv = torch.empty(qkv.shape, dtype=qkv.dtype, device=qkv.device)
        # the kernel reads g with its channel dim contiguous; autograd may hand
        # over an expanded (out.sum()) or transposed gradient
        separable_attention_bwd_kernel(q, k, v, g.to(qkv.dtype).contiguous(), *saved,
                                       *dqkv.split([1, c, c], dim=-1))
        return dqkv, None


def separable_attention_qkv(qkv: torch.Tensor, c: int) -> torch.Tensor:
    """(B, P, N, 1 + 2C) → (B, P, N, C): the core on the qkv projection's
    output, as LinearSelfAttention calls it."""
    b, p, n, _ = qkv.shape
    return SeparableAttention.apply(qkv.reshape(b * p, n, 1 + 2 * c), c).reshape(b, p, n, c)

