"""Swin window attention with an additive bias (counterpart of
cvnets_tpu/ops/pallas/window_attn.py:403-438).

Shapes: q, k and v are (B·nW, S, H·D), windows of one image consecutive, q
already scaled; they may be column thirds of one qkv tensor. ``bias`` is the
float32 relative-position bias (H, S, S); ``mask`` is None or the additive
shift mask (nW, S, S), whose row for window w is ``mask[w % nW]``.

* ``window_fwd_kernel`` / ``window_bwd_kernel``: the hand-written CUDA kernels
  (csrc/window_attention.cu) that replace the Pallas ``_pallas_fwd`` and
  ``_pallas_bwd``. They take CUDA tensors only and count their launches; the
  backward also returns dbias, the sum of the logit gradient over every window.
* ``window_attention_plain`` / ``window_attention_backward_plain``: the einsum
  math of the JAX ``_win_gold`` and ``swin_transformer_block.py:108-121`` in
  float32, and its VJP, for CPU tensors and as the kernels' references.
* ``window_attention_fwd`` (``torch.ops.cvnets_tpu_torch.window_attention_fwd``):
  the forward as a custom op, so that ``torch.export`` records it as one
  node: the forward kernel on a CUDA tensor, the plain version on a CPU
  tensor, and a fake that gives the shape (a meta tensor outside fake mode
  goes to the wrapper, which raises as on any device but a card). A program
  exported through it loads where ``cvnets_tpu_torch`` is imported.
* ``WindowAttentionFunction``: the autograd Function (its forward the op),
  ``fused_window_attention`` its entry.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from cvnets_tpu_torch.ops.cuda_build import KernelEntry

# the CUDA kernels tile one window of at most 64 tokens (Swin's window 7 gives
# 49, window 8 gives 64) with H·D ≤ 1024, as the JAX rule (window_attn.py:49-50)
_MAX_EMBED = 1024
_KERNEL_SEQ = 64
_HEAD_DIMS = (16, 32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_CHUNK = 16  # images of one window position a float32 block takes
# blocks an SM the bf16 kernels hold (WinFwdBf16 and WinBwdBf16 in
# csrc/window_attention.cu, whose __launch_bounds__ hold the registers to as
# many): the forward's shared memory allows four at D = 32 and three at D = 64,
# the backward's three at D = 16 and 32 and two at D = 64
_FWD_BLOCKS_AN_SM = {16: 4, 32: 4, 64: 3}
_BWD_BLOCKS_AN_SM = {16: 3, 32: 3, 64: 2}


def window_attention_eligible(seq: int, embed: int, heads: int) -> bool:
    """What the kernels take: windows of S ≤ 64 tokens, H·D ≤ 1024 and a head
    dim in {16, 32, 64}. The JAX rule (window_attn.py:136-141, S ≤ 512 and
    H·D ≤ 1024 behind a TPU-only switch) admits more; every other shape takes
    the einsum route, which the JAX package runs off its kernel."""
    return (seq <= _KERNEL_SEQ and embed <= _MAX_EMBED and embed % heads == 0
            and embed // heads in _HEAD_DIMS)


def _logits(q, k, heads: int, bias, mask) -> torch.Tensor:
    """float32 (B·nW, H, S, S) logits plus the bias and the shift mask."""
    bnw, s, e = q.shape
    qh, kh = (t.float().reshape(bnw, s, heads, e // heads) for t in (q, k))
    logits = torch.einsum("bnhd,bmhd->bhnm", qh, kh) + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        logits = (logits.reshape(bnw // nw, nw, heads, s, s)
                  + mask.float()[None, :, None]).reshape(bnw, heads, s, s)
    return logits


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                           bias: torch.Tensor, mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """``_win_gold`` (tests/test_pallas_kernels.py:349-359) in float32; the
    output in q's dtype."""
    bnw, s, e = q.shape
    p = torch.softmax(_logits(q, k, heads, bias, mask), dim=-1)
    vh = v.float().reshape(bnw, s, heads, e // heads)
    return torch.einsum("bhnm,bmhd->bnhd", p, vh).reshape(q.shape).to(q.dtype)


def window_attention_backward_plain(q, k, v, heads: int, bias, mask, out, g
                                    ) -> Tuple[torch.Tensor, ...]:
    """The einsum VJP in float32: dq, dk, dv in the inputs' dtypes and dbias
    (H, S, S) float32, the logit gradient summed over every window (the mask
    takes none)."""
    bnw, s, e = q.shape
    split = [t.float().reshape(bnw, s, heads, e // heads) for t in (q, k, v, out, g)]
    qh, kh, vh, oh, gh = split
    p = torch.softmax(_logits(q, k, heads, bias, mask), dim=-1)
    dv = torch.einsum("bhnm,bnhd->bmhd", p, gh)
    dp = torch.einsum("bnhd,bmhd->bhnm", gh, vh)
    delta = (gh * oh).sum(dim=-1).permute(0, 2, 1)[..., None]  # (B·nW, H, S, 1)
    ds = p * (dp - delta)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kh)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qh)
    return (dq.reshape(q.shape).to(q.dtype), dk.reshape(k.shape).to(k.dtype),
            dv.reshape(v.shape).to(v.dtype), ds.sum(dim=0))


def _check(tensors, heads: int, bias, mask) -> Tuple[int, int]:
    """Validate what the kernels take; return the head dim and nW."""
    ref = tensors[0][1]
    bnw, s, e = ref.shape
    if s > _KERNEL_SEQ:
        raise NotImplementedError(
            f"windows of S={s} > {_KERNEL_SEQ} tokens: csrc/window_attention.cu tiles one "
            f"window of at most {_KERNEL_SEQ} (window size 8)")
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{name} must be on q's CUDA device; got {t.device}")
        if t.dtype not in _DTYPE_CODE or t.dtype != ref.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}; the kernels take float32 or "
                            f"bfloat16, the same for q, k, v and dout")
        if tuple(t.shape) != (bnw, s, e):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {(bnw, s, e)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the channel dim must be contiguous; "
                             f"strides {t.stride()}")
    if e > _MAX_EMBED or e % heads or e // heads not in _HEAD_DIMS:
        raise ValueError(f"H·D={e} with H={heads}: the kernels take H·D ≤ {_MAX_EMBED} "
                         f"and D in {_HEAD_DIMS}")
    for name, t, want in (("bias", bias, (heads, s, s)),
                          ("mask", mask, None if mask is None else (mask.shape[0], s, s))):
        if t is None:
            continue
        if (t.dtype != torch.float32 or tuple(t.shape) != want or not t.is_contiguous()
                or t.device != ref.device):
            raise ValueError(f"{name}: want contiguous float32 {want} on {ref.device}; "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    nw = 1 if mask is None else mask.shape[0]
    if bnw % nw:
        raise ValueError(f"{bnw} windows are not a whole number of images of {nw}")
    return e // heads, nw


def _chunk(bnw: int, heads: int, device: torch.device) -> int:
    """Images of one window position a float32 block takes: as many as leave
    ~4 blocks an SM, at most 16. A function of the shapes and the card, so the
    dbias summation order is the same on every run."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(_MAX_CHUNK, bnw * heads // (4 * sms)))


def _one_wave_chunk(n_img: int, nw: int, heads: int, blocks_an_sm: int, sms: int) -> int:
    """The fewest images of one window position a block can take so that every
    block of the launch is resident at once on ``sms`` SMs holding
    ``blocks_an_sm`` blocks each (one image a block if even that leaves room)."""
    per_position = max(1, blocks_an_sm * sms // (nw * heads))
    return -(-n_img // per_position)


def _fwd_chunk(n_img: int, nw: int, heads: int, d: int, sms: int) -> int:
    """Images of one window position a bf16 forward block takes: the fewest
    that fit the launch into one wave, so that each block's bias gather and
    first copy serve the most windows (at Swin-T's batch 128: 64, 26, 12 and 6
    images, 384 to 528 blocks, where ``_chunk`` gives 16, 16, 11 and 5 and
    1,536 to 576 blocks)."""
    return _one_wave_chunk(n_img, nw, heads, _FWD_BLOCKS_AN_SM[d], sms)


def _bwd_chunk(n_img: int, nw: int, heads: int, d: int, sms: int) -> int:
    """Images of one window position a bf16 backward block takes: the fewest
    that fit every block into one wave of the card's ``sms`` SMs, so that each
    block's bias gather, first copy and partial dbias serve the most windows
    (at Swin-T's batch 128: 64, 32, 16 and 8 images, 384 blocks, where
    ``_chunk`` gives 16, 16, 11 and 5). A function of the shapes and the card,
    so the dbias summation order is the same on every run."""
    return _one_wave_chunk(n_img, nw, heads, _BWD_BLOCKS_AN_SM[d], sms)


def _strides(*tensors) -> ctypes.Array:
    flat = [x for t in tensors for x in (t.stride(0), t.stride(1))]
    return (ctypes.c_longlong * len(flat))(*flat)


class WindowForwardKernel(KernelEntry):
    def __init__(self) -> None:
        super().__init__("window_attention.cu", "window_attention_forward",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p, ctypes.c_int])

    def __call__(self, q, k, v, heads: int, bias, mask=None) -> torch.Tensor:
        """The output (B·nW, S, H·D) in q's dtype."""
        d, nw = _check((("q", q), ("k", k), ("v", v)), heads, bias, mask)
        bnw, s, e = q.shape
        out = torch.empty((bnw, s, e), dtype=q.dtype, device=q.device)
        if out.numel() == 0:
            return out
        if q.dtype == torch.bfloat16:
            sms = torch.cuda.get_device_properties(q.device).multi_processor_count
            chunk = _fwd_chunk(bnw // nw, nw, heads, d, sms)
        else:
            chunk = _chunk(bnw, heads, q.device)
        self.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    None if mask is None else mask.data_ptr(), out.data_ptr(),
                    bnw, s, heads, d, nw, chunk, _strides(q, k, v, out), _DTYPE_CODE[q.dtype])
        return out


class WindowBackwardKernel(KernelEntry):
    def __init__(self) -> None:
        super().__init__("window_attention.cu", "window_attention_backward",
                         [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6
                         + [ctypes.c_void_p, ctypes.c_int])

    def __call__(self, q, k, v, heads: int, bias, mask, dout
                 ) -> Tuple[torch.Tensor, ...]:
        """dq, dk, dv in q's dtype and dbias (H, S, S) float32. One call
        launches the backward kernel, which writes each block's partial dbias,
        and then the kernel that sums the partials, on the current stream."""
        d, nw = _check((("q", q), ("k", k), ("v", v), ("dout", dout)), heads, bias, mask)
        bnw, s, e = q.shape
        dq, dk, dv = (torch.empty((bnw, s, e), dtype=q.dtype, device=q.device)
                      for _ in range(3))
        dbias = torch.empty((heads, s, s), dtype=torch.float32, device=q.device)
        if dq.numel() == 0:
            return dq, dk, dv, dbias.zero_()
        if q.dtype == torch.bfloat16:
            sms = torch.cuda.get_device_properties(q.device).multi_processor_count
            chunk = _bwd_chunk(bnw // nw, nw, heads, d, sms)
        else:
            chunk = _chunk(bnw, heads, q.device)
        n_part = -(-(bnw // nw) // chunk) * nw
        partial = torch.empty((n_part, heads, s, s), dtype=torch.float32, device=q.device)
        self.launch(q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    None if mask is None else mask.data_ptr(), dout.data_ptr(),
                    dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), partial.data_ptr(),
                    dbias.data_ptr(), bnw, s, heads, d, nw, chunk,
                    _strides(q, k, v, dout, dq, dk, dv), _DTYPE_CODE[q.dtype])
        return dq, dk, dv, dbias


window_fwd_kernel = WindowForwardKernel()
window_bwd_kernel = WindowBackwardKernel()


@torch.library.custom_op("cvnets_tpu_torch::window_attention_fwd", mutates_args=(),
                         device_types="cuda")
def window_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                         bias: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """The forward kernel: the (B·nW, S, H·D) context in q's dtype."""
    return window_fwd_kernel(q, k, v, heads, bias, mask)


@window_attention_fwd.register_kernel("cpu")
def _window_attention_fwd_cpu(q, k, v, heads: int, bias, mask) -> torch.Tensor:
    return window_attention_plain(q, k, v, heads, bias, mask)


@window_attention_fwd.register_fake
def _window_attention_fwd_fake(q, k, v, heads: int, bias, mask) -> torch.Tensor:
    if q.device.type == "meta":  # a real meta tensor, not a fake one: no kernel runs there
        return window_fwd_kernel(q, k, v, heads, bias, mask)
    return q.new_empty(q.shape)


class WindowAttentionFunction(torch.autograd.Function):
    """Forward and backward are the CUDA kernels on CUDA tensors and the plain
    versions on CPU tensors. ``custom_fwd`` without a cast keeps autocast from
    recasting q, k and v: the kernels see the dtype the projection produced,
    and the bias stays float32."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, heads, bias, mask):
        out = window_attention_fwd(q, k, v, heads, bias, mask)
        ctx.heads = heads
        ctx.save_for_backward(q, k, v, bias, mask, out)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        q, k, v, bias, mask, out = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv, dbias = window_attention_backward_plain(q, k, v, ctx.heads, bias,
                                                                mask, out, g)
        else:
            dq, dk, dv, dbias = window_bwd_kernel(q, k, v, ctx.heads, bias, mask,
                                                  g.contiguous())
        return dq, dk, dv, None, dbias, None


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                           bias: torch.Tensor, mask: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Biased window attention (window_attn.py:403); returns the (B·nW, S, H·D)
    context. On a CUDA tensor it runs the kernels or raises; on the CPU it is
    the plain version."""
    return WindowAttentionFunction.apply(q, k, v, heads, bias, mask)
