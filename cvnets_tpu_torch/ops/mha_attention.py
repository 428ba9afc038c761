"""Fused multi-head softmax attention (counterpart of cvnets_tpu/ops/pallas/mha_attn.py
and, for S > 512, of cvnets_tpu/ops/pallas/mha_attn_long.py).

Shapes: q, k and v are (B, S, H·D), the layer's projection layout, with q
already scaled; ``key_mask`` is an additive (B, S) float32 mask or None.

* ``mha_fwd_kernel`` / ``mha_bwd_kernel``: the hand-written CUDA kernels
  (csrc/mha_attention.cu) that replace the Pallas ``_pallas_fwd`` and
  ``_pallas_bwd`` of both files. Their flash tiling (online softmax with saved
  row statistics; a backward of a pre-pass for delta, a dQ kernel over key
  tiles and a dK/dV kernel over query tiles) is the long-sequence kernels'
  KV-blocked design already, so one pair serves every S the JAX dispatch
  sends to a kernel (S ≤ 512, or S > 512 where ``mha_attn_long.choose_block``
  finds a block), at a head dim of 16, 32, 64 or 128 (the bf16 forward on
  wgmma at 64 and 128), and on the card any longer S too: their tiles
  cover a ragged S (the last tile masked), so ViT-B/16 at 1024² with its CLS
  token (S = 4,097 = 17 · 241, which no 128-block divides) takes them where
  the einsum route would keep B·H·S² probabilities a layer. On the CPU the
  dispatch keeps the JAX rule. They take CUDA tensors only and count their
  launches.
* ``mha_attention_plain`` / ``mha_attention_backward_plain``: the same
  functions in plain torch ops (the JAX ``_reference`` and its einsum VJP), for
  CPU tensors and as the kernels' references; ``mha_attention_stats_plain``
  the forward kernel's saved row statistics, as its reference;
  ``mha_attention_block_backward_plain`` the backward of one block of a
  longer row from the whole row's output and statistics (ring attention).
* ``mha_attention_fwd`` (``torch.ops.cvnets_tpu_torch.mha_attention_fwd``): the
  forward as a custom op, so that ``torch.export`` records it as one node:
  the forward kernel on a CUDA tensor, the plain version and its statistics
  on a CPU tensor, and a fake that gives the shapes (a meta tensor outside
  fake mode goes to the wrapper, which raises as on any device but a card).
  A program exported through it loads where ``cvnets_tpu_torch`` is imported.
* ``MHAAttention``: the autograd Function (its forward the op),
  ``fused_mha_attention`` its entry.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from cvnets_tpu_torch.ops.cuda_build import KernelEntry

# the single-tile TPU kernel's limits (mha_attn.py:55-56); longer sequences
# take the KV-blocked kernels of mha_attn_long.py where they can be blocked
_MAX_SEQ = 512
_MAX_EMBED = 1024
_HEAD_DIMS = (16, 32, 64, 128)
# the kernels' grids put the batch on gridDim.z, at most 65,535; a larger batch
# (ByteFormer's windows of a long file) runs as launches of at most this many
MAX_GRID_BATCH = 65535
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _choose_long_block(seq: int, embed: int, itemsize: int) -> Optional[int]:
    """mha_attn_long.py:62 ``choose_block``: the largest of 512/256/128 that
    divides ``seq`` and fits the TPU kernel's 8 MB VMEM budget."""
    for blk in (512, 256, 128):
        if seq % blk:
            continue
        need = (2 * blk * embed * itemsize + 4 * blk * embed * itemsize
                + 4 * blk * embed + 8 * blk * blk)
        if need <= 8 * 1024 * 1024:
            return blk
    return None


def _tiled_by_a_tpu_kernel(seq: int, embed: int, itemsize: int) -> bool:
    """The JAX rule (mha_attn.py:279-287 and :303-308): the single-tile kernel
    takes S ≤ 512 and H·D ≤ 1024; the long-sequence kernel takes an S it can
    block with elements of ``itemsize`` bytes."""
    if seq <= _MAX_SEQ and embed <= _MAX_EMBED:
        return True
    return embed <= _MAX_EMBED and _choose_long_block(seq, embed, itemsize) is not None


def fused_attention_eligible(seq: int, embed: int, heads: int, itemsize: int = 4,
                             on_cuda: bool = False) -> bool:
    """A head dim the kernels take (H | H·D, D in {16, 32, 64, 128}) and, on
    the CPU, the JAX rule; on the card (``on_cuda``) H·D ≤ 1024 at any S, the
    kernels' own limit. Every other shape takes the einsum route."""
    if embed % heads or embed // heads not in _HEAD_DIMS:
        return False
    if on_cuda:
        return embed <= _MAX_EMBED
    return _tiled_by_a_tpu_kernel(seq, embed, itemsize)


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, e = x.shape
    return x.float().reshape(b, s, heads, e // heads)


def _logits(qh, kh, key_mask):
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh)
    if key_mask is not None:
        logits = logits + key_mask.float()[:, None, None, :]
    return logits


def _softmax_probs(qh, kh, key_mask):
    return torch.softmax(_logits(qh, kh, key_mask), dim=-1)


def mha_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                        key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """mha_attn.py:225-232 ``_reference``: float32 logits, softmax, context;
    the output in q's dtype."""
    qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
    out = torch.einsum("bhqk,bkhd->bqhd", _softmax_probs(qh, kh, key_mask), vh)
    return out.reshape(q.shape).to(q.dtype)


def mha_attention_stats_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                              key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward kernel's saved row statistics, (2, B, H, S) float32: the
    row max m of logit + mask, and the natural log of the row sum of
    exp(logit + mask - m). ``v`` is unused; the arguments are the forward's.
    On a fully masked row every logit is -1e30, so m = -1e30 and the log-sum
    is log(S): kept apart, the pair holds the uniform row's 1/S."""
    del v
    logits = _logits(_split_heads(q, heads), _split_heads(k, heads), key_mask)
    m = logits.amax(dim=-1)
    log_sum = torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))
    return torch.stack([m, log_sum])


def mha_attention_backward_plain(q, k, v, key_mask, out, g, heads: int
                                 ) -> Tuple[torch.Tensor, ...]:
    """mha_attn.py:260-273, the einsum VJP in float32; grads in input dtypes."""
    qh, kh, vh, gh, oh = (_split_heads(t, heads) for t in (q, k, v, g, out))
    p = _softmax_probs(qh, kh, key_mask)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, vh)
    delta = (gh * oh).sum(dim=-1)                       # (B, S, H)
    ds = p * (dp - delta.permute(0, 2, 1)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh)
    return (dq.reshape(q.shape).to(q.dtype), dk.reshape(k.shape).to(k.dtype),
            dv.reshape(v.shape).to(v.dtype))


def mha_attention_block_backward_plain(q, k, v, key_mask, out, g, stats, heads: int
                                       ) -> Tuple[torch.Tensor, ...]:
    """The backward kernel's math for one block of a longer row (ring
    attention, ``parallel/ring_attention.py``): p = exp(logit + mask - m -
    log-sum) from the given (2, B, H, S) statistics and delta = rowsum(g·out)
    from the given output, both the whole row's, where
    ``mha_attention_backward_plain`` renormalises over its own keys. Float32;
    grads in input dtypes."""
    qh, kh, vh, gh, oh = (_split_heads(t, heads) for t in (q, k, v, g, out))
    logits = _logits(qh, kh, key_mask)                  # (B, H, Sq, Sk)
    # m and the log-sum apart: on a fully masked row m = -1e30 and their sum
    # would round log(S) away
    p = torch.exp(logits - stats[0][..., None] - stats[1][..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, gh)
    dp = torch.einsum("bqhd,bkhd->bhqk", gh, vh)
    delta = (gh * oh).sum(dim=-1)                       # (B, S, H)
    ds = p * (dp - delta.permute(0, 2, 1)[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kh)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qh)
    return (dq.reshape(q.shape).to(q.dtype), dk.reshape(k.shape).to(k.dtype),
            dv.reshape(v.shape).to(v.dtype))


def _check(tensors, shape, heads: int) -> int:
    """Validate what the kernels take; return the head dim."""
    b, s, e = shape
    ref = tensors[0][1]
    if e > _MAX_EMBED:
        raise NotImplementedError(
            f"S={s}, H·D={e}: the kernels take H·D ≤ {_MAX_EMBED}; MultiHeadAttention "
            f"sends this shape to the einsum route")
    for name, t in tensors:
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"{name} must be on q's CUDA device; got {t.device}")
        if t.dtype not in _DTYPE_CODE or t.dtype != ref.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}; the kernels take float32 or "
                            f"bfloat16, the same for every input")
        if tuple(t.shape) != (b, s, e):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {(b, s, e)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the channel dim must be contiguous; "
                             f"strides {t.stride()}")
    if e > _MAX_EMBED or e % heads or e // heads not in _HEAD_DIMS:
        raise ValueError(f"H·D={e} with H={heads}: the kernels take H·D ≤ {_MAX_EMBED} "
                         f"and D in {_HEAD_DIMS}")
    return e // heads


def _mask_arg(key_mask: Optional[torch.Tensor], b: int, s: int, device) -> Optional[torch.Tensor]:
    if key_mask is None:
        return None
    if tuple(key_mask.shape) != (b, s) or key_mask.device != device:
        raise ValueError(f"key_mask: shape {tuple(key_mask.shape)} on {key_mask.device}, "
                         f"want {(b, s)} on {device}")
    return key_mask.to(torch.float32).contiguous()


def _strides(*tensors) -> ctypes.Array:
    flat = [x for t in tensors for x in (t.stride(0), t.stride(1))]
    return (ctypes.c_longlong * len(flat))(*flat)


class _MHAKernel(KernelEntry):
    """An entry point of csrc/mha_attention.cu: ``n_ptrs`` pointers, then B, S,
    H, D, the strides array and the dtype code."""

    def __init__(self, symbol: str, n_ptrs: int) -> None:
        super().__init__("mha_attention.cu", symbol,
                         [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4
                         + [ctypes.c_void_p, ctypes.c_int])

    def _launch(self, ptrs, b, s, h, d, strides, dtype, device) -> None:
        self.launch(device, *ptrs, b, s, h, d, strides, _DTYPE_CODE[dtype])


class MHAForwardKernel(_MHAKernel):
    def __init__(self) -> None:
        super().__init__("mha_attention_forward", 6)

    def __call__(self, q, k, v, heads: int, key_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns the output (B, S, H·D) in q's dtype and the saved row
        statistics (2, B, H, S) float32: row max and log of the row sum."""
        d = _check((("q", q), ("k", k), ("v", v)), q.shape, heads)
        b, s, e = q.shape
        mask = _mask_arg(key_mask, b, s, q.device)
        if b > MAX_GRID_BATCH:  # one launch a slice of the batch
            parts = [self(q[i:i + MAX_GRID_BATCH], k[i:i + MAX_GRID_BATCH],
                          v[i:i + MAX_GRID_BATCH], heads,
                          None if mask is None else mask[i:i + MAX_GRID_BATCH])
                     for i in range(0, b, MAX_GRID_BATCH)]
            return (torch.cat([o for o, _ in parts]),
                    torch.cat([st for _, st in parts], dim=1))
        out = torch.empty((b, s, e), dtype=q.dtype, device=q.device)
        stats = torch.empty((2, b, heads, s), dtype=torch.float32, device=q.device)
        if out.numel() == 0:
            return out, stats
        self._launch((q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      None if mask is None else mask.data_ptr(), out.data_ptr(),
                      stats.data_ptr()),
                     b, s, heads, d, _strides(q, k, v, out), q.dtype, q.device)
        return out, stats


class MHABackwardKernel(_MHAKernel):
    def __init__(self) -> None:
        super().__init__("mha_attention_backward", 11)

    def __call__(self, q, k, v, key_mask, out, dout, stats, heads: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """dq, dk, dv from the forward's output and row statistics: one call
        launches, on the current stream, the kernels of one backward (bf16: a
        pre-pass that writes delta = rowsum(dO·O) and the statistics scaled
        by log2(e) into a (3, B, H, S) scratch, then the dQ and the dK/dV
        kernels; float32: the dQ kernel, which writes delta, then dK/dV)."""
        d = _check((("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)),
                   q.shape, heads)
        b, s, e = q.shape
        if (stats.dtype != torch.float32 or tuple(stats.shape) != (2, b, heads, s)
                or not stats.is_contiguous() or stats.device != q.device):
            raise ValueError(f"stats: want contiguous float32 {(2, b, heads, s)} on "
                             f"{q.device}; got {stats.dtype} {tuple(stats.shape)}")
        mask = _mask_arg(key_mask, b, s, q.device)
        if b > MAX_GRID_BATCH:  # one call a slice of the batch
            parts = [self(*(t[i:i + MAX_GRID_BATCH] for t in (q, k, v)),
                          None if mask is None else mask[i:i + MAX_GRID_BATCH],
                          out[i:i + MAX_GRID_BATCH], dout[i:i + MAX_GRID_BATCH],
                          stats[:, i:i + MAX_GRID_BATCH].contiguous(), heads)
                     for i in range(0, b, MAX_GRID_BATCH)]
            return tuple(torch.cat(g) for g in zip(*parts))
        dq, dk, dv = (torch.empty((b, s, e), dtype=q.dtype, device=q.device)
                      for _ in range(3))
        if dq.numel() == 0:
            return dq, dk, dv
        delta = torch.empty((3, b, heads, s), dtype=torch.float32, device=q.device)
        self._launch((q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      None if mask is None else mask.data_ptr(), out.data_ptr(),
                      dout.data_ptr(), stats.data_ptr(), delta.data_ptr(),
                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr()),
                     b, s, heads, d, _strides(q, k, v, out, dout, dq, dk, dv),
                     q.dtype, q.device)
        return dq, dk, dv


mha_fwd_kernel = MHAForwardKernel()
mha_bwd_kernel = MHABackwardKernel()


@torch.library.custom_op("cvnets_tpu_torch::mha_attention_fwd", mutates_args=(),
                         device_types="cuda")
def mha_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                      key_mask: Optional[torch.Tensor]) -> List[torch.Tensor]:
    """The forward kernel: [out (B, S, H·D) in q's dtype, the row statistics
    (2, B, H, S) float32]."""
    return list(mha_fwd_kernel(q, k, v, heads, key_mask))


@mha_attention_fwd.register_kernel("cpu")
def _mha_attention_fwd_cpu(q, k, v, heads: int, key_mask) -> List[torch.Tensor]:
    return [mha_attention_plain(q, k, v, heads, key_mask),
            mha_attention_stats_plain(q, k, v, heads, key_mask)]


@mha_attention_fwd.register_fake
def _mha_attention_fwd_fake(q, k, v, heads: int, key_mask) -> List[torch.Tensor]:
    if q.device.type == "meta":  # a real meta tensor, not a fake one: no kernel runs there
        return list(mha_fwd_kernel(q, k, v, heads, key_mask))
    b, s, _ = q.shape
    return [q.new_empty(q.shape), q.new_empty((2, b, heads, s), dtype=torch.float32)]


class MHAAttention(torch.autograd.Function):
    """Forward and backward are the CUDA kernels on CUDA tensors and the plain
    versions on CPU tensors. ``custom_fwd`` without a cast keeps autocast from
    recasting q, k and v: the kernels see the dtype the projection produced."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda")
    def forward(ctx, q, k, v, heads, key_mask):
        out, stats = mha_attention_fwd(q, k, v, heads, key_mask)
        ctx.heads = heads
        ctx.save_for_backward(q, k, v, key_mask, out, stats)
        return out

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        q, k, v, key_mask, out, stats = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = mha_attention_backward_plain(q, k, v, key_mask, out, g, ctx.heads)
        else:
            grads = mha_bwd_kernel(q, k, v, key_mask, out, g.contiguous(), stats,
                                   ctx.heads)
        return (*grads, None, None)


def fused_mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                        key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused softmax attention (mha_attn.py:290); returns the (B, S, H·D)
    context. On a CUDA tensor it runs the kernels or raises (on a shape that
    neither TPU kernel tiles, such as S = 4097); on the CPU it is the plain
    version at any S, as the JAX package is off the TPU."""
    return MHAAttention.apply(q, k, v, heads, key_mask)
