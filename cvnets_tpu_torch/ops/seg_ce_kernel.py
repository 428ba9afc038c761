"""Fused bilinear-resize + pixel cross-entropy: the autograd Function, the CUDA
kernels' bindings and their plain versions (counterpart of
cvnets_tpu/ops/pallas/seg_ce_kernel.py).

The mean pixel CE of ``bilinear_resize(logits)`` against the labels is computed
without the (B, H, W, C) full-resolution logits:

1. ``h_interp``: the row interpolation ``hmid = A_h @ logits``, (B, H, w, C)
   float32, a torch matmul (the JAX package leaves it to XLA, ``_h_interp``).
2. ``seg_ce_fwd_kernel`` (csrc/seg_ce.cu, replaces ``_run_fwd``): per
   full-resolution row, ``A_w @ hmid_row`` and the CE; writes only
   ``(loss_sum, n_valid)``. ``seg_ce_bwd_kernel`` (replaces ``_run_bwd``)
   recomputes the rows and writes ``dhm = A_wᵀ @ G``, and the Function
   contracts ``dlogits = A_hᵀ @ dhm``.

``seg_ce_fwd_plain`` / ``seg_ce_bwd_plain`` compute what the two kernels do from
the same ``hmid``, in plain torch ops; they serve CPU tensors and are the
kernels' references. The CE is float32 whatever the logits' dtype. A target
outside [0, C) that is not the ignore index picks no logit and, with class
weights, weighs 0 (the Pallas kernel's one-hot).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from cvnets_tpu_torch.ops.cuda_build import KernelEntry

_TAPS = (2, 4, 8, 16)  # the kernels' template instances (csrc/seg_ce.cu)
_THREADS = 256  # a forward block's threads (kThreads in seg_ce.cu)
_BWD_WARPS = 8  # warps of a backward block (kBwdWarps in seg_ce.cu)
_WALK = 5  # ints of a backward plan per warp (kWalk in seg_ce.cu)
# the backward's (pixels a warp takes at a time, classes a lane keeps in
# registers) instances: a pixel over 32 lanes at any taps; with 2 taps, four
# pixels over 8 lanes each (seg_ce.cu seg_ce_backward)
_BWD_LANES = {1: (1, 2, 3, 5), 4: (1, 2, 3)}
_MAX_SMEM = 232448  # bytes of shared memory a Hopper block may opt in to


@dataclass(frozen=True)
class BandPlan:
    """How ``warps`` warps of a backward block split a row, as one int32
    ``table``: per warp its walk (output columns ``[j_lo, j_hi)``, input
    columns ``[k_lo, k_hi)``, the offset of its part of the slot map); the
    slot map (per warp and input column of its range, the shared-memory slot
    of its partial sum, or -1 where no other warp touches the column and it
    stores to dhm itself); the ``n_shared`` columns two or more warps touch;
    and per such column the first of its slots (``n_shared + 1`` ints: its
    slots are consecutive, one a warp in warp order, and are summed in that
    order)."""

    table: torch.Tensor
    warps: int
    n_slot_map: int
    n_shared: int
    n_slots: int

    def to(self, device) -> "BandPlan":
        return BandPlan(self.table.to(device), self.warps, self.n_slot_map, self.n_shared,
                        self.n_slots)


def _band_plan(k0: np.ndarray, taps: int, n_in: int, warps: int) -> BandPlan:
    """Split ``len(k0)`` output columns into ``warps`` runs (fewer if there are
    fewer columns); a run's input columns reach from its first pixel's k0 to
    its last pixel's k0 + taps, and on to the next run's first, so that every
    input column of [0, n_in) lies in some run (the first run starts at 0, the
    last ends at n_in)."""
    n_out = k0.size
    warps = max(1, min(warps, n_out))
    js = [v * n_out // warps for v in range(warps + 1)]
    k_lo = [0] + [int(k0[js[v]]) for v in range(1, warps)]
    end = [min(int(k0[js[v + 1] - 1]) + taps, n_in) for v in range(warps)]
    k_hi = [max(end[v], k_lo[v + 1]) for v in range(warps - 1)] + [n_in]
    offsets = np.concatenate([[0], np.cumsum(np.subtract(k_hi, k_lo))]).astype(np.int64)
    slot_map = np.full(int(offsets[-1]), -1, np.int64)
    shared_k, shared_ptr = [], [0]
    for k in range(n_in):
        owners = [v for v in range(warps) if k_lo[v] <= k < k_hi[v]]
        if len(owners) > 1:
            for v in owners:
                slot_map[offsets[v] + k - k_lo[v]] = shared_ptr[-1] + owners.index(v)
            shared_k.append(k)
            shared_ptr.append(shared_ptr[-1] + len(owners))
    walks = [[js[v], js[v + 1], k_lo[v], k_hi[v], offsets[v]] for v in range(warps)]
    table = np.concatenate([np.ravel(walks), slot_map, shared_k, shared_ptr]).astype(np.int32)
    return BandPlan(torch.from_numpy(table), warps, slot_map.size, len(shared_k),
                    shared_ptr[-1])


@dataclass(frozen=True)
class InterpTaps:
    """An (out, in) interpolation matrix as the kernels read it. The forward's
    ``idx``/``wt`` (out, taps): per output index its nonzeros, zero-padded to
    ``taps``. The backward's band: ``k0`` (out,), the first input column of
    each output index, never decreasing, and ``band`` (out, taps), the weights
    of input columns ``k0 .. k0 + taps - 1`` (0 past ``n_in``); and ``plans``,
    the ``BandPlan`` of ``_BWD_WARPS`` warps, then of half as many down to one
    (the wrapper takes the first whose shared memory fits). (A dataclass, not
    a tuple: autocast's input cast would rebuild a tuple.)"""

    idx: torch.Tensor
    wt: torch.Tensor
    taps: int
    k0: torch.Tensor
    band: torch.Tensor
    n_in: int
    plans: Tuple[BandPlan, ...]

    def to(self, device) -> "InterpTaps":
        return InterpTaps(self.idx.to(device), self.wt.to(device), self.taps,
                          self.k0.to(device), self.band.to(device), self.n_in,
                          tuple(p.to(device) for p in self.plans))


def interp_taps(a: torch.Tensor) -> InterpTaps:
    """Build the kernels' tables from a dense (out, in) matrix on the CPU. The
    matrix must be a band: the first nonzero of a row never lies left of the
    previous row's (rows of zeros aside), as in every matrix of
    ``resize_matrix_weights``; else this raises a ``ValueError``."""
    a = a.detach().cpu().numpy().astype(np.float32)
    n_out, n_in = a.shape
    nz = a != 0
    rows = nz.any(axis=1)
    first = nz.argmax(axis=1)
    last = n_in - 1 - nz[:, ::-1].argmax(axis=1)
    back = np.flatnonzero(np.diff(first[rows]) < 0)
    if back.size:
        j = np.flatnonzero(rows)[back[0] + 1]
        raise ValueError(f"the interpolation matrix is not a band: the first nonzero of row "
                         f"{j} (column {first[j]}) lies left of the previous row's; the "
                         "backward kernel takes output columns whose first input column "
                         "never decreases")
    width = int((last - first + 1)[rows].max(initial=0))
    taps = next((t for t in _TAPS if t >= width), None)
    if taps is None:
        raise ValueError(f"an interpolation row spans {width} input columns; the kernels "
                         f"take at most {_TAPS[-1]}")
    idx = np.zeros((n_out, taps), np.int32)
    wt = np.zeros((n_out, taps), np.float32)
    for j in range(n_out):
        cols = np.flatnonzero(nz[j])
        idx[j, :cols.size] = cols
        wt[j, :cols.size] = a[j, cols]
    # a row of zeros takes the previous row's k0 (0 at the start)
    k0 = np.maximum.accumulate(np.where(rows, first, 0)).astype(np.int32)
    cols = k0[:, None] + np.arange(taps)
    band = np.where(cols < n_in, a[np.arange(n_out)[:, None], np.minimum(cols, n_in - 1)],
                    0.0).astype(np.float32)
    warps = dict.fromkeys(min(w, n_out) for w in (_BWD_WARPS, 4, 2, 1))
    plans = tuple(_band_plan(k0, taps, n_in, w) for w in warps) if n_out and n_in else ()
    return InterpTaps(torch.from_numpy(idx), torch.from_numpy(wt), taps, torch.from_numpy(k0),
                      torch.from_numpy(band), n_in, plans)


def h_interp(logits: torch.Tensor, ah: torch.Tensor) -> torch.Tensor:
    """(B, h, w, C) logits of any float dtype → (B, H, w, C) float32 rows
    ``A_h @ logits`` (seg_ce_kernel.py:146-156)."""
    b, h, w, c = logits.shape
    return torch.matmul(ah, logits.float().reshape(b, h, w * c)).reshape(b, -1, w, c)


def _targets(target: torch.Tensor, c: int, ignore_idx: int):
    valid = target != ignore_idx
    safe = torch.where(valid, target, 0)
    in_range = (safe >= 0) & (safe < c)
    return valid, safe.clamp(0, c - 1), in_range


def pixel_ce(col: torch.Tensor, target: torch.Tensor, class_wts: Optional[torch.Tensor],
             ignore_idx: int, ls: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel float32 CE of ``col`` (..., C) against ``target`` (...): the
    terms of seg_ce_kernel.py:76-96, ignored pixels 0. Returns (losses, valid)."""
    col = col.float()
    valid, idx, in_range = _targets(target, col.shape[-1], ignore_idx)
    lse = torch.logsumexp(col, dim=-1)
    loss = lse - col.gather(-1, idx.unsqueeze(-1)).squeeze(-1) * in_range
    if ls > 0.0:
        loss = (1.0 - ls) * loss + ls * (lse - col.mean(dim=-1))
    if class_wts is not None:
        loss = loss * class_wts[idx] * in_range
    return loss * valid, valid


def seg_ce_fwd_plain(hmid: torch.Tensor, aw: torch.Tensor, target: torch.Tensor,
                     class_wts: Optional[torch.Tensor], ignore_idx: int, ls: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the forward kernel computes: (loss_sum, n_valid), float32 scalars."""
    loss, valid = pixel_ce(torch.matmul(aw, hmid), target, class_wts, ignore_idx, ls)
    return loss.sum(), valid.sum(dtype=torch.float32)


def seg_ce_bwd_plain(hmid: torch.Tensor, aw: torch.Tensor, target: torch.Tensor,
                     class_wts: Optional[torch.Tensor], scale: torch.Tensor,
                     ignore_idx: int, ls: float) -> torch.Tensor:
    """What the backward kernel computes: dhm (B, H, w, C) = A_wᵀ @ G with
    G = (softmax − (1−ls)·onehot − ls/C) · wt · valid · scale
    (seg_ce_kernel.py:123-139)."""
    g = torch.softmax(torch.matmul(aw, hmid), dim=-1)
    c = g.shape[-1]
    valid, idx, in_range = _targets(target, c, ignore_idx)
    if ls > 0.0:
        g = g - ls / c
    g = g.scatter_add(-1, idx.unsqueeze(-1), -(1.0 - ls) * in_range.unsqueeze(-1).float())
    factor = scale.float() * valid
    if class_wts is not None:
        factor = factor * class_wts[idx] * in_range
    return torch.matmul(aw.t(), g * factor.unsqueeze(-1))


def _check_inputs(hmid: torch.Tensor, target: torch.Tensor, taps: InterpTaps,
                  class_wts: Optional[torch.Tensor]) -> Tuple[int, int, int, int, int]:
    if hmid.device.type != "cuda":
        raise ValueError(f"hmid must be a CUDA tensor; got {hmid.device}")
    if hmid.dim() != 4 or hmid.dtype != torch.float32 or not hmid.is_contiguous():
        raise ValueError(f"hmid: want contiguous float32 (B, H, w, C); got "
                         f"{hmid.dtype} {tuple(hmid.shape)}")
    b, big_h, w, c = hmid.shape
    if (target.dtype != torch.int64 or target.dim() != 3 or tuple(target.shape[:2]) != (b, big_h)
            or not target.is_contiguous() or target.device != hmid.device):
        raise ValueError(f"target: want contiguous int64 ({b}, {big_h}, W) on {hmid.device}; "
                         f"got {target.dtype} {tuple(target.shape)} on {target.device}")
    big_w = target.shape[2]
    if tuple(taps.idx.shape) != (big_w, taps.taps) or taps.n_in != w:
        raise ValueError(f"taps: built for ({taps.idx.shape[0]}, {taps.n_in}), "
                         f"want ({big_w}, {w})")
    if any(t.device != hmid.device for t in (taps.idx, taps.wt, taps.k0, taps.band,
                                               *(p.table for p in taps.plans))):
        raise ValueError("taps must lie on hmid's device")
    if class_wts is not None and (class_wts.dtype != torch.float32 or class_wts.shape != (c,)
                                  or class_wts.device != hmid.device):
        raise ValueError(f"class_wts: want float32 ({c},) on {hmid.device}")
    return b, big_h, w, big_w, c


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class SegCEForwardKernel(KernelEntry):
    def __init__(self) -> None:
        super().__init__("seg_ce.cu", "seg_ce_forward",
                         [_P] * 4 + [_I] + [_P] * 4 + [_I] * 5 + [_F])

    def __call__(self, hmid: torch.Tensor, target: torch.Tensor, taps: InterpTaps,
                 class_wts: Optional[torch.Tensor], ignore_idx: int, ls: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss_sum, n_valid) as float32 0-d tensors on hmid's device; one call
        runs the row kernel and the fixed-order sum of its partials."""
        b, big_h, w, big_w, c = _check_inputs(hmid, target, taps, class_wts)
        smem = (w * c + 2 * _THREADS // 32) * 4
        if smem > _MAX_SMEM:
            raise ValueError(f"a row of hmid (w·C = {w * c} floats) exceeds the forward "
                             "kernel's shared memory")
        rows = b * big_h
        partial_loss = torch.empty(rows, dtype=torch.float32, device=hmid.device)
        partial_cnt = torch.empty(rows, dtype=torch.int32, device=hmid.device)
        out = torch.zeros(2, dtype=torch.float32, device=hmid.device)
        if rows and big_w:
            self.launch(hmid.device, hmid.data_ptr(), target.data_ptr(), taps.idx.data_ptr(),
                         taps.wt.data_ptr(), taps.taps,
                         None if class_wts is None else class_wts.data_ptr(),
                         partial_loss.data_ptr(), partial_cnt.data_ptr(), out.data_ptr(),
                         rows, w, big_w, c, ignore_idx, ls)
        return out[0], out[1]


def _bwd_lanes(c: int, taps: int) -> Tuple[int, int]:
    """(pixels a backward warp takes at a time, classes a lane keeps): four
    pixels over 8 lanes for C ≤ 24 with 2 taps, which leaves fewer lanes idle
    and shares each pixel's shuffles and bookkeeping over fewer classes; else
    one pixel over 32 lanes, and past 32 · 5 classes the lanes walk the row
    once per group of 160."""
    if taps == 2 and c <= 8 * _BWD_LANES[4][-1]:
        return 4, next(n for n in _BWD_LANES[4] if 8 * n >= c)
    return 1, next((n for n in _BWD_LANES[1] if 32 * n >= c), _BWD_LANES[1][-1])


def _bwd_smem(w: int, c: int, n_slots: int) -> int:
    """Bytes of shared memory of a backward block (bwd_smem in seg_ce.cu): the
    row of hmid, 16-byte aligned, and ``n_slots`` slots of C floats."""
    return (-(-w * c // 4) * 4 + n_slots * c) * 4


def _bwd_plan(taps: InterpTaps, w: int, c: int) -> BandPlan:
    """The plan with the most warps whose shared memory fits a block."""
    for plan in taps.plans:
        if _bwd_smem(w, c, plan.n_slots) <= _MAX_SMEM:
            return plan
    raise ValueError(f"a row of hmid (w·C = {w * c} floats) exceeds the backward kernel's "
                     "shared memory")


class SegCEBackwardKernel(KernelEntry):
    def __init__(self) -> None:
        super().__init__("seg_ce.cu", "seg_ce_backward",
                         [_P] * 4 + [_I] + [_P] + [_I] * 6 + [_P] * 3 + [_I] * 5 + [_F])

    def __call__(self, hmid: torch.Tensor, target: torch.Tensor, taps: InterpTaps,
                 class_wts: Optional[torch.Tensor], scale: torch.Tensor, ignore_idx: int,
                 ls: float) -> torch.Tensor:
        """dhm (B, H, w, C) float32; ``scale`` is a float32 one-element tensor on
        the device (dloss / n_valid), read by the kernel, not the host."""
        b, big_h, w, big_w, c = _check_inputs(hmid, target, taps, class_wts)
        if scale.dtype != torch.float32 or scale.numel() != 1 or scale.device != hmid.device:
            raise ValueError("scale: want a one-element float32 tensor on hmid's device")
        dhm = torch.empty_like(hmid)
        if dhm.numel() and big_w:
            plan = _bwd_plan(taps, w, c)
            scale = scale.contiguous()
            self.launch(hmid.device, hmid.data_ptr(), target.data_ptr(), taps.k0.data_ptr(),
                         taps.band.data_ptr(), taps.taps, plan.table.data_ptr(), plan.warps,
                         plan.n_slot_map, plan.n_shared, plan.n_slots,
                         *_bwd_lanes(c, taps.taps),
                         None if class_wts is None else class_wts.data_ptr(),
                         scale.data_ptr(), dhm.data_ptr(), b * big_h, w, big_w, c,
                         ignore_idx, ls)
        elif dhm.numel():
            dhm.zero_()
        return dhm


seg_ce_fwd_kernel = SegCEForwardKernel()
seg_ce_bwd_kernel = SegCEBackwardKernel()


class ResizeCE(torch.autograd.Function):
    """Mean pixel CE of the bilinear resize of ``logits`` (B, h, w, C) to the
    labels' (H, W), given ``ah`` (H, h) and ``aw`` (W, w) (and ``aw_taps``, the
    kernels' form of ``aw``, on a CUDA tensor). Forward and backward are the
    kernels on CUDA tensors and the plain versions on CPU tensors. Autocast is
    off inside and the logits come in as float32, so ``A_h @ logits`` runs in
    float32 as the JAX package's does; the logits' grad is in their dtype."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.float32)
    def forward(ctx, logits, target, ah, aw, aw_taps, class_wts, ignore_idx, ls):
        hmid = h_interp(logits, ah)
        if logits.device.type == "cpu":
            loss_sum, n_valid = seg_ce_fwd_plain(hmid, aw, target, class_wts, ignore_idx, ls)
        else:
            loss_sum, n_valid = seg_ce_fwd_kernel(hmid, target, aw_taps, class_wts,
                                                  ignore_idx, ls)
        n_valid = n_valid.clamp(min=1.0)
        ctx.save_for_backward(logits, target, ah, aw, class_wts, n_valid)
        ctx.aw_taps, ctx.ignore_idx, ctx.ls = aw_taps, ignore_idx, ls
        return loss_sum / n_valid

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, g):
        logits, target, ah, aw, class_wts, n_valid = ctx.saved_tensors
        scale = (g.float() / n_valid).reshape(1)
        hmid = h_interp(logits, ah)  # recomputed: cheaper than keeping it
        if logits.device.type == "cpu":
            dhm = seg_ce_bwd_plain(hmid, aw, target, class_wts, scale, ctx.ignore_idx, ctx.ls)
        else:
            dhm = seg_ce_bwd_kernel(hmid, target, ctx.aw_taps, class_wts, scale,
                                    ctx.ignore_idx, ctx.ls)
        b, h, w, c = logits.shape
        dlogits = torch.matmul(ah.t(), dhm.reshape(b, -1, w * c)).reshape(b, h, w, c)
        return dlogits.to(logits.dtype), None, None, None, None, None, None, None
