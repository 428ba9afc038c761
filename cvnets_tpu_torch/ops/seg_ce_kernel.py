"""Fused bilinear-resize + pixel cross-entropy: the autograd Function, the CUDA
kernels' bindings and their plain versions (counterpart of
cvnets_tpu/ops/pallas/seg_ce_kernel.py).

The mean pixel CE of ``bilinear_resize(logits)`` against the labels is computed
without the (B, H, W, C) full-resolution logits:

1. ``seg_ce_fwd_kernel`` (csrc/seg_ce.cu, replaces ``_run_fwd``): per
   full-resolution row, the row interpolation ``hmid_row = A_h @ logits``
   (the JAX package leaves it to XLA, ``_h_interp``), ``A_w @ hmid_row`` and
   the CE; writes only ``(loss_sum, n_valid)``.
2. The backward: ``h_interp``, ``hmid = A_h @ logits`` (B, H, w, C) float32,
   a torch matmul; ``seg_ce_bwd_kernel`` (replaces ``_run_bwd``) recomputes
   the rows and writes ``dhm = A_wᵀ @ G``, and the Function contracts
   ``dlogits = A_hᵀ @ dhm``.

``seg_ce_fwd_plain(h_interp(logits, A_h), …)`` / ``seg_ce_bwd_plain`` compute
what the two kernels do, in plain torch ops; they serve CPU tensors and are
the kernels' references. The CE is float32 whatever the logits' dtype. A target
outside [0, C) that is not the ignore index picks no logit and, with class
weights, weighs 0 (the Pallas kernel's one-hot). ``seg_ce_eligible`` says which
shapes both kernels take; the loss sends every other shape to the unfused
plain version.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from cvnets_tpu_torch.ops.cuda_build import KernelEntry

_TAPS = (2, 4, 8, 16)  # the kernels' template instances (csrc/seg_ce.cu)
_FWD_MIN_SMEM = 32  # floats a forward block has at least (kFwdMinSmem in seg_ce.cu)
_BWD_WARPS = 8  # warps of a backward block (kBwdWarps in seg_ce.cu)
_WALK = 5  # ints of a backward plan per warp (kWalk in seg_ce.cu)
# the backward's (pixels a warp takes at a time, classes a lane keeps in
# registers) instances: a pixel over 32 lanes at any taps; with 2 taps, four
# pixels over 8 lanes each (seg_ce.cu seg_ce_backward)
_BWD_LANES = {1: (1, 2, 3, 5), 4: (1, 2, 3)}
_MAX_SMEM = 232448  # bytes of shared memory a Hopper block may opt in to


def resize_matrix_weights(out_size: int, in_size: int) -> torch.Tensor:
    """(out, in) float32 weights of ``jax.image.resize(method='bilinear')`` along
    one axis: jax/_src/image/scale.py ``compute_weight_mat`` with scale out/in,
    translation 0 and antialiasing, in the same float32 arithmetic."""
    if out_size == in_size:
        return torch.eye(in_size, dtype=torch.float32)
    inv_scale = torch.tensor(1.0 / (out_size / in_size), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs()
    weights = torch.clamp(1.0 - x / kernel_scale, min=0.0)  # (in, out)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).t().contiguous()


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


def band_width(a: np.ndarray) -> int:
    """The most input columns a row of the (out, in) matrix spans, from its
    first nonzero to its last (0 for a matrix of zeros)."""
    nz = a != 0
    first = nz.argmax(axis=1)
    last = a.shape[1] - 1 - nz[:, ::-1].argmax(axis=1)
    return int((last - first + 1)[nz.any(axis=1)].max(initial=0))


def interp_taps(a: torch.Tensor) -> InterpTaps:
    """Build the kernels' tables from a dense (out, in) matrix on the CPU. The
    matrix must be a band: the first nonzero of a row never lies left of the
    previous row's (rows of zeros aside), as in every matrix of
    ``resize_matrix_weights``; and its weights must be nonnegative, as there,
    since the forward bounds a pixel's logits by the weighted column maxima.
    Else this raises a ``ValueError``."""
    a = a.detach().cpu().numpy().astype(np.float32)
    n_out, n_in = a.shape
    if (a < 0).any():
        j, k = np.argwhere(a < 0)[0]
        raise ValueError(f"the interpolation matrix has a negative weight ({a[j, k]} at "
                         f"[{j}, {k}]); the forward kernel bounds a pixel's logits by the "
                         "weighted maxima of its input columns, which takes weights >= 0")
    nz = a != 0
    rows = nz.any(axis=1)
    first = nz.argmax(axis=1)
    back = np.flatnonzero(np.diff(first[rows]) < 0)
    if back.size:
        j = np.flatnonzero(rows)[back[0] + 1]
        raise ValueError(f"the interpolation matrix is not a band: the first nonzero of row "
                         f"{j} (column {first[j]}) lies left of the previous row's; the "
                         "backward kernel takes output columns whose first input column "
                         "never decreases")
    width = band_width(a)
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


def _check_cuda(x: torch.Tensor, name: str, layout: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor; got {x.device}")
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"{name}: want float32 {layout}; got {x.dtype} {tuple(x.shape)}")


def _check_taps(taps: InterpTaps, n_out: int, n_in: int, device: torch.device,
                name: str) -> None:
    if tuple(taps.idx.shape) != (n_out, taps.taps) or taps.n_in != n_in:
        raise ValueError(f"{name}: built for ({taps.idx.shape[0]}, {taps.n_in}), "
                         f"want ({n_out}, {n_in})")
    if any(t.device != device for t in (taps.idx, taps.wt, taps.k0, taps.band,
                                          *(p.table for p in taps.plans))):
        raise ValueError(f"{name} must lie on {device}")


def _check_labels(device: torch.device, b: int, w: int, c: int, target: torch.Tensor,
                  taps: InterpTaps, class_wts: Optional[torch.Tensor]) -> Tuple[int, int]:
    """Checks the labels (B, H, W), A_w's tables and the class weights; returns (H, W)."""
    if (target.dtype != torch.int64 or target.dim() != 3 or target.shape[0] != b
            or not target.is_contiguous() or target.device != device):
        raise ValueError(f"target: want contiguous int64 ({b}, H, W) on {device}; "
                         f"got {target.dtype} {tuple(target.shape)} on {target.device}")
    big_h, big_w = target.shape[1:]
    _check_taps(taps, big_w, w, device, "taps")
    if class_wts is not None and (class_wts.dtype != torch.float32 or class_wts.shape != (c,)
                                  or class_wts.device != device):
        raise ValueError(f"class_wts: want float32 ({c},) on {device}")
    return big_h, big_w


def _fwd_table(taps: InterpTaps, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's (idx, wt) of ``taps`` widened with zero weights to ``n``
    taps (the kernel reads A_h's and A_w's tables at one tap count)."""
    if taps.taps == n:
        return taps.idx, taps.wt
    return (torch.nn.functional.pad(taps.idx, (0, n - taps.taps)),
            torch.nn.functional.pad(taps.wt, (0, n - taps.taps)))


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class SegCEForwardKernel(KernelEntry):
    def __init__(self) -> None:
        super().__init__("seg_ce.cu", "seg_ce_forward",
                         [_P, _L, _I, _I, _I] + [_P] * 5 + [_I] + [_P] * 5 + [_I] * 6 + [_F])
        self._tickets = {}

    def _ticket(self, device: torch.device) -> torch.Tensor:
        """The int32 ticket of the launches on the current stream of
        ``device``: 0 between launches (the last block resets it), one a
        stream, so that launches on two streams never share one."""
        key = (device, torch.cuda.current_stream(device).cuda_stream)
        if key not in self._tickets:
            self._tickets[key] = torch.zeros(1, dtype=torch.int32, device=device)
        return self._tickets[key]

    def __call__(self, logits: torch.Tensor, target: torch.Tensor, ah_taps: InterpTaps,
                 aw_taps: InterpTaps, class_wts: Optional[torch.Tensor], ignore_idx: int,
                 ls: float) -> Tuple[torch.Tensor, torch.Tensor]:
        """(loss_sum, n_valid) as float32 0-d tensors on the logits' device, of
        the CE of ``A_h @ logits @ A_wᵀ`` against ``target``, from one launch:
        the row blocks, each forming its row of hmid from the logits rows of
        A_h's band, and the fixed-order sum of their partials. ``logits``
        (B, h, w, C) float32 may have any strides (a permuted view of NCHW
        logits is read as it lies, without a copy)."""
        _check_cuda(logits, "logits", "(B, h, w, C)")
        b, h, w, c = logits.shape
        big_h, big_w = _check_labels(logits.device, b, w, c, target, aw_taps, class_wts)
        _check_taps(ah_taps, big_h, h, logits.device, "ah_taps")
        sb, sy, sx, sc = logits.stride()
        if (h - 1) * sy + (w - 1) * sx + (c - 1) * sc >= 2 ** 31:
            raise ValueError(f"logits: an image's strides {(sy, sx, sc)} reach past 2^31")
        if _fwd_smem(w, c) > _MAX_SMEM:
            raise ValueError(f"a row of hmid and its column maxima (w·(C + 1) = "
                             f"{w * (c + 1)} floats) exceed the forward kernel's shared memory")
        rows = b * big_h
        out = torch.empty(2, dtype=torch.float32, device=logits.device)
        if rows and big_w:
            taps = max(ah_taps.taps, aw_taps.taps)
            (row_idx, row_wt), (tap_idx, tap_wt) = (_fwd_table(ah_taps, taps),
                                                    _fwd_table(aw_taps, taps))
            partial_loss = torch.empty(rows, dtype=torch.float32, device=logits.device)
            partial_cnt = torch.empty(rows, dtype=torch.int32, device=logits.device)
            self.launch(logits.device, logits.data_ptr(), sb, sy, sx, sc, row_idx.data_ptr(),
                         row_wt.data_ptr(), target.data_ptr(), tap_idx.data_ptr(),
                         tap_wt.data_ptr(), taps,
                         None if class_wts is None else class_wts.data_ptr(),
                         partial_loss.data_ptr(), partial_cnt.data_ptr(),
                         self._ticket(logits.device).data_ptr(), out.data_ptr(), rows, big_h,
                         w, big_w, c, ignore_idx, ls)
        else:
            out.zero_()
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


def _fwd_smem(w: int, c: int) -> int:
    """Bytes of shared memory of a forward block (fwd_smem in seg_ce.cu): the
    row of hmid and its w column maxima, never under ``_FWD_MIN_SMEM``
    floats."""
    return max(w * (c + 1), _FWD_MIN_SMEM) * 4


def _bwd_smem(w: int, c: int, n_slots: int) -> int:
    """Bytes of shared memory of a backward block (bwd_smem in seg_ce.cu): the
    row of hmid, 16-byte aligned, and ``n_slots`` slots of C floats."""
    return (-(-w * c // 4) * 4 + n_slots * c) * 4


def _bwd_plan(taps: InterpTaps, w: int, c: int) -> Optional[BandPlan]:
    """The plan with the most warps whose shared memory fits a block, or None."""
    return next((plan for plan in taps.plans if _bwd_smem(w, c, plan.n_slots) <= _MAX_SMEM),
                None)


class SegCEBackwardKernel(KernelEntry):
    def __init__(self) -> None:
        super().__init__("seg_ce.cu", "seg_ce_backward",
                         [_P] * 4 + [_I] + [_P] + [_I] * 6 + [_P] * 3 + [_I] * 5 + [_F])

    def __call__(self, hmid: torch.Tensor, target: torch.Tensor, taps: InterpTaps,
                 class_wts: Optional[torch.Tensor], scale: torch.Tensor, ignore_idx: int,
                 ls: float) -> torch.Tensor:
        """dhm (B, H, w, C) float32; ``scale`` is a float32 one-element tensor on
        the device (dloss / n_valid), read by the kernel, not the host."""
        _check_cuda(hmid, "hmid", "contiguous (B, H, w, C)")
        b, big_h, w, c = hmid.shape
        labels_h, big_w = _check_labels(hmid.device, b, w, c, target, taps, class_wts)
        if not hmid.is_contiguous() or labels_h != big_h:
            raise ValueError(f"hmid: want contiguous ({b}, {labels_h}, w, C); got "
                             f"{tuple(hmid.shape)} (contiguous: {hmid.is_contiguous()})")
        if scale.dtype != torch.float32 or scale.numel() != 1 or scale.device != hmid.device:
            raise ValueError("scale: want a one-element float32 tensor on hmid's device")
        dhm = torch.empty_like(hmid)
        if dhm.numel() and big_w:
            plan = _bwd_plan(taps, w, c)
            if plan is None:
                raise ValueError(f"a row of hmid (w·C = {w * c} floats) exceeds the backward "
                                 "kernel's shared memory")
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


@functools.lru_cache(maxsize=32)
def _resize_band(out_size: int, in_size: int) -> Optional[InterpTaps]:
    """The kernels' tables of ``resize_matrix_weights(out, in)`` on the CPU, or
    None where a row spans more columns than the kernels' largest tap count."""
    a = resize_matrix_weights(out_size, in_size)
    return interp_taps(a) if band_width(a.numpy()) <= _TAPS[-1] else None


def seg_ce_eligible(h: int, w: int, big_h: int, big_w: int, c: int) -> bool:
    """Whether both kernels take the resize of (h, w) logits of C classes to
    (H, W) labels: a row of the W-resize and of the H-resize spans at most 16
    input columns (the forward reads both as taps), a row of hmid and its
    column maxima (w·(C + 1) floats) fit the forward block's shared memory,
    and a backward plan fits it. The JAX package falls back to its scan path
    for what its kernel does not take (cvnets_tpu/ops/seg_ce.py:84-98); the
    loss here sends every ineligible shape to the unfused plain version."""
    if _fwd_smem(w, c) > _MAX_SMEM or _resize_band(big_h, h) is None:
        return False
    taps = _resize_band(big_w, w)
    return taps is not None and _bwd_plan(taps, w, c) is not None


class ResizeCE(torch.autograd.Function):
    """Mean pixel CE of the bilinear resize of ``logits`` (B, h, w, C) to the
    labels' (H, W), given ``ah`` (H, h) and ``aw`` (W, w) (and ``ah_taps``,
    ``aw_taps``, the kernels' forms of them, on a CUDA tensor). Forward and
    backward are the kernels on CUDA tensors and the plain versions on CPU
    tensors. Autocast is off inside and the logits come in as float32, so
    ``A_h @ logits`` runs in float32 as the JAX package's does; the logits'
    grad is in their dtype."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.float32)
    def forward(ctx, logits, target, ah, aw, ah_taps, aw_taps, class_wts, ignore_idx, ls):
        if logits.device.type == "cpu":
            loss_sum, n_valid = seg_ce_fwd_plain(h_interp(logits, ah), aw, target, class_wts,
                                                 ignore_idx, ls)
        else:
            # float32 as it lies (autocast's cast, or this one, keeps the strides)
            loss_sum, n_valid = seg_ce_fwd_kernel(logits.float(), target, ah_taps, aw_taps,
                                                  class_wts, ignore_idx, ls)
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
        return dlogits.to(logits.dtype), None, None, None, None, None, None, None, None
