"""The port's fused bilinear-resize + pixel CE against the JAX package.

* ``resize_matrix`` against ``cvnets_tpu.ops.seg_ce.resize_matrix``
  (``jax.image.resize`` of an identity), upsampling and downsampling.
* ``fused_resize_ce`` on the CPU (the Function with the kernels' plain versions)
  against ``pallas_resize_ce`` in interpret mode, as tests/test_pallas_kernels.py
  runs it, and against the JAX dispatcher's scan path: loss and d/dlogits, over
  label smoothing, class weights and the logits' dtype, with ignored pixels,
  a fully ignored image and a fully ignored batch; plus 150 classes.
* The plain backward the CUDA kernel is held to against autograd through the
  unfused plain version; the kernels' host tables against the dense matrix.
* The class-weight convention: the weighted sum over the *unweighted* count.
* The backward's band plans walked as the kernel walks them, on the CPU: every
  input column written once, A_wᵀ G rebuilt.
* The forward kernel's algorithm, emulated here in float32 torch ops
  (``_emulate_forward``: one pass shifted by the weighted column maxima, two
  passes with the true max where the sum underflows), against the plain
  version and the Pallas kernel in interpret mode, on ordinary and on spread
  logits that take the fallback; the bound itself at every resize shape of
  this file; the tables refusing a negative weight; ``_fwd_smem`` against
  ``fwd_smem`` of csrc/seg_ce.cu.
* The dispatch rule ``seg_ce_eligible`` at the edge of each kernel limit, and
  ``SegCrossEntropy`` past a limit computing through the unfused plain
  version (the fused entry patched to fail) against the JAX loss.
* On a CUDA card only: the kernels against their plain versions at the
  DeepLabv3 shapes (dhm the same bits on a second call), the forward and the
  backward at C 21, W 300 from 7, 5 from 12, C 300 and 434, the forward on a
  fully ignored image and on spread logits, the backward under every plan, the
  dispatcher launching the kernels, never the plain versions, and the loss
  past each limit launching neither kernel:
  ``python -m pytest --noconftest -m cuda tests/test_torch_seg_ce.py``.

Tolerances. Float32: the same float32 arithmetic in another order (sums over C
and over ~10⁴ pixels): loss within 1e-5 relative, grads within 1e-5 absolute
(the grads are ~1e-3 here). bfloat16 logits: the port and the Pallas path both
convert them exactly to float32 before any arithmetic, so they keep the float32
tolerances; the JAX scan path rounds its row interpolation to bfloat16
(seg_ce.py:110-113), so against it the loss is held to 2e-3 relative and the
grads, which both return in bfloat16, to 2⁻⁷ of their largest value.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from cvnets_tpu_torch.ops.seg_ce import (
    fused_resize_ce,
    resize_ce_plain,
    resize_matrix,
    resize_matrix_weights,
)
from cvnets_tpu_torch.ops.seg_ce_kernel import (
    _FWD_MIN_SMEM,
    _MAX_SMEM,
    _WALK,
    _bwd_plan,
    _fwd_smem,
    band_width,
    h_interp,
    interp_taps,
    seg_ce_bwd_kernel,
    seg_ce_bwd_plain,
    seg_ce_eligible,
    seg_ce_fwd_kernel,
    seg_ce_fwd_plain,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

LOSS_RTOL, GRAD_ATOL = 1e-5, 1e-5


def _inputs(b, h, w, c, big, seed, ignore_image=False, ignore_all=False):
    rng = np.random.default_rng(seed)
    logits = (2.0 * rng.standard_normal((b, h, w, c))).astype(np.float32)
    target = rng.integers(0, c, (b, big, big)).astype(np.int64)
    target = np.where(rng.random((b, big, big)) < 0.05, 255, target)
    target[0, :3] = 255
    if ignore_image:
        target[0] = 255
    if ignore_all:
        target[:] = 255
    return logits, target


def _class_wts(target, c):
    from cvnets_tpu.loss.base_criteria import BaseCriteria
    import jax.numpy as jnp

    safe = np.where(target == 255, 0, target).astype(np.int32)
    return np.array(BaseCriteria._class_weights(jnp.asarray(safe), c))


def _port(logits, target, ls, wts, dtype):
    x = torch.from_numpy(logits).to(dtype).requires_grad_()
    loss = fused_resize_ce(x, torch.from_numpy(target), ignore_idx=255, label_smoothing=ls,
                           class_wts=None if wts is None else torch.from_numpy(wts))
    loss.backward()
    return loss.item(), x.grad.float().numpy()


def _jax_pallas(logits, target, ls, wts, dtype):
    import jax
    import jax.numpy as jnp
    from cvnets_tpu.ops.pallas.seg_ce_kernel import pallas_resize_ce
    from cvnets_tpu.ops.seg_ce import resize_matrix as jax_resize_matrix

    b, h, w, c = logits.shape
    hh, ww = target.shape[1:]
    ah, aw = jax_resize_matrix(hh, h), jax_resize_matrix(ww, w)
    wts_row = (jnp.ones((1, c), jnp.float32) if wts is None
               else jnp.asarray(wts).reshape(1, c))
    tgt = jnp.asarray(target.astype(np.int32))

    def f(lo):
        return pallas_resize_ce(255, ls, 8, True, wts is not None, lo, tgt, ah, aw, wts_row)

    v, g = jax.value_and_grad(f)(jnp.asarray(logits).astype(dtype))
    return float(v), np.asarray(g.astype(jnp.float32))


def _jax_scan(logits, target, ls, wts, dtype):
    import jax
    import jax.numpy as jnp
    from cvnets_tpu.ops.seg_ce import fused_resize_ce as jax_fused

    tgt = jnp.asarray(target.astype(np.int32))
    cw = None if wts is None else jnp.asarray(wts)

    def f(lo):
        return jax_fused(lo, tgt, ignore_idx=255, label_smoothing=ls, class_wts=cw)

    v, g = jax.value_and_grad(f)(jnp.asarray(logits).astype(dtype))
    return float(v), np.asarray(g.astype(jnp.float32))


@pytest.mark.parametrize("out_size,in_size", [(64, 8), (512, 32), (32, 4), (40, 5),
                                              (8, 8), (5, 12), (7, 64)])
def test_resize_matrix_matches_jax(out_size, in_size):
    """(5, 12) and (7, 64) downsample, where jax.image.resize widens the
    triangle filter (antialiasing)."""
    from cvnets_tpu.ops.seg_ce import resize_matrix as jax_resize_matrix

    want = np.asarray(jax_resize_matrix(out_size, in_size))
    got = resize_matrix(out_size, in_size).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("use_wts", [False, True], ids=["no_wts", "class_wts"])
@pytest.mark.parametrize("ls", [0.0, 0.1], ids=["ls0", "ls0.1"])
def test_plain_matches_jax_pallas_interpret_and_scan(ls, use_wts, dtype):
    import jax.numpy as jnp

    logits, target = _inputs(2, 8, 8, 13, 64, seed=0)
    wts = _class_wts(target, 13) if use_wts else None
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    loss, grad = _port(logits, target, ls, wts, dtype)
    ref_loss, ref_grad = _jax_pallas(logits, target, ls, wts, jdtype)
    assert loss == pytest.approx(ref_loss, rel=LOSS_RTOL)
    np.testing.assert_allclose(grad, ref_grad, atol=GRAD_ATOL, rtol=0)
    scan_loss, scan_grad = _jax_scan(logits, target, ls, wts, jdtype)
    if dtype == torch.float32:
        assert loss == pytest.approx(scan_loss, rel=LOSS_RTOL)
        np.testing.assert_allclose(grad, scan_grad, atol=GRAD_ATOL, rtol=0)
    else:
        assert loss == pytest.approx(scan_loss, rel=2e-3)
        np.testing.assert_allclose(grad, scan_grad, atol=2**-7 * np.abs(scan_grad).max(),
                                   rtol=0)


@pytest.mark.parametrize("case", ["ignored_image", "all_ignored", "classes150"])
def test_plain_matches_jax_pallas_on_edge_cases(case):
    if case == "classes150":
        logits, target = _inputs(2, 4, 4, 150, 32, seed=1)
    else:
        logits, target = _inputs(2, 8, 8, 13, 64, seed=2, ignore_image=True,
                                 ignore_all=case == "all_ignored")
    import jax.numpy as jnp

    c = logits.shape[-1]
    wts = _class_wts(target, c)
    for ls, w in ((0.0, None), (0.1, wts)):
        loss, grad = _port(logits, target, ls, w, torch.float32)
        ref_loss, ref_grad = _jax_pallas(logits, target, ls, w, jnp.float32)
        assert loss == pytest.approx(ref_loss, rel=LOSS_RTOL, abs=1e-12)
        np.testing.assert_allclose(grad, ref_grad, atol=GRAD_ATOL, rtol=0)
        if case == "all_ignored":
            assert loss == 0.0 and not grad.any()


@pytest.mark.parametrize("ls,use_wts", [(0.0, False), (0.1, True)])
def test_function_grads_match_autograd_of_the_unfused_plain_version(ls, use_wts):
    """The backward the CUDA kernel is held to (``seg_ce_bwd_plain`` through the
    A_h contraction) against autograd through upsample-then-CE."""
    logits, target = _inputs(2, 6, 5, 7, 40, seed=3)
    target = target[:, :32]  # H = 32, W = 40: the two axes differ
    wts = torch.from_numpy(np.random.default_rng(4).uniform(0.5, 2.0, 7).astype(np.float32))
    wts = wts if use_wts else None
    grads, losses = [], []
    for fn in (fused_resize_ce, resize_ce_plain):
        x = torch.from_numpy(logits).requires_grad_()
        loss = fn(x, torch.from_numpy(np.ascontiguousarray(target)), ignore_idx=255,
                  label_smoothing=ls, class_wts=wts)
        loss.backward()
        losses.append(loss.item())
        grads.append(x.grad.numpy())
    assert losses[0] == pytest.approx(losses[1], rel=LOSS_RTOL)
    np.testing.assert_allclose(grads[0], grads[1], atol=GRAD_ATOL, rtol=0)


def test_class_weights_divide_by_the_unweighted_valid_count():
    """ROADMAP queue 3's trap: sum(w[t]·CE) / #valid, which is not
    ``F.cross_entropy(weight=w)`` (that divides by the sum of the weights)."""
    import torch.nn.functional as F

    logits, target = _inputs(2, 8, 8, 13, 64, seed=5)
    wts = torch.from_numpy(_class_wts(target, 13))
    x, t = torch.from_numpy(logits), torch.from_numpy(target)
    loss = fused_resize_ce(x, t, ignore_idx=255, class_wts=wts).item()
    up = torch.einsum("Hh,bhwc,Ww->bcHW", resize_matrix(64, 8), x, resize_matrix(64, 8))
    per_pixel = F.cross_entropy(up, t, ignore_index=255, reduction="none")
    safe = torch.where(t == 255, 0, t)
    want = ((per_pixel * wts[safe]).sum() / (t != 255).sum()).item()
    assert loss == pytest.approx(want, rel=LOSS_RTOL)
    weighted_mean = F.cross_entropy(up, t, weight=wts, ignore_index=255).item()
    assert abs(weighted_mean - loss) > 1e-3 * loss


def test_class_weights_match_jax():
    from cvnets_tpu_torch.loss.base_criteria import BaseCriteria

    _, target = _inputs(2, 8, 8, 13, 64, seed=6)
    safe = torch.from_numpy(np.where(target == 255, 0, target))
    np.testing.assert_allclose(BaseCriteria._class_weights(safe, 13).numpy(),
                               _class_wts(target, 13), atol=1e-6, rtol=0)


@pytest.mark.parametrize("out_size,in_size", [(512, 32), (40, 5), (5, 12), (300, 7)])
def test_kernel_tables_rebuild_the_matrix(out_size, in_size):
    """The forward's taps and the backward's band the kernels read hold exactly
    the dense matrix (5 from 12 downsamples: 5 nonzeros a row, 8 taps)."""
    a = resize_matrix_weights(out_size, in_size)
    t = interp_taps(a)
    dense = torch.zeros_like(a)
    dense.scatter_add_(1, t.idx.long(), t.wt)
    torch.testing.assert_close(dense, a, atol=0, rtol=0)
    cols = t.k0.long()[:, None] + torch.arange(t.taps)
    assert bool((t.band[cols >= in_size] == 0).all())
    dense = torch.zeros((out_size, in_size + t.taps))
    dense.scatter_add_(1, cols, t.band)
    torch.testing.assert_close(dense[:, :in_size], a, atol=0, rtol=0)


@pytest.mark.parametrize("out_size,in_size", [(512, 32), (512, 64), (40, 5), (5, 12), (300, 7),
                                              (64, 8), (32, 4), (12, 5)])
def test_resize_matrix_is_a_band(out_size, in_size):
    """Every row's nonzeros are one run of columns, and the run's first column
    never decreases: what the backward kernel's walk relies on, upsampling and
    downsampling (the widened triangle of 5 from 12)."""
    a = resize_matrix_weights(out_size, in_size).numpy()
    nz = a != 0
    assert nz.any(axis=1).all()
    first = nz.argmax(axis=1)
    last = in_size - 1 - nz[:, ::-1].argmax(axis=1)
    assert (np.diff(first) >= 0).all()
    assert all(nz[j, first[j]:last[j] + 1].all() for j in range(out_size))
    np.testing.assert_array_equal(interp_taps(torch.from_numpy(a)).k0.numpy(), first)


def test_interp_taps_rejects_a_matrix_that_is_not_a_band():
    perm = torch.eye(6)[torch.tensor([0, 3, 1, 2, 5, 4])]
    with pytest.raises(ValueError, match="not a band"):
        interp_taps(perm)


LOG2E = 1.4426950408889634
TINY = 2.0 ** -60  # kTiny in csrc/seg_ce.cu


def _emulate_forward(hmid, taps, target, class_wts, ignore_idx, ls, fallback=True):
    """The forward kernel's algorithm in float32 torch ops: each pixel's logits
    from its taps, shifted by the bound ``sum_t a_t colmax[k_t]`` (colmax: the
    largest logit of each input column of the row), one pass for the sum of
    ``exp2((col - bound) log2 e)`` and of the logits; where that sum falls
    under 2^-60, the pixel's true max and two passes. Returns (loss_sum,
    n_valid, pixels that took the fallback among the valid ones)."""
    idx, wt = taps.idx.long(), taps.wt
    taps_rows = hmid[:, :, idx, :]  # (B, H, W, taps, C)
    col = (wt[None, None, :, :, None] * taps_rows).sum(3)
    colmax = hmid.amax(-1)[:, :, idx]  # (B, H, W, taps)
    bound = (wt[None, None] * colmax).sum(-1)
    shift = bound * LOG2E
    s = torch.exp2(col * LOG2E - shift[..., None]).sum(-1)
    under = s < TINY
    if fallback:
        m = col.amax(-1)
        s = torch.where(under, torch.exp2(col * LOG2E - (m * LOG2E)[..., None]).sum(-1), s)
        bound = torch.where(under, m, bound)
    lse = bound + torch.log(s)
    c = hmid.shape[-1]
    valid = target != ignore_idx
    in_range = (target >= 0) & (target < c)
    safe = torch.where(in_range, target, 0)
    picked = torch.where(in_range, col.gather(-1, safe[..., None]).squeeze(-1), 0.0)
    loss = lse - picked
    if ls > 0.0:
        loss = (1.0 - ls) * loss + ls * (lse - col.sum(-1) / c)
    if class_wts is not None:
        loss = loss * torch.where(in_range, class_wts[safe], 0.0)
    loss = torch.where(valid, loss, 0.0)
    return loss.double().sum().item(), int(valid.sum()), int((under & valid).sum())


def _spread_inputs(seed, c=13):
    """Head logits spread uniformly over ±100 with one class at 300 in a fifth
    of the head pixels (as chip_smoke.seg_ce_spread makes them on the card):
    beside a hot head pixel the bound lies tens of units above the max."""
    logits, target = _inputs(2, 8, 8, c, 64, seed=seed)
    rng = np.random.default_rng(seed + 100)
    logits = rng.uniform(-100.0, 100.0, logits.shape).astype(np.float32)
    hot = rng.random(logits.shape[:3]) < 0.2
    cls = rng.integers(0, c, logits.shape[:3])
    b, i, j = np.nonzero(hot)
    logits[b, i, j, cls[hot]] = 300.0
    return logits, target


def _emulated_and_plain(logits, target, wts, ls, fallback=True):
    big = target.shape[-1]
    hmid = h_interp(torch.from_numpy(logits), resize_matrix(big, logits.shape[1]))
    aw = resize_matrix(big, logits.shape[2])
    t = torch.from_numpy(target)
    cw = None if wts is None else torch.from_numpy(wts)
    got = _emulate_forward(hmid, interp_taps(aw), t, cw, 255, ls, fallback)
    ref_sum, ref_n = seg_ce_fwd_plain(hmid, aw, t, cw, 255, ls)
    return got, (ref_sum.item(), int(ref_n.item()))


@pytest.mark.parametrize("use_wts", [False, True], ids=["no_wts", "class_wts"])
@pytest.mark.parametrize("ls", [0.0, 0.1], ids=["ls0", "ls0.1"])
def test_forward_algorithm_matches_plain_and_jax_pallas_interpret(ls, use_wts):
    """The one-pass bounded forward against ``seg_ce_fwd_plain`` (float32 sums
    in another order: 1e-6 relative) and, as a mean, against the Pallas kernel
    in interpret mode (LOSS_RTOL); no pixel needs the fallback here."""
    import jax.numpy as jnp

    logits, target = _inputs(2, 8, 8, 13, 64, seed=20)
    wts = _class_wts(target, 13) if use_wts else None
    (loss_sum, n_valid, n_under), (ref_sum, ref_n) = _emulated_and_plain(logits, target, wts, ls)
    assert n_under == 0 and n_valid == ref_n
    assert loss_sum == pytest.approx(ref_sum, rel=1e-6)
    jax_loss, _ = _jax_pallas(logits, target, ls, wts, jnp.float32)
    assert loss_sum / n_valid == pytest.approx(jax_loss, rel=LOSS_RTOL)


@pytest.mark.parametrize("ls,use_wts", [(0.0, False), (0.1, True)])
def test_forward_algorithm_takes_the_fallback_on_spread_logits(ls, use_wts):
    """Logits spread over ±100 with hot classes at 300: some pixels' sums
    under the bound underflow (without the fallback the loss is not finite);
    with it, the loss matches the plain version within 1e-6 relative and the
    Pallas kernel in interpret mode within LOSS_RTOL."""
    import jax.numpy as jnp

    logits, target = _spread_inputs(seed=21)
    wts = _class_wts(target, 13) if use_wts else None
    (loss_sum, n_valid, n_under), (ref_sum, ref_n) = _emulated_and_plain(logits, target, wts, ls)
    assert n_under > 0 and n_valid == ref_n
    assert loss_sum == pytest.approx(ref_sum, rel=1e-6)
    jax_loss, _ = _jax_pallas(logits, target, ls, wts, jnp.float32)
    assert loss_sum / n_valid == pytest.approx(jax_loss, rel=LOSS_RTOL)
    (no_fallback, _, _), _ = _emulated_and_plain(logits, target, wts, ls, fallback=False)
    assert not np.isfinite(no_fallback)


@pytest.mark.parametrize("out_size,in_size", [(64, 8), (512, 32), (32, 4), (40, 5), (8, 8),
                                              (5, 12), (7, 64), (300, 7), (512, 64), (12, 5),
                                              (2, 3)])
def test_weighted_column_maxima_bound_every_logit(out_size, in_size):
    """For every resize of this file, A_w's weights are nonnegative, so for
    each output pixel j, ``sum_k A_w[j, k] max_c hmid[k, c]`` is at least
    ``max_c (A_w hmid)[j, c]`` (in float64, exactly); where the kernels take
    the matrix, the taps' form of the bound is the same sum."""
    a = resize_matrix_weights(out_size, in_size).double()
    assert bool((a >= 0).all())
    rng = np.random.default_rng(out_size * 100 + in_size)
    hmid = torch.from_numpy(rng.uniform(-50.0, 50.0, (3, in_size, 17)))
    hmid[:, rng.integers(0, in_size), rng.integers(0, 17)] = 200.0
    bound = a @ hmid.amax(-1, keepdim=True)
    assert bool((bound >= (a @ hmid).amax(-1, keepdim=True)).all())
    if band_width(a.numpy()) <= 16:
        taps = interp_taps(a.float())
        via_taps = (taps.wt.double()[None] * hmid.amax(-1)[:, taps.idx.long()]).sum(-1)
        torch.testing.assert_close(via_taps, bound.squeeze(-1), rtol=1e-6, atol=1e-9)


def test_interp_taps_rejects_a_negative_weight():
    """A band whose row has a negative lobe (a cubic filter's) would break
    the forward's bound on a pixel's max."""
    a = torch.zeros((6, 8))
    for j in range(6):
        a[j, j:j + 3] = torch.tensor([-0.1, 0.8, 0.3])
    with pytest.raises(ValueError, match="negative weight"):
        interp_taps(a)


@pytest.mark.parametrize("ignored", [0.0, 0.05, 0.5, 1.0])
def test_seg_ce_bounds_count_exponentials_of_pixels_that_are_not_ignored(ignored):
    """``chip_smoke.seg_ce_bounds`` at DeepLabv3's shape: both kernels skip an
    ignored pixel, so the bound counts C exponentials for each other pixel,
    and the bytes of the whole inputs (and dhm) where that takes longer."""
    import chip_smoke

    g = torch.Generator().manual_seed(0)
    c = 150
    logits = torch.randn((8, 32, 32, c), generator=g)
    target = torch.randint(0, c, (8, 512, 512), generator=g)
    target.view(-1)[:int(ignored * target.numel())] = 255
    exps = int((target != 255).sum()) * c
    label_bytes = target.numel() * 8
    hmid_bytes = 8 * 512 * 32 * c * 4
    bounds = chip_smoke.seg_ce_bounds(logits, target)
    for p, n_bytes in (("fwd", logits.numel() * 4 + label_bytes + 8),
                       ("bwd", 2 * hmid_bytes + label_bytes)):
        ms_ops = 1e3 * exps / chip_smoke.SFU_EXP_S
        ms_bytes = 1e3 * n_bytes / chip_smoke.HBM_BYTES_S
        assert bounds[p][0] == pytest.approx(max(ms_ops, ms_bytes), rel=1e-12)
        assert bounds[p][1] == ("bytes" if ms_bytes >= ms_ops else "operations")


@pytest.mark.parametrize("w,c", [(32, 150), (32, 21), (16, 3631), (41, 1417), (1, 1), (0, 0)])
def test_fwd_smem_is_the_cuda_formula(w, c):
    """``_fwd_smem`` against ``fwd_smem`` of csrc/seg_ce.cu, its expression
    read from the source and evaluated (the launch and the dispatch rule must
    agree on what fits)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "cvnets_tpu_torch", "csrc", "seg_ce.cu")
    src = open(path).read()
    min_smem = int(re.search(r"constexpr int kFwdMinSmem = (\d+);", src).group(1))
    assert min_smem == _FWD_MIN_SMEM
    expr = re.search(r"size_t fwd_smem\(int w, int C\) \{\s*return (.*?);\s*\}", src,
                     re.S).group(1)
    expr = (expr.replace("std::max<size_t>", "max").replace("static_cast<size_t>(w)", "w")
            .replace("sizeof(float)", "4").replace("kFwdMinSmem", str(min_smem)))
    assert _fwd_smem(w, c) == eval(expr, {"max": max}, {"w": w, "C": c})


@pytest.mark.parametrize("kernel", [seg_ce_fwd_kernel, seg_ce_bwd_kernel],
                         ids=["forward", "backward"])
def test_bindings_match_the_c_entry_points(kernel):
    """The ctypes argument types of each wrapper, the stream last, against the
    parameters of its ``extern "C"`` entry point in csrc/seg_ce.cu (a count or
    type off by one shifts every later argument)."""
    import ctypes

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "cvnets_tpu_torch", "csrc", "seg_ce.cu")
    src = open(path).read()
    params = re.search(rf'extern "C" int {kernel._symbol}\((.*?)\)\s*\{{', src, re.S).group(1)
    kinds = {"void*": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong,
             "float": ctypes.c_float}
    want = [kinds[re.sub(r"^const |\s*\w+$", "", p.strip()).replace(" *", "*")]
            for p in params.split(",")]
    assert kernel._argtypes == want


def _walk_rows(taps, plan, g):
    """What the backward kernel's warps store for one row, in float64: each
    warp walks its output columns in order with ``taps.taps`` accumulators,
    stores a column once its k0 has passed, to dhm or, where another warp
    touches the column, to its slot; then every shared column's slots are
    summed in warp order. Also counts the writes of each column."""
    tab = plan.table.numpy()
    walks = tab[:_WALK * plan.warps].reshape(plan.warps, _WALK)
    slots = tab[_WALK * plan.warps:][:plan.n_slot_map]
    shared = tab[_WALK * plan.warps + plan.n_slot_map:]
    shared_k, shared_ptr = shared[:plan.n_shared], shared[plan.n_shared:]
    k0, band, c = taps.k0.numpy(), taps.band.numpy().astype(np.float64), g.shape[1]
    dhm, writes = np.zeros((taps.n_in, c)), np.zeros(taps.n_in, int)
    edge = np.full((plan.n_slots, c), np.nan)
    for j_lo, j_hi, k_lo, k_hi, offset in walks:
        acc, base = np.zeros((taps.taps, c)), k_lo
        for j in [*range(j_lo, j_hi), None]:
            if j is not None and not g[j].any():
                continue  # a pixel with no gradient is skipped
            while base < (k_hi if j is None else k0[j]):
                slot = slots[offset + base - k_lo]
                if slot < 0:
                    dhm[base] = acc[0]
                    writes[base] += 1
                else:
                    edge[slot] = acc[0]
                acc, base = np.concatenate([acc[1:], np.zeros((1, c))]), base + 1
            if j is not None:
                acc += band[j][:, None] * g[j][None, :]
    for r, k in enumerate(shared_k):
        dhm[k] = edge[shared_ptr[r]:shared_ptr[r + 1]].sum(axis=0)
        writes[k] += 1
    return dhm, writes


@pytest.mark.parametrize("out_size,in_size", [(512, 32), (512, 64), (300, 7), (5, 12), (40, 5),
                                              (8, 8), (2, 3)])
def test_band_plans_cover_every_column_once_and_rebuild_the_product(out_size, in_size):
    """Every plan ``interp_taps`` builds (8 warps down to 1), walked as the
    backward kernel walks it, writes each input column exactly once and
    gives A_wᵀ G, pixels without a gradient skipped."""
    a = resize_matrix_weights(out_size, in_size)
    taps = interp_taps(a)
    g = np.random.default_rng(out_size).standard_normal((out_size, 3))
    g[np.random.default_rng(in_size).random(out_size) < 0.2] = 0.0
    assert [p.warps for p in taps.plans][-1] == 1 and taps.plans[-1].n_slots == 0
    for plan in taps.plans:
        dhm, writes = _walk_rows(taps, plan, g)
        np.testing.assert_array_equal(writes, 1)
        np.testing.assert_allclose(dhm, a.double().numpy().T @ g, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("c", [1, 21, 24, 25, 97, 150, 161, 434])
@pytest.mark.parametrize("taps", [2, 4, 8, 16])
def test_backward_lanes_pick_an_instance_that_holds_every_class(c, taps):
    """The backward's (pixels a warp step, classes a lane) is one of the
    kernel's instances and its lanes hold C in one group where C ≤ 160; four
    pixels a step at C ≤ 24 with 2 taps (C 21: 3 of 32 lanes idle, not 11)."""
    from cvnets_tpu_torch.ops.seg_ce_kernel import _BWD_LANES, _bwd_lanes

    group, classes = _bwd_lanes(c, taps)
    assert classes in _BWD_LANES[group] and (group == 1 or taps == 2)
    assert 32 // group * classes >= c or (group, classes) == (1, 5)
    assert (group == 4) == (taps == 2 and c <= 24)


def test_kernel_wrappers_reject_cpu_tensors_without_counting():
    logits, target = _inputs(1, 4, 4, 5, 16, seed=7)
    hmid = h_interp(torch.from_numpy(logits), resize_matrix(16, 4))
    taps = interp_taps(resize_matrix(16, 4))
    t = torch.from_numpy(target)
    before = seg_ce_fwd_kernel.launches, seg_ce_bwd_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        seg_ce_fwd_kernel(torch.from_numpy(logits), t, taps, taps, None, 255, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        seg_ce_bwd_kernel(hmid, t, taps, None, torch.ones(1), 255, 0.0)
    fused_resize_ce(torch.from_numpy(logits).requires_grad_(), t).backward()
    assert (seg_ce_fwd_kernel.launches, seg_ce_bwd_kernel.launches) == before


@pytest.mark.parametrize("w,big_w,c,ok", [
    (32, 4, 21, True), (33, 4, 21, False),  # W-resize rows of 16 and 17 input columns
    # the forward's row and column maxima, w·(C + 1) floats: 58,112 (w·C =
    # 58,096) fits, 58,138 (w·C = 58,097) and 58,113 do not; 58,110 (w·C =
    # 58,097 at w 13) fits
    (16, 32, 3631, True), (41, 82, 1417, False), (9, 18, 6456, False), (13, 26, 4469, True),
    (32, 512, 150, True),  # DeepLabv3 at 512², OS 16
], ids=["taps16", "taps17", "row_58096", "row_58097", "cols_58113", "row_58097_w13",
        "deeplabv3"])
def test_seg_ce_eligible_at_the_edge_of_each_limit(w, big_w, c, ok):
    """Eligible exactly where both kernels take the shape: the taps table is
    built (at most 16 columns a row), the forward's row and its column maxima
    fit its shared memory and a backward plan fits; the H-resize takes any
    size."""
    a = resize_matrix_weights(big_w, w)
    if band_width(a.numpy()) > 16:
        with pytest.raises(ValueError, match="at most 16"):
            interp_taps(a)
        fits = False
    else:
        fits = _fwd_smem(w, c) <= _MAX_SMEM and _bwd_plan(interp_taps(a), w, c) is not None
    assert fits is ok
    assert seg_ce_eligible(8, w, 64, big_w, c) is ok
    assert seg_ce_eligible(3, w, 1000, big_w, c) is ok


@pytest.mark.parametrize("h,ok", [(32, True), (33, False)], ids=["taps16", "taps17"])
def test_seg_ce_eligible_at_the_edge_of_the_h_resize(h, ok):
    """The forward reads A_h as taps too: an H-resize row of 16 input rows is
    eligible, one of 17 is not, whatever the W-resize."""
    assert seg_ce_eligible(h, 32, 4, 512, 21) is ok
    assert seg_ce_eligible(h, 7, 4, 300, 150) is ok


# (B, C, h, w, H, W) past a kernel limit: a W-resize row of 17 input columns, and
# a row of hmid of 64 × 1,817 = 116,288 floats
PAST_LIMIT = {"taps17": (2, 5, 6, 33, 12, 4), "row_past_smem": (1, 1817, 2, 64, 4, 128)}


@pytest.mark.parametrize("case", list(PAST_LIMIT))
def test_seg_loss_past_a_kernel_limit_takes_the_plain_route_and_matches_jax(case, monkeypatch):
    """With ``fused_resize_ce`` patched to fail (the dispatch is the same on the
    CPU), ``SegCrossEntropy`` computes such a shape through the unfused plain
    version: loss and d/dlogits against the JAX loss (its scan path), at the
    float32 tolerances above. An eligible shape reaches the patched entry."""
    import sys

    import jax
    import jax.numpy as jnp

    sys.path.insert(0, "tests")
    from torch_port_helpers import both_opts

    from cvnets_tpu.loss.segmentation import SegCrossEntropy as JaxSegCE
    from cvnets_tpu_torch.loss import segmentation

    b, c, h, w, big_h, big_w = PAST_LIMIT[case]
    assert not seg_ce_eligible(h, w, big_h, big_w, c)
    rng = np.random.default_rng(11)
    logits = (2.0 * rng.standard_normal((b, h, w, c))).astype(np.float32)
    target = rng.integers(0, c, (b, big_h, big_w))
    target = np.where(rng.random(target.shape) < 0.1, 255, target)
    opts_jax, opts_torch = both_opts(["--loss.segmentation.cross-entropy.label-smoothing",
                                      "0.1"])

    def refuse(*args, **kwargs):
        raise AssertionError("fused_resize_ce was called")

    monkeypatch.setattr(segmentation, "fused_resize_ce", refuse)
    criterion = segmentation.SegCrossEntropy(opts_torch)
    x = torch.from_numpy(np.ascontiguousarray(logits.transpose(0, 3, 1, 2))).requires_grad_()
    loss = criterion(None, x, torch.from_numpy(target))
    loss.backward()
    jloss = JaxSegCE(opts_jax)
    v, g = jax.value_and_grad(lambda lo: jloss(None, lo, jnp.asarray(target.astype(np.int32))))(
        jnp.asarray(logits))
    assert loss.item() == pytest.approx(float(v), rel=LOSS_RTOL)
    np.testing.assert_allclose(x.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g),
                               atol=GRAD_ATOL, rtol=0)
    with pytest.raises(AssertionError, match="fused_resize_ce"):
        criterion(None, x[..., :2, :4], torch.from_numpy(target[:, :8, :8]))


# ---------------------------------------------------------------- on a card

def _cuda_case(ls, use_wts, seed=0):
    """DeepLabv3-MobileViTv2 at 512², OS 16: hmid (8, 512, 32, 150) float32 from
    head logits (8, 32, 32, 150); 5% ignored pixels and one fully ignored image."""
    from cvnets_tpu_torch.loss.base_criteria import BaseCriteria

    g = torch.Generator(device="cuda").manual_seed(seed)
    logits = 2.0 * torch.randn((8, 32, 32, 150), generator=g, device="cuda")
    target = torch.randint(0, 150, (8, 512, 512), generator=g, device="cuda")
    target[torch.rand((8, 512, 512), generator=g, device="cuda") < 0.05] = 255
    target[3] = 255
    wts = (BaseCriteria._class_weights(torch.where(target == 255, 0, target), 150)
           if use_wts else None)
    return logits, target, wts


@pytest.mark.cuda
@pytest.mark.parametrize("ls,use_wts", [(0.0, False), (0.1, False), (0.0, True), (0.1, True)])
def test_kernels_match_plain_on_cuda(ls, use_wts):
    """Loss sums in another order over 1.9 M pixels (1e-5 relative); dhm sums up
    to 32 terms per element in another order (1e-6 of its largest value)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    from cvnets_tpu_torch.ops.seg_ce import resize_taps

    logits, target, wts = _cuda_case(ls, use_wts)
    ah, aw = resize_matrix(512, 32, logits.device), resize_matrix(512, 32, logits.device)
    hmid = h_interp(logits, ah)
    taps = resize_taps(512, 32, logits.device)
    before = seg_ce_fwd_kernel.launches, seg_ce_bwd_kernel.launches
    nchw = logits.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)  # as the loss passes it
    loss_sum, n_valid = seg_ce_fwd_kernel(nchw, target, taps, taps, wts, 255, ls)
    scale = (1.0 / n_valid).reshape(1)
    dhm = seg_ce_bwd_kernel(hmid, target, taps, wts, scale, 255, ls)
    torch.cuda.synchronize()
    assert (seg_ce_fwd_kernel.launches, seg_ce_bwd_kernel.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    ref_sum, ref_n = seg_ce_fwd_plain(hmid, aw, target, wts, 255, ls)
    assert n_valid.item() == ref_n.item()
    assert loss_sum.item() == pytest.approx(ref_sum.item(), rel=1e-5)
    ref_dhm = seg_ce_bwd_plain(hmid, aw, target, wts, scale, 255, ls)
    torch.testing.assert_close(dhm, ref_dhm, rtol=0,
                               atol=1e-6 * ref_dhm.abs().max().item())
    again = seg_ce_fwd_kernel(nchw, target, taps, taps, wts, 255, ls)[0]
    assert torch.equal(again, loss_sum)  # no atomics: the same bits every run
    assert torch.equal(seg_ce_bwd_kernel(hmid, target, taps, wts, scale, 255, ls), dhm)


# (W, w, C): C 21 (the pascal_voc recipes at 512², OS 16 and OS 8), W 300 from
# w 7 (warp runs of 37 and 38 columns), a downsampling A_w (5 from 12, 8 taps,
# fewer pixels than warps), C 300 (two groups of classes a lane) and C 434 at
# w 32 (the largest C the previous backward's shared memory took)
BACKWARD_SHAPES = {"c21_w32": (512, 32, 21), "c21_w64": (512, 64, 21),
                   "w300_from7": (300, 7, 150), "down_5_from12": (5, 12, 150),
                   "c300": (512, 32, 300), "c434": (512, 32, 434)}


@pytest.mark.cuda
@pytest.mark.parametrize("ls,use_wts", [(0.0, False), (0.1, True)])
@pytest.mark.parametrize("shape", list(BACKWARD_SHAPES))
def test_backward_kernel_matches_plain_at_every_shape_on_cuda(shape, ls, use_wts):
    """dhm against ``seg_ce_bwd_plain`` (1e-6 of its largest value, as above)
    and the same bits on a second call, with targets outside [0, C) that are
    not the ignore index, fully ignored rows and a fully ignored image."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    from cvnets_tpu_torch.loss.base_criteria import BaseCriteria
    from cvnets_tpu_torch.ops.seg_ce import resize_taps

    big_w, w, c = BACKWARD_SHAPES[shape]
    g = torch.Generator(device="cuda").manual_seed(big_w + w + c)
    hmid = 2.0 * torch.randn((2, 512, w, c), generator=g, device="cuda")
    target = torch.randint(0, c, (2, 512, big_w), generator=g, device="cuda")
    target[torch.rand(target.shape, generator=g, device="cuda") < 0.05] = 255
    target[0, 7, ::3] = c + 7  # outside [0, C), not ignored
    target[0, 9, 1::3] = -3
    target[0, 20:23] = 255  # fully ignored rows
    target[1, 100:] = 255
    wts = (BaseCriteria._class_weights(torch.where((target < 0) | (target >= c), 0, target), c)
           if use_wts else None)
    aw = resize_matrix(big_w, w, hmid.device)
    taps = resize_taps(big_w, w, hmid.device)
    scale = torch.full((1,), 1.0 / 3e5, device="cuda")
    dhm = seg_ce_bwd_kernel(hmid, target, taps, wts, scale, 255, ls)
    again = seg_ce_bwd_kernel(hmid, target, taps, wts, scale, 255, ls)
    ref = seg_ce_bwd_plain(hmid, aw, target, wts, scale, 255, ls)
    torch.cuda.synchronize()
    torch.testing.assert_close(dhm, ref, rtol=0, atol=1e-6 * ref.abs().max().item())
    assert torch.equal(dhm, again)
    assert not dhm[0, 20:23].any() and not dhm[1, 100:].any()


# (H, h, W, w, C) of the forward: BACKWARD_SHAPES' W-resizes with H 512 from
# 32, and an H-resize of more taps than the W-resize (8 and 2: the kernel reads
# both tables at 8)
FORWARD_SHAPES = {**{k: (512, 32, *v) for k, v in BACKWARD_SHAPES.items()},
                  "h_down_5_from12": (5, 12, 512, 32, 150)}


def _forward_case(shape, nchw=True):
    """Head logits (2, h, w, C), a permuted view of NCHW storage as the loss
    passes them (or contiguous NHWC), and labels (2, H, W) with targets
    outside [0, C) that are not the ignore index and fully ignored rows."""
    big_h, h, big_w, w, c = FORWARD_SHAPES[shape]
    g = torch.Generator(device="cuda").manual_seed(big_h + h + big_w + w + c)
    logits = 2.0 * torch.randn((2, c, h, w) if nchw else (2, h, w, c), generator=g,
                               device="cuda")
    logits = logits.permute(0, 2, 3, 1) if nchw else logits
    target = torch.randint(0, c, (2, big_h, big_w), generator=g, device="cuda")
    target[torch.rand(target.shape, generator=g, device="cuda") < 0.05] = 255
    target[0, 1, ::3] = c + 7
    target[0, 2, 1::3] = -3
    target[0, 3:4] = 255
    return logits, target


def _assert_forward_matches_plain(logits, target, cw, ls):
    """(loss_sum, n_valid) against ``seg_ce_fwd_plain(h_interp(…))``: float32
    terms summed in another order (1e-6 relative), the count exact, the same
    bits on a second call, one launch counted a call."""
    from cvnets_tpu_torch.ops.seg_ce import resize_taps

    (big_h, big_w), (h, w) = target.shape[1:], logits.shape[1:3]
    ah, aw = resize_matrix(big_h, h, logits.device), resize_matrix(big_w, w, logits.device)
    ah_taps, aw_taps = resize_taps(big_h, h, logits.device), resize_taps(big_w, w, logits.device)
    before = seg_ce_fwd_kernel.launches
    loss_sum, n_valid = seg_ce_fwd_kernel(logits, target, ah_taps, aw_taps, cw, 255, ls)
    again = seg_ce_fwd_kernel(logits, target, ah_taps, aw_taps, cw, 255, ls)
    torch.cuda.synchronize()
    assert seg_ce_fwd_kernel.launches == before + 2
    ref_sum, ref_n = seg_ce_fwd_plain(h_interp(logits, ah), aw, target, cw, 255, ls)
    assert n_valid.item() == ref_n.item()
    assert loss_sum.item() == pytest.approx(ref_sum.item(), rel=1e-6, abs=1e-6)
    assert torch.equal(loss_sum, again[0]) and torch.equal(n_valid, again[1])
    return loss_sum, n_valid


@pytest.mark.cuda
@pytest.mark.parametrize("ls,use_wts", [(0.0, False), (0.1, True)])
@pytest.mark.parametrize("shape", list(FORWARD_SHAPES))
def test_forward_kernel_matches_plain_at_every_shape_on_cuda(shape, ls, use_wts):
    """The forward at C 21, 150, 300 and 434, W 300 from 7, 5 from 12 and H 5
    from 12, on logits laid out as the loss passes them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    from cvnets_tpu_torch.loss.base_criteria import BaseCriteria

    logits, target = _forward_case(shape)
    c = logits.shape[-1]
    wts = (BaseCriteria._class_weights(torch.where((target < 0) | (target >= c), 0, target), c)
           if use_wts else None)
    _assert_forward_matches_plain(logits, target, wts, ls)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["c21_w32", "down_5_from12"])
def test_forward_kernel_reads_contiguous_nhwc_logits_on_cuda(shape):
    """Logits whose classes, not pixels, lie next to each other: the kernel
    walks an image along its classes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    logits, target = _forward_case(shape, nchw=False)
    assert logits.is_contiguous()
    _assert_forward_matches_plain(logits, target, None, 0.1)


@pytest.mark.cuda
def test_forward_kernel_on_a_fully_ignored_image_on_cuda():
    """Every label ignored: (0, 0) exactly, one launch, the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    logits, target = _forward_case("w300_from7")
    target[:] = 255
    loss_sum, n_valid = _assert_forward_matches_plain(logits, target, None, 0.1)
    assert loss_sum.item() == 0.0 and n_valid.item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("ls,use_wts", [(0.0, False), (0.1, True)])
def test_forward_kernel_takes_the_fallback_on_spread_logits_on_cuda(ls, use_wts):
    """DeepLabv3's shape with head logits spread over ±100 and a class at 300
    in a fifth of the head pixels (``chip_smoke.seg_ce_spread``): pixels whose
    sum under the bound underflows take the kernel's two passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    import chip_smoke
    from cvnets_tpu_torch.loss.base_criteria import BaseCriteria

    g = torch.Generator(device="cuda").manual_seed(9)
    logits, target = chip_smoke.seg_ce_spread(g, 150)
    wts = (BaseCriteria._class_weights(torch.where(target == 255, 0, target), 150)
           if use_wts else None)
    aw = resize_matrix(512, 32, logits.device)
    assert chip_smoke.seg_ce_underflows(h_interp(logits, aw), aw, target) > 0
    _assert_forward_matches_plain(logits, target, wts, ls)


@pytest.mark.cuda
def test_backward_kernel_matches_plain_under_every_plan_on_cuda(monkeypatch):
    """Every plan of the DeepLabv3 table (8, 4, 2 and 1 warps a row) against
    the plain version: the slots of the columns two warps share, and the
    fallbacks for rows too wide for 8 warps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    from cvnets_tpu_torch.ops import seg_ce_kernel
    from cvnets_tpu_torch.ops.seg_ce import resize_taps

    logits, target, wts = _cuda_case(0.1, True, seed=2)
    aw = resize_matrix(512, 32, logits.device)
    hmid = h_interp(logits, resize_matrix(512, 32, logits.device))
    taps = resize_taps(512, 32, logits.device)
    scale = torch.full((1,), 1.0 / 2e6, device="cuda")
    ref = seg_ce_bwd_plain(hmid, aw, target, wts, scale, 255, 0.1)
    for plan in taps.plans:
        monkeypatch.setattr(seg_ce_kernel, "_bwd_plan", lambda *a: plan)
        dhm = seg_ce_bwd_kernel(hmid, target, taps, wts, scale, 255, 0.1)
        torch.cuda.synchronize()
        torch.testing.assert_close(dhm, ref, rtol=0, atol=1e-6 * ref.abs().max().item(),
                                   msg=lambda m: f"{plan.warps} warps: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dispatcher_on_cuda_runs_the_kernels_and_never_the_plain_versions(dtype, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    from cvnets_tpu_torch.ops import seg_ce_kernel

    logits, target, _ = _cuda_case(0.1, False, seed=1)
    x = logits.to(dtype).requires_grad_()
    want = resize_ce_plain(x.detach().float(), target, label_smoothing=0.1)

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(seg_ce_kernel, "seg_ce_fwd_plain", refuse)
    monkeypatch.setattr(seg_ce_kernel, "seg_ce_bwd_plain", refuse)
    before = seg_ce_fwd_kernel.launches, seg_ce_bwd_kernel.launches
    loss = fused_resize_ce(x, target, label_smoothing=0.1)
    loss.backward()
    torch.cuda.synchronize()
    assert (seg_ce_fwd_kernel.launches, seg_ce_bwd_kernel.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    assert x.grad.dtype == dtype and bool(torch.isfinite(x.grad).all())
    assert loss.item() == pytest.approx(want.item(), rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(PAST_LIMIT))
def test_seg_loss_past_a_kernel_limit_runs_on_cuda_without_the_kernels(case):
    """Where the kernels used to raise, the loss on the card computes through
    the plain route: finite, equal to ``resize_ce_plain`` on the same logits,
    and neither kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    from cvnets_tpu_torch.loss.segmentation import SegCrossEntropy
    from cvnets_tpu_torch.options.opts import get_training_arguments

    b, c, h, w, big_h, big_w = PAST_LIMIT[case]
    g = torch.Generator(device="cuda").manual_seed(5)
    x = (2.0 * torch.randn((b, c, h, w), generator=g, device="cuda")).requires_grad_()
    target = torch.randint(0, c, (b, big_h, big_w), generator=g, device="cuda")
    target[torch.rand(target.shape, generator=g, device="cuda") < 0.1] = 255
    criterion = SegCrossEntropy(get_training_arguments(args=[]))
    before = seg_ce_fwd_kernel.launches, seg_ce_bwd_kernel.launches
    loss = criterion(None, x, target)
    loss.backward()
    torch.cuda.synchronize()
    assert (seg_ce_fwd_kernel.launches, seg_ce_bwd_kernel.launches) == before
    assert bool(torch.isfinite(loss)) and bool(torch.isfinite(x.grad).all())
    want = resize_ce_plain(x.detach().permute(0, 2, 3, 1), target)
    assert loss.item() == pytest.approx(want.item(), rel=1e-6)  # the same ops on one card
