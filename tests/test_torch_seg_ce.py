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
* On a CUDA card only: the kernels against their plain versions at the
  DeepLabv3 shapes (dhm the same bits on a second call), the backward at C 21,
  W 300 from 7, 5 from 12, C 300 and 434 and under every plan, and the
  dispatcher launching the kernels, never the plain versions:
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
    _WALK,
    h_interp,
    interp_taps,
    seg_ce_bwd_kernel,
    seg_ce_bwd_plain,
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
        seg_ce_fwd_kernel(hmid, t, taps, None, 255, 0.0)
    with pytest.raises(ValueError, match="CUDA"):
        seg_ce_bwd_kernel(hmid, t, taps, None, torch.ones(1), 255, 0.0)
    fused_resize_ce(torch.from_numpy(logits).requires_grad_(), t).backward()
    assert (seg_ce_fwd_kernel.launches, seg_ce_bwd_kernel.launches) == before


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
    loss_sum, n_valid = seg_ce_fwd_kernel(hmid, target, taps, wts, 255, ls)
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
    again = seg_ce_fwd_kernel(hmid, target, taps, wts, 255, ls)[0]
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
