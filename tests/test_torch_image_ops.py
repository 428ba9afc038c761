"""The port's device-tier augmentation ops (``cvnets_tpu_torch/ops/image_ops.py``)
against the JAX package's (``cvnets_tpu/ops/image_ops.py``), float32 on the CPU:

* each of the 14 RandAugment ops at a fixed op, magnitude and sign against
  ``_randaug_apply`` (one parametrised test): 2e-6 for the photometric ops
  (float32 rounding), 1e-5 for the affine ones (the pixel grid goes through
  ``grid_sample``'s [-1, 1] coordinates and back), one float32 ulp of 1.0 for
  the LUT ops (the same level, divided by 255 in another order);
* the batched RandAugment, grouped by op from host-drawn indices, equal to the
  same ops applied one image at a time, bit for bit;
* the LUT ops against Pillow (the goldens of tests/test_image_ops_golden.py),
  exactly.

Card tests (``-m cuda``, skipped without a card; JAX is imported inside the
tests that use it, so that ``python -m pytest --noconftest -m cuda
tests/test_torch_image_ops.py`` runs where JAX is absent): each op, RandAugment
grouped and random erasing on CUDA against the same call on the CPU at the
flagship's 128 × 3 × 256².
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cvnets_tpu_torch.ops import image_ops as O

AFFINE_OPS = (1, 2, 3, 4, 5)
LUT_OPS = (10, 11, 13)  # posterize, solarize, equalize


def _batch(seed=0, n=3, h=40, w=48):
    """NHWC float32 in [0, 1] on the uint8 grid, with one image of a narrow range
    (autocontrast stretches it) and one flat channel (equalize's identity)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, h, w, 3)).astype(np.float32) / 255.0
    x[1] = 0.2 + 0.3 * x[1]
    x[2, ..., 1] = 7 / 255.0
    return x


@pytest.fixture(scope="module")
def jax_randaug():
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.ops.image_ops import _randaug_apply

    fn = jax.jit(jax.vmap(_randaug_apply, in_axes=(0, None, None, None)))
    return lambda x, op, mag, sign: np.asarray(fn(jnp.asarray(x), op, jnp.float32(mag),
                                                  jnp.float32(sign)))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("mag,sign", [(0.3, 0.9), (0.3, 0.1), (0.8, 0.7)])
@pytest.mark.parametrize("op", range(O.N_OPS))
def test_each_randaugment_op_matches_jax(jax_randaug, op, mag, sign):
    x = _batch()
    want = jax_randaug(x, op, mag, sign)
    got = _nhwc(O.randaug_op(_nchw(x), op, mag, sign))
    # the same with per-image tensors, as the grouped batch passes them
    n = x.shape[0]
    got_t = _nhwc(O.randaug_op(_nchw(x), op, torch.full((n,), mag), torch.full((n,), sign)))
    tol = 0.0 if op == 0 else 1.2e-7 if op in LUT_OPS else 1e-5 if op in AFFINE_OPS else 2e-6
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    np.testing.assert_allclose(got_t, want, atol=tol, rtol=0)
    if op:
        assert np.abs(got - x).max() > 0.005  # the op did something


def test_rotate_by_ninety_degrees_is_rot90():
    x = _batch(3, h=32, w=32)
    got = _nhwc(O.rotate(_nchw(x), 90.0))
    np.testing.assert_allclose(got, np.rot90(x, 1, axes=(1, 2)), atol=1e-5, rtol=0)


@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_grouped_randaugment_equals_the_ops_one_image_at_a_time(rounds):
    rng = np.random.default_rng(rounds)
    n = 42
    x = _nchw(_batch(rounds, n=n, h=24, w=20))
    op_idx = rng.integers(0, O.N_OPS, (n, rounds))
    op_idx[:, 0] = rng.permutation(np.arange(n) % O.N_OPS)  # every op by three images
    mag = rng.random((n, rounds), dtype=np.float32)
    sign = rng.random((n, rounds), dtype=np.float32)
    got = O.apply_randaug_ops(x, op_idx, mag, sign)
    for i in range(n):
        want = x[i:i + 1]
        for k in range(rounds):
            want = O.randaug_op(want, int(op_idx[i, k]), torch.tensor(mag[i, k:k + 1]),
                                torch.tensor(sign[i, k:k + 1]))
        torch.testing.assert_close(got[i:i + 1], want, atol=0, rtol=0)
    assert len(set(op_idx[:, 0].tolist())) == O.N_OPS
    x_before = x.clone()
    O.apply_randaug_ops(x, op_idx, mag, sign)
    assert torch.equal(x, x_before)  # the input is not written


def test_all_identity_leaves_the_batch_as_it_is():
    x = _nchw(_batch())
    zeros = np.zeros((3, 2))
    assert O.apply_randaug_ops(x, zeros.astype(np.int64), zeros, zeros) is x


def test_rand_augment_and_trivial_augment_draw_from_the_generator():
    x = _nchw(_batch(n=16, h=16, w=16))
    a = O.rand_augment(x, np.random.default_rng(4))
    b = O.rand_augment(x, np.random.default_rng(4))
    c = O.trivial_augment_wide(x, np.random.default_rng(4))
    assert torch.equal(a, b) and not torch.equal(a, x) and not torch.equal(a, c)
    assert a.shape == x.shape and bool(((a >= 0) & (a <= 1)).all())


@pytest.mark.parametrize("seed,shape", [(0, (64, 48, 3)), (7, (33, 57, 3))])
def test_lut_ops_match_pillow_exactly(seed, shape):
    from PIL import Image, ImageOps

    u8 = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    pil = Image.fromarray(u8)
    f = _nchw(u8[None].astype(np.float32) / 255.0)

    def levels_off(ours, ref):
        return float(np.abs(_nhwc(ours.clamp(0, 1))[0] * 255.0
                            - np.asarray(ref, np.float32)).max())

    assert levels_off(O.invert(f), ImageOps.invert(pil)) < 0.5
    assert levels_off(O.solarize(f, 128 / 255.0), ImageOps.solarize(pil, 128)) < 0.5
    for bits in (1, 2, 4, 6, 7):
        assert levels_off(O.posterize(f, bits), ImageOps.posterize(pil, bits)) < 0.5
    assert levels_off(O.equalize(f), ImageOps.equalize(pil)) < 0.5
    assert levels_off(O.autocontrast(f), ImageOps.autocontrast(pil)) <= 1.0  # Pillow truncates
    flat = np.full((16, 16, 3), 7, np.uint8)  # one bin used: the identity, as Pillow
    assert levels_off(O.equalize(_nchw(flat[None].astype(np.float32) / 255.0)),
                      ImageOps.equalize(Image.fromarray(flat))) < 0.5


# ------------------------------------------------------------------ on a card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _card_batch(n=128, size=256):
    g = torch.Generator().manual_seed(0)
    return torch.randint(0, 256, (n, 3, size, size), generator=g).float() / 255.0


@pytest.mark.cuda
@pytest.mark.parametrize("op", range(1, O.N_OPS))
def test_each_op_on_cuda_matches_the_cpu(op):
    """Per-image magnitudes and signs at the flagship's batch. The ops hold no
    product (no TF32), so the two differ by float32 rounding: one ulp of 1.0 for
    solarize and equalize, 1e-4 for the affine ops (the card's cos, sin and
    grid), 2e-6 for the others. Posterize's step q = 2^(8 - bits) rounds a few
    ulps apart on the card (``powf``): its levels then differ by a few ulps
    (1.8e-7 at most on an H100), hence 1e-6, and a pixel lying within them of
    a step may move to the next, so up to 1e-3 of its pixels may differ by
    more, by one step (at most 2^4 levels)."""
    _need_card()
    x = _card_batch()
    g = torch.Generator().manual_seed(op)
    mag, sign = torch.rand(128, generator=g), torch.rand(128, generator=g)
    want = O.randaug_op(x, op, mag, sign)
    got = O.randaug_op(x.cuda(), op, mag.cuda(), sign.cuda()).cpu()
    tol = 1e-6 if op == 10 else 1.2e-7 if op in LUT_OPS else 1e-4 if op in AFFINE_OPS else 2e-6
    diff = (got - want).abs()
    assert (diff > tol).float().mean().item() <= (1e-3 if op == 10 else 0.0), (op, diff.max())
    assert diff.max().item() <= 16 / 255 + 1e-6


@pytest.mark.cuda
def test_grouped_randaugment_and_erasing_on_cuda_match_the_cpu():
    _need_card()
    x = _card_batch()
    rng = np.random.default_rng(0)
    op_idx = rng.integers(0, O.N_OPS, (128, 2))
    mag, sign = np.full((128, 2), 0.3, np.float32), rng.random((128, 2), dtype=np.float32)
    want = O.apply_randaug_ops(x, op_idx, mag, sign)
    got = O.apply_randaug_ops(x.cuda(), op_idx, mag, sign)
    off = (got.cpu() - want).abs() > 1e-4  # posterize's steps, as above
    assert off.float().mean().item() <= 1e-3
    apply = rng.random(128) < 0.25
    area = rng.uniform(0.02, 0.33, 128).astype(np.float32)
    ratio = rng.uniform(np.log(0.3), np.log(3.3), 128).astype(np.float32)
    top, left = rng.integers(0, 256, 128), rng.integers(0, 256, 128)
    noise = torch.randn((int(apply.sum()), 3, 256, 256), generator=torch.Generator().manual_seed(1))
    want = O.apply_random_erasing(x, apply, area, ratio, top, left, noise=noise)
    got = O.apply_random_erasing(x.cuda(), apply, area, ratio, top, left, noise=noise.cuda())
    assert torch.equal(got.cpu(), want)
