"""Random erasing, mixup, cutmix and the soft-target CE of the port
(``cvnets_tpu_torch/ops/image_ops.py``, ``ops/mixing.py``,
``loss/classification.py``) against the JAX package's, float32 on the CPU:

* given the parameters that each JAX op draws, re-derived here from the same
  key with its own splits (the apply flag, area, aspect, corner and noise of
  random erasing; λ of mixup; λ and the box's centre of cutmix), the port's op
  gives the JAX op's images exactly (random erasing: the same boxes, the noise
  within 3e-7, as XLA draws it in another program) and its soft targets within
  1e-7;
* the port's own host draws, statistically: the erased share near p over 4,096
  images (within 4σ), λ's mean of mixup and cutmix beside the JAX op's over
  2,000 draws each, the choice between them near one half, and every soft row
  summing to 1;
* the soft-target CE at label smoothing 0 and 0.1 against the JAX loss (1e-6);
* a micro-MobileViTv2 train step with the flagship's augmentation gives the
  same bits twice from one (seed, step), and other bits at another step.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import SMALL_MODEL_ARGS, both_opts, torch_threads  # noqa: E402

from cvnets_tpu_torch.ops import image_ops as O  # noqa: E402
from cvnets_tpu_torch.ops import mixing as M  # noqa: E402

N_CLASSES = 13


def _batch(seed, n=6, h=24, w=20):
    rng = np.random.default_rng(seed)
    return (rng.random((n, h, w, 3), dtype=np.float32),
            rng.integers(0, N_CLASSES, n))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_erasing_given_the_jax_draws_matches_jax(seed):
    import math

    from cvnets_tpu.ops.image_ops import random_erasing

    x, _ = _batch(seed, n=12)
    n, h, w, _c = x.shape
    key, p = jax.random.PRNGKey(seed), 0.5
    want = np.asarray(jax.jit(lambda k, im: random_erasing(k, im, p=p))(key, jnp.asarray(x)))
    draws = []
    for k in jax.random.split(key, n):
        k_apply, k_area, k_ratio, k_pos, k_noise = jax.random.split(k, 5)
        draws.append((bool(jax.random.uniform(k_apply) < p),
                      np.float32(jax.random.uniform(k_area, minval=0.02, maxval=0.33)),
                      np.float32(jax.random.uniform(k_ratio, minval=math.log(0.3),
                                                    maxval=math.log(3.3))),
                      int(jax.random.randint(k_pos, (), 0, h)),
                      int(jax.random.randint(jax.random.fold_in(k_pos, 1), (), 0, w))))
    apply, area, ratio, top, left = (np.array([d[i] for d in draws]) for i in range(5))
    noise = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.normal(
        jax.random.split(k, 5)[4], (h, w, 3))))(jax.random.split(key, n)))
    assert 0 < apply.sum() < n
    got = O.apply_random_erasing(_nchw(x), apply, area, ratio, top, left,
                                 noise=_nchw(noise[apply]))
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got != x, want != x)  # the same boxes
    # XLA's normal draw rounds a few values (0.15%) up to two ulps apart from the
    # one inside the erasing op's program, however it is compiled
    np.testing.assert_allclose(got, want, atol=3e-7, rtol=0)


@pytest.mark.parametrize("seed", [0, 5])
def test_mixup_given_the_jax_lambda_matches_jax(seed):
    from cvnets_tpu.ops.mixing import mixup

    x, y = _batch(seed)
    key = jax.random.PRNGKey(seed)
    want_x, want_y = jax.jit(lambda k, a, b: mixup(k, a, b, N_CLASSES, 0.2))(
        key, jnp.asarray(x), jnp.asarray(y))
    lam = np.float32(jax.random.beta(jax.random.split(key)[0], 0.2, 0.2))
    got_x, got_y = M.mixup(_nchw(x), M.one_hot(torch.from_numpy(y), N_CLASSES), lam)
    np.testing.assert_array_equal(got_x.permute(0, 2, 3, 1).numpy(), np.asarray(want_x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-7, rtol=0)


@pytest.mark.parametrize("seed", [0, 3, 4, 9])
def test_cutmix_given_the_jax_draws_matches_jax(seed):
    from cvnets_tpu.ops.mixing import cutmix

    x, y = _batch(seed)
    n, h, w, _c = x.shape
    key = jax.random.PRNGKey(seed)
    want_x, want_y = jax.jit(lambda k, a, b: cutmix(k, a, b, N_CLASSES, 1.0))(
        key, jnp.asarray(x), jnp.asarray(y))
    lam_rng, box_rng = jax.random.split(key)
    lam = np.float32(jax.random.beta(lam_rng, 1.0, 1.0))
    cy = int(jax.random.randint(box_rng, (), 0, h))
    cx = int(jax.random.randint(jax.random.fold_in(box_rng, 1), (), 0, w))
    got_x, got_y = M.cutmix(_nchw(x), M.one_hot(torch.from_numpy(y), N_CLASSES), lam, cy, cx)
    np.testing.assert_array_equal(got_x.permute(0, 2, 3, 1).numpy(), np.asarray(want_x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-7, rtol=0)


def test_one_hot_of_an_unknown_label_is_a_row_of_zeros_as_jax():
    t = torch.tensor([2, -1, 12])
    np.testing.assert_array_equal(M.one_hot(t, N_CLASSES).numpy(),
                                  np.asarray(jax.nn.one_hot(jnp.asarray([2, -1, 12]), N_CLASSES)))


def test_erased_share_is_p_over_4096_images():
    x = torch.rand((4096, 3, 8, 8), generator=torch.Generator().manual_seed(0))
    out = O.random_erasing(x, np.random.default_rng(0), p=0.25)
    share = (out != x).flatten(1).any(1).float().mean().item()
    assert abs(share - 0.25) < 4 * (0.25 * 0.75 / 4096) ** 0.5, share


def _lambdas_jax(op, alpha, n=2000, h=16, w=16):
    """λ of ``n`` JAX draws, read back from the soft targets of a batch of two."""
    y = jnp.asarray([0, 1])
    x = jnp.zeros((2, h, w, 1))
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    _, soft = jax.jit(jax.vmap(lambda k: op(k, x, y, 2, alpha)))(keys)
    return np.asarray(soft[:, 0, 0])


def _lambdas_port(branch, alpha, n=2000, h=16, w=16):
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=[f"--image-augmentation.{branch}.enable",
                                        f"--image-augmentation.{branch}.alpha", str(alpha)])
    fn = M.build_mixing_fn(opts)
    x, y = torch.zeros((2, 1, h, w)), torch.tensor([0, 1])
    out = []
    for s in range(n):
        _, soft = fn(x, y, 2, np.random.default_rng([s]))
        assert torch.allclose(soft.sum(1), torch.ones(2))
        out.append(soft[0, 0].item())
    return np.array(out)


@pytest.mark.parametrize("branch,alpha", [("mixup", 0.2), ("cutmix", 1.0)])
def test_lambda_of_the_port_draws_has_the_jax_mean(branch, alpha):
    from cvnets_tpu.ops.mixing import cutmix, mixup

    ref = _lambdas_jax(mixup if branch == "mixup" else cutmix, alpha)
    got = _lambdas_port(branch, alpha)
    # two samples of one distribution: their means within 4σ of the difference
    sigma = np.sqrt(ref.var() / len(ref) + got.var() / len(got))
    assert abs(got.mean() - ref.mean()) < 4 * sigma, (got.mean(), ref.mean())
    if branch == "mixup":
        assert abs(got.mean() - 0.5) < 4 * np.sqrt(0.04 / 0.16 / 1.4 / len(got))


def test_mixing_fn_chooses_mixup_or_cutmix_and_applies_with_p():
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=[
        "--image-augmentation.mixup.enable", "--image-augmentation.cutmix.enable",
        "--image-augmentation.mixup.p", "0.8"])
    fn = M.build_mixing_fn(opts)
    x = torch.rand((4, 3, 16, 16), generator=torch.Generator().manual_seed(0))
    y = torch.tensor([0, 1, 2, 3])
    kinds = {"none": 0, "mixup": 0, "cutmix": 0}
    for s in range(1000):
        mixed, soft = fn(x, y, 5, np.random.default_rng([s]))
        torch.testing.assert_close(soft.sum(1), torch.ones(4))
        if torch.equal(mixed, x):
            kinds["none"] += 1
        elif bool(((mixed == x) | (mixed == x.roll(1, 0))).all()):
            kinds["cutmix"] += 1
        else:
            kinds["mixup"] += 1
    assert abs(kinds["none"] / 1000 - 0.2) < 0.05, kinds
    assert abs(kinds["mixup"] / 800 - 0.5) < 0.08 and abs(kinds["cutmix"] / 800 - 0.5) < 0.08
    assert M.build_mixing_fn(get_training_arguments(args=[])) is None


@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_soft_target_ce_matches_jax(ls):
    from cvnets_tpu.loss import build_loss_fn as jax_loss
    from cvnets_tpu_torch.loss import build_loss_fn

    args = SMALL_MODEL_ARGS + ["--loss.classification.cross-entropy.label-smoothing", str(ls)]
    opts_jax, opts_torch = both_opts(args)
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((8, N_CLASSES))).astype(np.float32)
    soft = rng.dirichlet(np.full(N_CLASSES, 0.3), 8).astype(np.float32)
    want = float(jax_loss(opts_jax)(None, jnp.asarray(logits), jnp.asarray(soft), training=True))
    got = build_loss_fn(opts_torch)(None, torch.from_numpy(logits), torch.from_numpy(soft),
                                    training=True).item()
    assert abs(got - want) <= 1e-6 * abs(want)
    # validation takes no smoothing, with integer targets as before
    hard = rng.integers(0, N_CLASSES, 8)
    want = float(jax_loss(opts_jax)(None, jnp.asarray(logits), jnp.asarray(hard), training=False))
    got = build_loss_fn(opts_torch)(None, torch.from_numpy(logits), torch.from_numpy(hard),
                                    training=False).item()
    assert abs(got - want) <= 1e-6 * abs(want)


AUG_ARGS = SMALL_MODEL_ARGS + [
    "--image-augmentation.rand-augment.enable",
    "--image-augmentation.random-erase.enable", "--image-augmentation.random-erase.p", "0.25",
    "--image-augmentation.mixup.enable", "--image-augmentation.mixup.alpha", "0.2",
    "--image-augmentation.cutmix.enable", "--image-augmentation.cutmix.alpha", "1.0",
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "adamw", "--common.grad-clip", "10",
]


def _augmented_step(seed, steps_before=0):
    from cvnets_tpu_torch.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.ops.image_ops import build_device_augmenter
    from cvnets_tpu_torch.ops.mixing import build_mixing_fn
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=AUG_ARGS + ["--common.seed", str(seed)])
    torch.manual_seed(0)
    model = get_model(opts, device="cpu")
    state = create_train_state(model, build_optimizer(opts, model))
    state.step = steps_before
    seen = {}
    criteria = build_loss_fn(opts)

    def watched(x, prediction, target, **kwargs):
        seen["targets"] = target
        return criteria(x, prediction, target, **kwargs)

    step = make_train_step(model, watched, opts, build_metrics(opts, ["loss"]),
                           augment_fn=build_device_augmenter(opts),
                           mixing_fn=build_mixing_fn(opts))
    g = np.random.default_rng(7)
    batch = {"samples": torch.from_numpy(g.integers(0, 256, (4, 3, 64, 64), dtype=np.uint8)),
             "targets": torch.from_numpy(g.integers(0, N_CLASSES, 4))}
    state, metrics = step(state, batch, 1e-3)
    return [p.detach().clone() for p in model.parameters()], metrics, seen["targets"]


def test_train_step_with_augmentation_gives_the_same_bits_from_one_seed_and_step():
    with torch_threads(2):
        a, metrics_a, targets = _augmented_step(0)
        b, metrics_b, _ = _augmented_step(0)
        others = (_augmented_step(0, steps_before=1)[0], _augmented_step(1)[0])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(metrics_a["loss"]["loss"][0], metrics_b["loss"]["loss"][0])
    assert targets.shape == (4, N_CLASSES)  # soft rows reached the loss
    torch.testing.assert_close(targets.sum(1), torch.ones(4))
    for other in others:
        assert not all(torch.equal(x, y) for x, y in zip(a, other))
