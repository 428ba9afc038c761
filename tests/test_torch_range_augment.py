"""RangeAugment in the PyTorch port against the JAX package, on the CPU at
micro sizes: the neural augmentor, the neural-augmentation loss, the
composite loss, a MobileNetV2 with the augmentor under the composite of its
yaml, the models that build no augmentor, and the RangeAugment MobileNetV2
yaml through ``main_train`` (one epoch; a run stopped after its first epoch
resumes bit for bit).

The JAX augmentor draws from ``make_rng("dropout")``; the tests patch that to a
fixed key, make JAX's own draws from it in JAX (``fold_in(rng, i)``, ``split``,
``uniform``, ``bernoulli`` and, under ``fold_in(mag_rng, 7)``, ``normal``) and
give them to the port's augmentor, transposed to NCHW. Tolerances: the
augmentor's output 1e-6 (float32, elementwise), its grads 1e-5 of each
tensor's largest; the losses 1e-6 relative (float32 on both sides); the
whole model, in float64 on both sides, at the conv families' bounds
(``torch_port_helpers``: logits LOGIT_ATOL, grads 5e-4 of the largest)."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_port_helpers import (  # noqa: E402
    CONV_FAMILY_ARGS,
    DEEPLAB_MICRO_ARGS,
    SWIN_MICRO_ARGS,
    VIT_MICRO_ARGS,
    assert_grads_match,
    assert_logits_match,
    both_opts,
    jax_in_float64,
    micro_swin_modes,
    nchw,
    perturbed_variables,
    port_model_from,
    register_port_dummy_dataset,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

RA_YAML = os.path.join(REPO, "examples/range_augment/classification/mobilenet_v2.yaml")
AUGMENTATIONS = ("brightness", "contrast", "noise")
# magnitudes off their inits, wide enough that every augmentation clips
PARAMS = {"distribution": {"brightness_min": 0.7, "brightness_max": 1.8,
                           "contrast_min": 0.4, "contrast_max": 1.9,
                           "noise_min": 0.05, "noise_max": 0.3},
          "basic": {"brightness_mag": 1.6, "contrast_mag": 0.6, "noise_mag": 0.2}}
DRAW_KEY = 5  # the augmentor tests' key (batch 8); the model test's (batch 4):
MODEL_DRAW_KEY = 1


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def aug_flags(mode: str, enabled=AUGMENTATIONS) -> list:
    return ["--model.learn-augmentation.mode", mode] + [
        f"--model.learn-augmentation.{name}" for name in enabled]


def jax_draws(key_seed: int, enabled, mode: str, x_nhwc):
    """The draws the JAX augmentor makes from ``PRNGKey(key_seed)`` for a batch
    like ``x_nhwc`` (neural_aug.py:66-83), as the port's ``draws`` argument."""
    import jax

    rng = jax.random.PRNGKey(key_seed)
    n = x_nhwc.shape[0]
    draws = {}
    for i, name in enumerate(enabled):
        mag_rng, sel_rng = jax.random.split(jax.random.fold_in(rng, i))
        u = jax.random.uniform(mag_rng) if mode == "distribution" else None
        noise = (jax.random.normal(jax.random.fold_in(mag_rng, 7), x_nhwc.shape, x_nhwc.dtype)
                 if name == "noise" else None)
        select = np.array(jax.random.bernoulli(sel_rng, 0.5, (n,) + (1,) * 3)).reshape(n)
        assert 0 < select.sum() < n  # both halves present at this key
        draws[name] = {"u": None if u is None else torch.tensor(np.asarray(u)),
                       "select": torch.from_numpy(select),
                       "noise": None if noise is None else nchw(np.asarray(noise))}
    return draws


def patched_jax_rng(monkeypatch, key_seed: int = DRAW_KEY) -> None:
    import jax

    from cvnets_tpu.models.neural_augmentor import neural_aug

    monkeypatch.setattr(neural_aug.NeuralAugmentor, "make_rng",
                        lambda self, name="params": jax.random.PRNGKey(key_seed))


CASES = [("distribution", AUGMENTATIONS), ("basic", AUGMENTATIONS),
         ("distribution", ("brightness", "noise")), ("basic", ("contrast",))]


@pytest.mark.parametrize("mode,enabled", CASES)
def test_augmentor_output_and_grads_match_jax_on_its_draws(mode, enabled, monkeypatch):
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.models.neural_augmentor.neural_aug import NeuralAugmentor as JaxAugmentor
    from cvnets_tpu_torch.models.neural_augmentor.neural_aug import NeuralAugmentor

    opts_jax, opts_torch = both_opts(aug_flags(mode, enabled))
    rng = np.random.default_rng(0)
    x = rng.random((8, 12, 10, 3), dtype=np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    params = {k: np.float32(v) for k, v in PARAMS[mode].items()
              if k.rsplit("_", 1)[0] in enabled}

    jaug = JaxAugmentor(opts=opts_jax, mode=mode)
    init = jaug.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(x), training=False)
    assert sorted(init["params"]) == sorted(params)  # the enabled ones, no other
    patched_jax_rng(monkeypatch)

    def jax_loss(xj, p):
        return jnp.sum(jaug.apply({"params": p}, xj, training=True) * w)

    want = np.asarray(jaug.apply({"params": params}, jnp.asarray(x), training=True))
    gx, gp = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(x), params)

    aug = NeuralAugmentor(opts_torch, mode=mode).train()
    assert [n for n, _ in aug.named_parameters()] == list(params)  # JAX's creation order
    with torch.no_grad():
        for name, value in params.items():
            getattr(aug, name).fill_(float(value))
    xt = nchw(x).requires_grad_(True)
    out = aug(xt, jax_draws(DRAW_KEY, enabled, mode, x))
    (out * nchw(w)).sum().backward()

    got = out.detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.isclose(want, 1.0).any() and np.isclose(want, 0.0).any() or \
        enabled == ("contrast",)  # the straight-through clip acted
    gx = np.asarray(gx)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), gx, rtol=0,
                               atol=1e-5 * np.abs(gx).max())
    for name, g in gp.items():
        np.testing.assert_allclose(getattr(aug, name).grad.item(), float(g), rtol=1e-5,
                                   atol=1e-5 * max(abs(float(v)) for v in gp.values()),
                                   err_msg=name)


def test_augmentor_passes_its_input_through_outside_training():
    from cvnets_tpu_torch.models.neural_augmentor.neural_aug import NeuralAugmentor

    _, opts = both_opts(aug_flags("distribution"))
    aug = NeuralAugmentor(opts).eval()
    x = torch.rand(2, 3, 8, 8)
    assert aug(x) is x
    # seeded draws: the default generator's state depends on the tests run
    # before in the process, and 1 draw in 64 selects no image for any of
    # the three augmentations, which leaves x as it is
    draws = aug.draw(x, torch.Generator().manual_seed(0))
    assert any(bool(d["select"].any()) for d in draws.values())
    assert aug.train()(x).shape == x.shape and not torch.equal(aug(x, draws), x)


def test_straight_through_clip_passes_the_identitys_gradient():
    from cvnets_tpu_torch.models.neural_augmentor.neural_aug import straight_through_clip

    x = torch.tensor([-0.5, 0.25, 1.5], requires_grad=True)
    y = straight_through_clip(x)
    y.sum().backward()
    assert y.tolist() == [0.0, 0.25, 1.0] and x.grad.tolist() == [1.0, 1.0, 1.0]


def test_draws_are_the_generators_and_the_same_for_the_same_seed():
    from cvnets_tpu_torch.models.neural_augmentor.neural_aug import NeuralAugmentor

    _, opts = both_opts(aug_flags("distribution"))
    aug = NeuralAugmentor(opts).train()
    x = torch.rand(6, 3, 8, 8)
    a, b = (aug.draw(x, torch.Generator().manual_seed(3)) for _ in range(2))
    for name in AUGMENTATIONS:
        for part in ("u", "select", "noise"):
            if a[name][part] is not None:
                assert torch.equal(a[name][part], b[name][part]), (name, part)
    assert a["noise"]["noise"].shape == x.shape and a["brightness"]["noise"] is None
    assert torch.equal(aug(x, a), aug(x, b))


# ---- the neural-augmentation loss ------------------------------------------
def _na_opts(curriculum: str, iteration_based: bool):
    args = ["--loss.neural-augmentation.curriculum-method", curriculum,
            "--scheduler.max-epochs", "10", "--scheduler.max-iterations", "100"]
    return both_opts(args + (["--scheduler.is-iteration-based"] if iteration_based else []))


@pytest.mark.parametrize("curriculum", ["cosine", "linear"])
@pytest.mark.parametrize("iteration_based", [True, False])
def test_neural_augmentation_loss_matches_jax_along_its_curriculum(curriculum,
                                                                   iteration_based):
    import jax.numpy as jnp

    from cvnets_tpu.loss.neural_augmentation import NeuralAugmentation as JaxNA
    from cvnets_tpu_torch.loss.neural_augmentation import NeuralAugmentation

    opts_jax, opts_torch = _na_opts(curriculum, iteration_based)
    jloss, loss = JaxNA(opts_jax), NeuralAugmentation(opts_torch)
    rng = np.random.default_rng(1)
    x = rng.random((4, 16, 16, 3), dtype=np.float32)
    # per-image PSNRs from ~45 dB down to ~15 dB, around the curriculum's targets
    scale = np.array([0.002, 0.02, 0.08, 0.3], np.float32)[:, None, None, None]
    aug = np.clip(x + scale * rng.standard_normal(x.shape).astype(np.float32), 0, 1)
    for step in (0, 3, 7, 250):
        kw = {"iterations": step, "epoch": 0} if iteration_based else \
            {"epoch": step, "iterations": 0}
        want = float(jloss(jnp.asarray(x), {"augmented_tensor": jnp.asarray(aug),
                                             "logits": None}, None, **kw))
        got = loss(nchw(x), {"augmented_tensor": nchw(aug), "logits": None}, None, **kw)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(got.item(), want, rtol=1e-6, err_msg=str(step))
        # a step that lives on the device gives the same value
        on_device = {k: torch.tensor(v) for k, v in kw.items()}
        np.testing.assert_allclose(
            loss(nchw(x), {"augmented_tensor": nchw(aug)}, None, **on_device).item(), want,
            rtol=1e-6)


@pytest.mark.parametrize("prediction", ["logits", "clip_dict", "eval_dict"])
def test_neural_augmentation_loss_is_zero_without_an_augmented_tensor(prediction):
    from cvnets_tpu.loss.neural_augmentation import NeuralAugmentation as JaxNA
    from cvnets_tpu_torch.loss.neural_augmentation import NeuralAugmentation

    opts_jax, opts_torch = _na_opts("cosine", False)
    x = torch.rand(2, 3, 8, 8)
    pred = {"logits": torch.randn(2, 5),
            "clip_dict": {"image": torch.randn(2, 4), "text": torch.randn(2, 4),
                          "logit_scale": torch.tensor(1.0)},
            "eval_dict": {"augmented_tensor": None, "logits": torch.randn(2, 5)}}[prediction]
    got = NeuralAugmentation(opts_torch)(x, pred, None, epoch=3)
    assert got.dtype == torch.float32 and got.item() == 0.0
    assert float(JaxNA(opts_jax)(None, {"x": 1} if prediction == "clip_dict" else None,
                                 None)) == 0.0


# ---- the composite loss -----------------------------------------------------
def ra_opts(*overrides):
    return both_opts(["--common.config-file", RA_YAML, "--common.override-kwargs",
                      *overrides])


def test_composite_of_ce_and_neural_augmentation_matches_jax():
    import jax.numpy as jnp

    from cvnets_tpu.loss import build_loss_fn as jax_build
    from cvnets_tpu_torch.loss import build_loss_fn

    opts_jax, opts_torch = ra_opts("model.classification.n_classes=13")
    jcrit, crit = jax_build(opts_jax), build_loss_fn(opts_torch, device="cpu")
    assert list(crit.loss_weights.items()) == [("classification", 1.0),
                                               ("neural_augmentation", 1.0)]
    rng = np.random.default_rng(2)
    x = rng.random((4, 16, 16, 3), dtype=np.float32)
    aug = np.clip(x * 1.3, 0, 1)
    logits = 3 * rng.standard_normal((4, 13)).astype(np.float32)
    y = np.array([1, 5, 12, 0])
    for epoch in (0, 150, 299):
        want = jcrit(jnp.asarray(x), {"augmented_tensor": jnp.asarray(aug),
                                      "logits": jnp.asarray(logits)}, jnp.asarray(y),
                     training=True, epoch=epoch, iterations=0)
        got = crit(nchw(x), {"augmented_tensor": nchw(aug), "logits": torch.from_numpy(logits)},
                   torch.from_numpy(y), training=True, epoch=epoch, iterations=0)
        assert set(got) == set(want) == {"classification", "neural_augmentation",
                                         "total_loss"}
        for key in want:
            np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-6,
                                       err_msg=f"{key} at epoch {epoch}")


# ---- a whole model ----------------------------------------------------------
def _no_classifier_dropout(model):
    model.classifier.dropout.p = 0.0


def test_micro_mobilenetv2_with_the_augmentor_matches_jax_under_its_composite(monkeypatch):
    """MobileNetV2-0.25 (classifier dropout 0 in both) with the distribution
    augmentor and the yaml's CE + NA composite: one train forward on JAX's
    draws, its augmented tensor, logits, the composite's terms and every grad,
    the augmentor's scalars included, in float64 on both sides (train-mode
    grads of this width are chaotic in float32; tests/test_torch_mobilenets.py)."""
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.loss import build_loss_fn as jax_build
    from cvnets_tpu.models import get_model as jax_get_model
    from cvnets_tpu.utils import math_utils
    from cvnets_tpu_torch.loss import build_loss_fn

    opts_jax, opts_torch = ra_opts("model.classification.n_classes=13",
                                   "model.classification.mobilenetv2.width_multiplier=0.25")
    rng = np.random.default_rng(0)
    x = rng.random((4, 32, 32, 3), dtype=np.float32)
    y = np.array([3, 11, 0, 7])
    # the JAX model reads bound_fn when flax binds it, at every apply
    monkeypatch.setattr(math_utils, "bound_fn", lambda lo, hi, v: 0.0)
    jmodel = jax_get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    params = variables["params"]
    assert sorted(params["neural_augmentor"]) == sorted(PARAMS["distribution"])
    params["neural_augmentor"] = {k: np.float32(v) for k, v in PARAMS["distribution"].items()}
    jcrit = jax_build(opts_jax)
    patched_jax_rng(monkeypatch, MODEL_DRAW_KEY)
    kw = {"training": True, "epoch": 100, "iterations": 0}
    with jax_in_float64(opts_jax):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        x64 = jnp.asarray(x, jnp.float64)

        def loss_fn(p):
            pred, _ = jmodel.apply({**v64, "params": p}, x64, training=True,
                                   mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(0)})
            loss = jcrit(x64, pred, jnp.asarray(y), **kw)
            return loss["total_loss"], (loss, pred)

        (_, (jloss, jpred)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(v64["params"])
        draws = jax_draws(MODEL_DRAW_KEY, AUGMENTATIONS, "distribution", np.asarray(x64))
    jgrads = jax.tree_util.tree_map(np.asarray, jgrads)

    model = port_model_from(opts_torch, variables)
    _no_classifier_dropout(model)
    model.double().train()
    x_t = nchw(x.astype(np.float64))
    pred = model(x_t, augmentation_draws=draws)
    loss = build_loss_fn(opts_torch, device="cpu")(x_t, pred, torch.from_numpy(y), **kw)
    loss["total_loss"].backward()

    np.testing.assert_allclose(pred["augmented_tensor"].detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jpred["augmented_tensor"]), rtol=0, atol=1e-12)
    assert_logits_match(pred["logits"].detach().numpy(), np.asarray(jpred["logits"]))
    for key in ("classification", "neural_augmentation", "total_loss"):
        np.testing.assert_allclose(loss[key].item(), float(jloss[key]), rtol=1e-5, err_msg=key)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert all(grads[f"neural_augmentor.{k}"].abs().item() > 0 for k in PARAMS["distribution"])
    assert_grads_match(grads, jgrads)
    model.eval()
    assert isinstance(model(x_t), torch.Tensor)  # logits outside training


# ---- the models that build no augmentor (ROADMAP "Pinned") -------------------
NO_AUGMENTOR = {
    "swin_micro": SWIN_MICRO_ARGS,
    "vit_micro": VIT_MICRO_ARGS,
    "deeplabv3_micro": DEEPLAB_MICRO_ARGS + ["--model.segmentation.output-stride", "16"],
}


@pytest.mark.parametrize("name", sorted(NO_AUGMENTOR))
def test_models_whose_jax_tree_has_no_augmentor_build_none(name, monkeypatch):
    from cvnets_tpu.models import get_model as jax_get_model
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.utils import logger
    from torch_port_helpers import jax_leaf_shapes

    warned = []
    monkeypatch.setattr(logger, "warning", warned.append)
    opts_jax, opts_torch = both_opts(NO_AUGMENTOR[name] + aug_flags("distribution"))
    with micro_swin_modes():
        jax_keys = jax_leaf_shapes(jax_get_model(opts_jax))
        model = get_model(opts_torch, device="cpu")
    assert not [k for k in jax_keys if "neural_augmentor" in k]
    assert not [k for k, _ in model.named_parameters() if "neural_augmentor" in k]
    assert "neural_augmentor" not in model._modules
    ours = [w for w in warned if "builds no neural augmentor" in w]
    category = getattr(opts_torch, "dataset.category")
    assert len(ours) == 1 and getattr(opts_torch, f"model.{category}.name") in ours[0]


def test_lr_multiplier_is_parsed_and_not_applied(monkeypatch):
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.utils import logger

    warned = []
    monkeypatch.setattr(logger, "warning", warned.append)
    _, opts = both_opts(CONV_FAMILY_ARGS + [
        "--model.classification.name", "mobilenetv1",
        "--model.classification.mobilenetv1.width-multiplier", "0.25",
        "--model.learn-augmentation.lr-multiplier", "5.0"] + aug_flags("basic"))
    model = get_model(opts, device="cpu")
    groups = build_optimizer(opts, model, model.get_lr_multipliers(opts)).param_groups
    assert {g["lr_mult"] for g in groups} == {1.0}
    assert [w for w in warned if "lr-multiplier 5.0 is parsed and not applied" in w]


# ---- the RangeAugment yaml through main_train ----------------------------------
# examples/range_augment/classification/mobilenet_v2.yaml at a CPU test's scale:
# MobileNetV2-0.25 on the port's dummy dataset, its variable batch sampler at
# 32-96 px around 64, base batch 4, 2 loader threads, 2 epochs
RA_OVERRIDES = [
    "dataset.name=dummy_classification",
    "dataset.train_batch_size0=4", "dataset.val_batch_size0=4",
    "dataset.workers=2",
    "model.classification.n_classes=10",
    "model.classification.mobilenetv2.width_multiplier=0.25",
    "sampler.vbs.crop_size_width=64", "sampler.vbs.crop_size_height=64",
    "sampler.vbs.min_crop_size_width=32", "sampler.vbs.max_crop_size_width=96",
    "sampler.vbs.min_crop_size_height=32", "sampler.vbs.max_crop_size_height=96",
    "sampler.vbs.max_n_scales=3", "sampler.vbs.check_scale=16",
    "image_augmentation.resize.size=72", "image_augmentation.center_crop.size=64",
    "scheduler.max_epochs=2", "scheduler.warmup_iterations=3",
]


def _ra_run(results, monkeypatch, max_epochs=None):
    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.engine import Trainer

    register_port_dummy_dataset()
    built, stats = [], {"train": [], "ema": []}

    class Recorded(Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            if max_epochs is not None:
                self.max_epochs = max_epochs
            built.append(self)

        def train_epoch(self, epoch):
            out = super().train_epoch(epoch)
            stats["train"].append(out)
            return out

        def val_epoch(self, epoch, use_ema=False):
            out = super().val_epoch(epoch, use_ema=use_ema)
            if use_ema:
                stats["ema"].append(out)
            return out

    monkeypatch.setattr(main_train, "Trainer", Recorded)
    args = ["--common.config-file", RA_YAML, "--common.override-kwargs", *RA_OVERRIDES,
            f"common.results_loc={results}"]
    main_train.main_worker(args=args, device="cpu")
    return built[-1], stats


@pytest.fixture(scope="module")
def ra_unbroken(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        return _ra_run(tmp_path_factory.mktemp("ra_whole"), mp)


def test_range_augment_yaml_trains_with_the_augmentor_and_its_loss(ra_unbroken):
    import math

    trainer, stats = ra_unbroken
    assert isinstance(trainer.model.neural_augmentor.brightness_min, torch.nn.Parameter)
    assert set(trainer.criteria.loss_fns) == {"classification", "neural_augmentation"}
    assert trainer.train_iterations == trainer.state.step > 0
    for epoch_stats in stats["train"]:
        assert {"loss", "loss.classification", "loss.neural_augmentation"} <= set(epoch_stats)
        assert all(math.isfinite(v) for v in epoch_stats.values())
        assert epoch_stats["loss.neural_augmentation"] > 0
    init = dict(zip(("brightness_min", "brightness_max", "contrast_min", "contrast_max",
                     "noise_min", "noise_max"), (0.5, 1.5, 0.5, 1.5, 0.0, 0.1)))
    moved = [k for k, v in init.items()
             if getattr(trainer.model.neural_augmentor, k).item() != pytest.approx(v)]
    assert moved  # the magnitudes train
    assert "neural_augmentor.noise_max" in trainer.state.ema.model.state_dict()


def test_range_augment_run_stopped_after_its_first_epoch_resumes_bit_identical(
        ra_unbroken, tmp_path, monkeypatch):
    whole, whole_stats = ra_unbroken
    first, _ = _ra_run(tmp_path, monkeypatch, max_epochs=1)
    resumed, resumed_stats = _ra_run(tmp_path, monkeypatch)  # the yaml's auto_resume
    assert (resumed.start_epoch, resumed.state.step) == (1, whole.state.step)
    for a, b in ((whole.model, resumed.model), (whole.state.ema.model, resumed.state.ema.model)):
        for (key, x), y in zip(a.state_dict().items(), b.state_dict().values()):
            assert torch.equal(x, y), key
    assert resumed_stats["ema"][-1] == whole_stats["ema"][-1]


def test_chip_smoke_range_augment_flags_are_the_yaml_settings():
    """chip_smoke.py's RangeAugment distillation phase: its flags and
    composite set every value the yaml sets, and nothing else, but the
    dataset's name and roots (the yaml's ImageNet on disk), the teacher's
    checkpoint (the phase writes its own), and the bare steps' fixed 224²
    crop that stands in for the variable batch sampler's scales."""
    sys.path.insert(0, REPO)
    from chip_smoke import RANGE_AUGMENT_ARGS, RANGE_AUGMENT_DATA_ARGS, range_augment_opts
    from cvnets_tpu_torch.options.opts import get_training_arguments

    yaml_path = os.path.join(REPO, "examples/range_augment/distillation/"
                                   "teacher_resnet101_student_mobilenet_v2.yaml")
    default = vars(get_training_arguments(args=[]))
    flags = vars(range_augment_opts(RANGE_AUGMENT_ARGS + RANGE_AUGMENT_DATA_ARGS))
    yaml = vars(get_training_arguments(args=["--common.config-file", yaml_path]))
    mine = ("common.config_file", "taskname", "dataset.root_train", "dataset.root_val",
            "dataset.name", "teacher.model.classification.pretrained")
    stand_in = ("sampler.bs.crop_size_width", "sampler.bs.crop_size_height")

    def same(flag, value):  # a one-entry list of an ``nargs="+"`` flag is its entry
        return flag == value or (isinstance(flag, list) and flag == [value])

    for dest, value in yaml.items():
        if value != default[dest] and dest not in mine:
            assert same(flags[dest], value), dest
    for dest, value in flags.items():
        if value != default[dest] and dest not in stand_in:
            assert same(value, yaml[dest]), dest
