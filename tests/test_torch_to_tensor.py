"""``ToFloatTensor``'s mean/std normalization against the JAX package's
(cvnets_tpu/data/transforms/image.py:517-574): the port's transform keeps
uint8 pixels and the train and eval steps' ``UnitNormalizer`` divides and
normalizes on the batch's device; the JAX transform does both on the host.
The same float32 operations in the same order give the same bits, with the
default ImageNet mean and std, with the flags' values, and without the flag
(the [0, 1] division alone). The flags parse to the JAX dests (also held by
tests/test_torch_imports.py), and a train step normalizes what it is given."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cvnets_tpu.data.transforms.image import ToFloatTensor as JaxToFloatTensor
from cvnets_tpu.options.opts import get_training_arguments as jax_args
from cvnets_tpu_torch.data.transforms.image import ToFloatTensor
from cvnets_tpu_torch.engine.train_state import UnitNormalizer
from cvnets_tpu_torch.options.opts import get_training_arguments as port_args

CASES = {
    "off": [],
    "default": ["--image-augmentation.to-tensor.mean-std-normalization.enable"],
    "flags": ["--image-augmentation.to-tensor.mean-std-normalization.enable",
              "--image-augmentation.to-tensor.mean-std-normalization.mean", "0.5", "0.4", "0.3",
              "--image-augmentation.to-tensor.mean-std-normalization.std", "0.2", "0.25",
              "0.3"],
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("gray", [False, True])
def test_normalization_matches_jax(case, gray):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (7, 9) if gray else (7, 9, 3), dtype=np.uint8)
    want = JaxToFloatTensor(jax_args(args=CASES[case]))({"image": img})["image"]
    opts = port_args(args=CASES[case])
    chw = torch.from_numpy(img).unsqueeze(0) if gray else torch.from_numpy(img).permute(2, 0, 1)
    kept = ToFloatTensor(opts).apply({"image": chw}, None)["image"]
    assert kept.dtype == torch.uint8 and tuple(kept.shape) == (3, 7, 9)
    got = UnitNormalizer(opts)(kept.unsqueeze(0))[0].permute(1, 2, 0).numpy()
    assert want.dtype == np.float32 and got.dtype == np.float32
    assert np.array_equal(got, want)


def test_flags_have_the_jax_dests():
    args = CASES["flags"]
    ref, port = vars(jax_args(args=args)), vars(port_args(args=args))
    for dest in ("enable", "mean", "std"):
        key = f"image_augmentation.to_tensor.mean_std_normalization.{dest}"
        assert port[key] == ref[key], key


def test_a_float_batch_passes_as_it_is_and_a_train_step_normalizes():
    from cvnets_tpu_torch.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import build_optimizer

    opts = port_args(args=CASES["default"])
    x = torch.rand(2, 3, 4, 4)
    assert UnitNormalizer(opts)(x) is x
    seen = []
    model_opts = port_args(args=CASES["default"] + [
        "--model.classification.name", "vit", "--model.classification.vit.mode", "micro",
        "--model.classification.n-classes", "3", "--model.activation.name", "gelu",
        "--optim.name", "adamw"])
    model = get_model(model_opts, device="cpu")
    model.register_forward_pre_hook(lambda m, args: seen.append(args[0].clone()))
    state = create_train_state(model, build_optimizer(model_opts, model))
    step = make_train_step(model, build_loss_fn(model_opts), model_opts,
                           build_metrics(model_opts, ["loss"]))
    pixels = torch.randint(0, 256, (2, 3, 32, 32), dtype=torch.uint8)
    step(state, {"samples": pixels, "targets": torch.tensor([0, 2])}, 1e-3)
    assert torch.equal(seen[0], UnitNormalizer(model_opts)(pixels))
    assert seen[0].min() < 0  # (0 - 0.485) / 0.229 and the like
