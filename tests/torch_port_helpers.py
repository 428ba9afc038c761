"""Shared set-up for the tests that hold the PyTorch port against the JAX package:
one flag list parsed by both parsers, a flax model (MobileViTv2, ViT, DeepLabv3
or Swin) initialised and perturbed from a numpy seed, and its weights copied
into the port's model."""

from __future__ import annotations

import contextlib

import numpy as np

# MobileViTv2 at width 0.5 with the flagship's layer settings, 13 classes
SMALL_MODEL_ARGS = [
    "--model.classification.name", "mobilevit_v2",
    "--model.classification.n-classes", "13",
    "--model.classification.mitv2.width-multiplier", "0.5",
    "--model.activation.name", "swish",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--dataset.category", "classification",
]

# the micro ViT (E = 64, 2 blocks, 4 heads of 16) with vit.yaml's layer settings,
# 13 classes; at 64×64 the stem gives 16 tokens, so the 196-entry positional
# table is resampled
VIT_MICRO_ARGS = [
    "--model.classification.name", "vit",
    "--model.classification.n-classes", "13",
    "--model.classification.vit.mode", "micro",
    "--model.activation.name", "gelu",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--dataset.category", "classification",
]


# the micro Swin: embed 48, one pair of blocks a stage, heads 3/6/12/24 (D = 16,
# a head dim the window kernels take, so its blocks reach the fused route),
# window 7, with swin.yaml's layer settings, 13 classes and stochastic depth 0
# (the two packages draw their drop masks from different generators); the
# "micro" mode exists only inside ``micro_swin_modes``
SWIN_MICRO_ARGS = [
    "--model.classification.name", "swin",
    "--model.classification.n-classes", "13",
    "--model.classification.swin.mode", "micro",
    "--model.classification.swin.stochastic-depth-prob", "0",
    "--model.activation.name", "gelu",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--dataset.category", "classification",
]
SWIN_MICRO_MODE = (48, [2, 2, 2, 2], [3, 6, 12, 24])


@contextlib.contextmanager
def micro_swin_modes():
    """Both packages' Swin ``_MODES`` with a "micro" entry (no file edited)."""
    import pytest

    from cvnets_tpu.models.classification import swin_transformer as jax_swin
    from cvnets_tpu_torch.models.classification import swin_transformer as port_swin

    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_swin, port_swin):
            mp.setitem(module._MODES, "micro", SWIN_MICRO_MODE)
        yield


# DeepLabv3 on MobileViTv2 at width 0.5 with deeplabv3_mobilevitv2.yaml's head and
# loss settings, cut to 13 classes and a 32-channel ASPP, dropouts 0; append
# "--model.segmentation.output-stride" and 8 or 16
DEEPLAB_MICRO_ARGS = [
    "--dataset.category", "segmentation",
    "--model.segmentation.name", "encoder_decoder",
    "--model.segmentation.n-classes", "13",
    "--model.segmentation.seg-head", "deeplabv3",
    "--model.segmentation.use-aux-head",
    "--model.segmentation.deeplabv3.aspp-out-channels", "32",
    "--model.segmentation.deeplabv3.aspp-dropout", "0",
    "--model.segmentation.classifier-dropout", "0",
    "--model.segmentation.aux-dropout", "0",
    "--model.classification.name", "mobilevit_v2",
    "--model.classification.mitv2.width-multiplier", "0.5",
    "--model.activation.name", "relu",
    "--model.layer.conv-init", "kaiming_normal",
    "--loss.category", "segmentation",
    "--loss.segmentation.name", "cross_entropy",
    "--loss.segmentation.cross-entropy.aux-weight", "0.4",
    "--loss.segmentation.cross-entropy.ignore-index", "255",
]


def seg_targets(rng: np.random.Generator, batch: int, size: int, n_classes: int = 13
                ) -> np.ndarray:
    """Random labels with 5% of the pixels ignored (255), as bench_tasks.py makes
    them."""
    y = rng.integers(0, n_classes, (batch, size, size))
    return np.where(rng.random((batch, size, size)) < 0.05, 255, y)


def both_opts(args):
    from cvnets_tpu.options.opts import get_training_arguments as jax_args
    from cvnets_tpu_torch.options.opts import get_training_arguments as torch_args

    return jax_args(args=list(args)), torch_args(args=list(args))


def perturbed_variables(model, x_nhwc: np.ndarray, seed: int = 0) -> dict:
    """flax variables as numpy, moved off their init values (zero biases, unit
    scales, (0, 1) BN stats) so that a leaf landing in the wrong place shows."""
    import jax
    import jax.numpy as jnp

    variables = jax.jit(lambda x: model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed)},
        x, training=False))(jnp.asarray(x_nhwc))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name == "var":
            return leaf * (1.0 + 0.1 * rng.random(leaf.shape, dtype=np.float32))
        if name in ("mean", "bias", "scale"):
            return leaf + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        return leaf

    return {col: jax.tree_util.tree_map_with_path(perturb, tree)
            for col, tree in variables.items()}


def port_model_from(opts_torch, variables: dict):
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    model = get_model(opts_torch, device="cpu")
    load_jax_params(model, variables["params"], variables.get("batch_stats"))
    return model


def nchw(x_nhwc: np.ndarray):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


# a micro MobileViTv2 Trainer run: the flagship's AdamW, EMA and stats
# (val loss/top-1/top-5, checkpoints ranked by top-1, highest best) on 64×64
TRAINER_MICRO_ARGS = SMALL_MODEL_ARGS + [
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.05",
    "--optim.no-decay-bn-filter-bias",
    "--common.grad-clip", "10",
    "--ema.enable",
    "--ema.momentum", "0.1",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "3",
    "--scheduler.warmup-iterations", "2",
    "--scheduler.warmup-init-lr", "1e-4",
    "--scheduler.cosine.max-lr", "0.002",
    "--scheduler.cosine.min-lr", "0.0002",
    "--stats.val", "loss", "top1", "top5",
    "--stats.checkpoint-metric", "top1",
    "--stats.checkpoint-metric-max",
]


def uint8_batches(seed: int, n: int, batch: int = 4, size: int = 64, n_classes: int = 13):
    """``n`` loader batches of NCHW uint8 pixels and labels from a numpy seed."""
    import torch

    rng = np.random.default_rng(seed)
    return [{"samples": nchw(rng.integers(0, 256, (batch, size, size, 3)).astype(np.uint8)),
             "targets": torch.from_numpy(rng.integers(0, n_classes, (batch,)))}
            for _ in range(n)]


@contextlib.contextmanager
def torch_threads(n: int = 2):
    """torch's CPU ops on ``n`` threads inside (restored after): the suite's
    xdist workers share the machine's cores, and a whole Trainer or
    ``main_train`` run on every core of each spins the others' threads
    (measured: past 300 s against 16 s for one run beside five others)."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def register_port_dummy_dataset() -> None:
    """Register ``dummy_classification`` in the port's dataset registry (once): the
    port's copy of tests/dummy_datasets/classification.py. It reads no files:
    sample i is a seeded uint8 HWC image of one of a few sizes around 64 px, so
    the port's transforms (random resized crop, flip, resize, center crop) run on
    it; labels cycle through the classes. 16 training samples, 8 validation ones."""
    from cvnets_tpu_torch.data.datasets import DATASET_REGISTRY
    from cvnets_tpu_torch.data.datasets.classification.base_image_classification_dataset \
        import BaseImageClassificationDataset

    if ("dummy_classification", "classification") in DATASET_REGISTRY:
        return

    @DATASET_REGISTRY.register(name="dummy_classification", type="classification")
    class PortDummyClassificationDataset(BaseImageClassificationDataset):
        def _find_samples(self):
            n_classes = getattr(self.opts, "model.classification.n_classes", None) or 10
            self.classes = [str(c) for c in range(n_classes)]
            return [(None, i % n_classes) for i in range(16 if self.is_training else 8)]

        def image_size(self, idx):
            return 48 + 9 * (idx % 4), 60 + 7 * (idx % 3)

        def read_image(self, idx):
            rng = np.random.default_rng(idx)
            return rng.integers(0, 256, (*self.image_size(idx), 3), dtype=np.uint8)


# the flagship yaml on the port's dummy dataset at a CPU test's scale: 64 px crops
# (72 then 64 for validation), batch 4, 2 epochs, 2 loader threads
FLAGSHIP_DUMMY_OVERRIDES = [
    "dataset.name=dummy_classification",
    "dataset.train_batch_size0=4",
    "dataset.val_batch_size0=4",
    "dataset.eval_batch_size0=4",
    "dataset.workers=2",
    "sampler.bs.crop_size_width=64",
    "sampler.bs.crop_size_height=64",
    "image_augmentation.resize.size=72",
    "image_augmentation.center_crop.size=64",
    "scheduler.max_epochs=2",
]
