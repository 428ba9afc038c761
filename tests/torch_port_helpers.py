"""Shared set-up for the tests that hold the PyTorch port against the JAX package:
one flag list parsed by both parsers, a flax model (MobileViTv2, ViT or
DeepLabv3) initialised and perturbed from a numpy seed, and its weights copied
into the port's model."""

from __future__ import annotations

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

    model = get_model(opts_torch)
    load_jax_params(model, variables["params"], variables.get("batch_stats"))
    return model


def nchw(x_nhwc: np.ndarray):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))
