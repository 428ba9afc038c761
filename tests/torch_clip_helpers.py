"""Shared set-up of the CLIP tests: the micro CLIP's flags (a 2-layer text
tower of width 64 with 4 heads, causal, context 16, vocab 100, projection
32) over a micro MobileNetV2 (width 0.25) or the micro ViT, the same
perturbed flax variables in both packages, and seeded inputs."""

from __future__ import annotations

import numpy as np

CLIP_TEXT_ARGS = [
    "--dataset.category", "multi_modal_image_text",
    "--loss.category", "multi_modal_image_text",
    "--model.multi-modal-image-text.name", "clip",
    "--model.multi-modal-image-text.clip.projection-dim", "32",
    "--model.text.name", "transformer",
    "--model.text.vocab-size", "100",
    "--model.text.context-length", "16",
    "--model.text.transformer.model-dim", "64",
    "--model.text.transformer.n-transformer-layers", "2",
    "--model.text.transformer.n-heads-per-layer", "4",
    "--model.text.transformer.causal-masking",
    "--model.activation.name", "gelu",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
]
CLIP_CONV_ARGS = CLIP_TEXT_ARGS + [
    "--model.classification.name", "mobilenetv2",
    "--model.classification.mobilenetv2.width-multiplier", "0.25",
]
CLIP_VIT_ARGS = CLIP_TEXT_ARGS + [
    "--model.classification.name", "vit",
    "--model.classification.vit.mode", "micro",
]
SIZE, CONTEXT, VOCAB, EMBED = 64, 16, 100, 32


def clip_inputs(seed: int, batch: int = 4) -> dict:
    """NHWC float images in [0, 1] (multiples of 1/255) and token rows: SOT,
    random ids, EOT (the largest id, 99) at a random place, zeros after."""
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (batch, SIZE, SIZE, 3)).astype(np.float32) / 255.0
    text = np.zeros((batch, CONTEXT), np.int64)
    for i in range(batch):
        n = int(rng.integers(3, CONTEXT + 1))
        text[i, :n] = rng.integers(1, VOCAB - 2, n)
        text[i, 0], text[i, n - 1] = VOCAB - 2, VOCAB - 1
    return {"image": image, "text": text}


def port_samples(samples: dict) -> dict:
    import torch

    from torch_port_helpers import nchw

    return {"image": nchw(samples["image"]), "text": torch.from_numpy(samples["text"])}


def jax_samples(samples: dict) -> dict:
    import jax.numpy as jnp

    return {"image": jnp.asarray(samples["image"]),
            "text": jnp.asarray(samples["text"], jnp.int32)}
