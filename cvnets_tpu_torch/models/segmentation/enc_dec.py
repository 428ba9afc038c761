"""Encoder-decoder segmentation model (counterpart of
cvnets_tpu/models/segmentation/enc_dec.py): the classification encoder's tap
points, then the registered seg head.

In training the model returns the head-resolution logits (a dict with
``segmentation_output`` and ``aux_output`` when the aux head is on): the loss
fuses the bilinear resize into the CE, so the full-resolution logits never
exist. ``--model.segmentation.upsample-train-logits`` upsamples them in
training too. In eval the logits are always upsampled to the input size with
``jax.image.resize``'s bilinear weights (half-pixel centres). NCHW throughout.
"""

from __future__ import annotations

import argparse
from typing import Dict, Union

import torch

from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.segmentation.base_seg import BaseSegmentation
from cvnets_tpu_torch.ops.seg_ce import resize_bilinear


@MODEL_REGISTRY.register(name="encoder_decoder", type="segmentation")
class SegEncoderDecoder(BaseSegmentation):
    def __init__(self, opts) -> None:
        super().__init__(opts)
        if getattr(opts, "model.segmentation.freeze_batch_norm", False):
            raise NotImplementedError("--model.segmentation.freeze-batch-norm is not "
                                      "ported yet")
        output_stride = getattr(opts, "model.segmentation.output_stride", None)
        kwargs = {"output_stride": output_stride} if output_stride in (8, 16) else {}
        name = getattr(opts, "model.classification.name")
        self.encoder = MODEL_REGISTRY[name, "classification"].build_model(opts, **kwargs)
        # the encoder's classifier is never called here, so the flax tree has none
        self.encoder.classifier = None

        head_opts = opts  # --model.segmentation.norm-layer: the head's norm only
        seg_norm = getattr(opts, "model.segmentation.norm_layer", None)
        if seg_norm:
            head_opts = argparse.Namespace(**vars(opts))
            setattr(head_opts, "model.normalization.name", seg_norm)
        head = getattr(opts, "model.segmentation.seg_head", "deeplabv3")
        self.seg_head = MODEL_REGISTRY[head, "segmentation_head"].build_model(
            head_opts, self.encoder.model_conf_dict)
        self.use_l5_exp = getattr(opts, "model.segmentation.use_level5_exp", False)
        self.upsample_train_logits = getattr(
            opts, "model.segmentation.upsample_train_logits", False)

    def forward(self, x: torch.Tensor) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        end_points = self.encoder.extract_end_points_all(x, use_l5=True,
                                                         use_l5_exp=self.use_l5_exp)
        out = self.seg_head(end_points)
        if self.training and not self.upsample_train_logits:
            return out
        size = tuple(x.shape[-2:])
        if isinstance(out, dict):
            return {k: resize_bilinear(v, size) for k, v in out.items()}
        return resize_bilinear(out, size)
