"""Single Shot Detector / SSDLite (counterpart of cvnets_tpu/models/detection/ssd.py;
arXiv:1512.02325).

The encoder's taps at output strides 16 and 32 (``out_l4``, ``out_l5``), extra
stride-2 separable convs for 64, 128 and 256, a global pool and a 1×1 conv
for the stride -1 map, and one ``SSDHead`` per stride. The forward returns
``scores`` (B, P, n_classes), ``boxes`` (B, P, 4) and the center-form
``anchors`` (P, 4) of the input's (h, w): made on the host once per (h, w)
and kept on the model's device (they go up once, from pinned memory, without
a sync; an offline eval at native resolution meets a new (h, w) per image
size).

``postprocess`` decodes and suppresses on the device for a whole batch, with
static shapes and no read-back: softmax, decode against the anchors, the
``top_k`` (anchor, class) pairs of the foreground scores, the confidence
threshold, then class-aware padded NMS (``ops/nms.batched_nms``) to
``objects_per_image`` slots. ``--model.detection.ssd.use-fpn`` raises: the
feature pyramid waits for ROADMAP.md queue 1 item 5.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn as nn

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d, SeparableConv2d
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.models.anchor_generator import build_anchor_generator
from cvnets_tpu_torch.models.detection import DetectionPredTuple
from cvnets_tpu_torch.models.detection.base_detection import BaseDetection
from cvnets_tpu_torch.models.matcher_det import build_matcher
from cvnets_tpu_torch.modules.ssd_heads import SSDHead
from cvnets_tpu_torch.ops.nms import batched_nms
from cvnets_tpu_torch.ops.seg_ce_kernel import upload


def anchor_generator_and_matcher(opts):
    """The options' SSD anchor generator and matcher (``ssd`` where unnamed)."""
    for key in ("anchor_generator.name", "matcher.name"):
        if getattr(opts, key, None) is None:
            setattr(opts, key, "ssd")
    return build_anchor_generator(opts), build_matcher(opts)


def anchors_for(generator, height: int, width: int) -> np.ndarray:
    """The (P, 4) anchors of an input of (height, width), stride by stride."""
    anchors = []
    for os_ in generator.output_strides:
        fh, fw = (1, 1) if os_ == -1 else (math.ceil(height / os_), math.ceil(width / os_))
        anchors.append(generator(fh, fw, os_))
    return np.concatenate(anchors, axis=0)


@MODEL_REGISTRY.register(name="ssd", type="detection")
class SingleShotMaskDetector(BaseDetection):
    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        prefix = "--model.detection.ssd."
        group.add_argument(prefix + "anchors-aspect-ratio", type=int, nargs="+",
                           action="append", default=None)
        group.add_argument(prefix + "output-strides", type=int, nargs="+", default=None)
        group.add_argument(prefix + "proj-channels", type=int, nargs="+", default=None)
        for name in ("min-box-size", "max-box-size", "center-variance", "size-variance",
                     "iou-threshold"):
            group.add_argument(prefix + name, type=float, default=None)
        group.add_argument(prefix + "conf-threshold", type=float, default=0.01)
        group.add_argument(prefix + "top-k", type=int, default=400)
        group.add_argument(prefix + "objects-per-image", type=int, default=200)
        group.add_argument(prefix + "nms-iou-threshold", type=float, default=0.5)
        group.add_argument(prefix + "fpn-out-channels", type=int, default=256)
        group.add_argument(prefix + "use-fpn", action="store_true")
        return parser

    def __init__(self, opts) -> None:
        super().__init__()
        if getattr(opts, "model.detection.ssd.use_fpn", False):
            raise NotImplementedError(
                "not ported yet: --model.detection.ssd.use-fpn (the feature pyramid, "
                "cvnets_tpu/modules/feature_pyramid.py) waits for ROADMAP.md queue 1 item 5")
        prefix = "model.detection.ssd."
        self.conf_threshold = getattr(opts, prefix + "conf_threshold", 0.01)
        self.top_k = getattr(opts, prefix + "top_k", 400)
        self.objects_per_image = getattr(opts, prefix + "objects_per_image", 200)
        self.nms_threshold = getattr(opts, prefix + "nms_iou_threshold", 0.5)
        self.n_detection_classes = getattr(opts, "model.detection.n_classes", 80)
        self.anchor_generator, self.matcher = anchor_generator_and_matcher(opts)
        self.output_strides = self.anchor_generator.output_strides
        self.encoder = self.build_encoder(opts)
        self.encoder.conv_1x1_exp = None  # never called: out_l5 is the last tap

        n_os = len(self.output_strides)
        proj = list(getattr(opts, prefix + "proj_channels", None)
                    or [512, 256, 256, 128, 128, 64][:n_os])
        proj += [256] * (n_os - len(proj))
        conf = self.encoder.model_conf_dict
        tap_channels = {16: conf["layer4"]["out"], 32: conf["layer5"]["out"]}
        extra, channels, prev = [], [], tap_channels[32]
        for idx, os_ in enumerate(self.output_strides):
            if os_ in tap_channels:
                ch = tap_channels[os_]
            elif os_ == -1:
                extra.append(ConvLayer2d(opts, prev, proj[idx], 1, use_norm=False))
                ch = proj[idx]
            else:
                extra.append(SeparableConv2d(opts, prev, proj[idx], 3, stride=2))
                ch = proj[idx]
            channels.append(ch)
            prev = ch
        self.extra_layers = nn.ModuleList(extra)
        anchors_per_os = self.anchor_generator.num_anchors_per_os()
        self.ssd_heads = nn.ModuleList(
            SSDHead(opts, channels[i], self.n_detection_classes, anchors_per_os[i],
                    proj_channels=proj[i], kernel_size=3 if os_ != -1 else 1)
            for i, os_ in enumerate(self.output_strides))
        self._anchors: Dict[Tuple[int, int, torch.device], torch.Tensor] = {}

    def anchors(self, height: int, width: int, device: torch.device) -> torch.Tensor:
        key = (height, width, device)
        if key not in self._anchors:
            self._anchors[key] = upload(torch.from_numpy(
                anchors_for(self.anchor_generator, height, width)), device)
        return self._anchors[key]

    def feature_maps(self, x: torch.Tensor) -> List[torch.Tensor]:
        end_points = self.encoder.extract_end_points_all(x, use_l5=True)
        fms, extra, prev = [], iter(self.extra_layers), None
        for os_ in self.output_strides:
            if os_ == 16:
                fm = end_points["out_l4"]
            elif os_ == 32:
                fm = end_points["out_l5"]
            else:
                src = prev if prev is not None else end_points["out_l5"]
                if os_ == -1:
                    src = src.mean(dim=(2, 3), keepdim=True)
                fm = next(extra)(src)
            fms.append(fm)
            prev = fm
        return fms

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        boxes, scores = zip(*(head(fm) for fm, head in zip(self.feature_maps(x),
                                                            self.ssd_heads)))
        return {"scores": torch.cat(scores, dim=1), "boxes": torch.cat(boxes, dim=1),
                "anchors": self.anchors(x.shape[-2], x.shape[-1], x.device)}

    @torch.no_grad()
    def postprocess(self, prediction: Dict[str, torch.Tensor]) -> DetectionPredTuple:
        """Labels (B, K), scores (B, K) (0 in an empty slot) and corner-form
        boxes (B, K, 4) in [0, 1], K = min(objects_per_image, top_k)."""
        scores = torch.softmax(prediction["scores"].float(), dim=-1)
        boxes = self.matcher.convert_to_boxes(prediction["boxes"].float(),
                                              prediction["anchors"])
        n_fg = scores.shape[-1] - 1
        flat = scores[..., 1:].reshape(scores.shape[0], -1)
        k = min(self.top_k, flat.shape[1])
        top_scores, top_idx = flat.topk(k, dim=-1)
        anchor_idx, class_idx = top_idx // n_fg, top_idx % n_fg + 1
        cand_boxes = boxes.gather(1, anchor_idx[..., None].expand(-1, -1, 4))
        cand_scores = torch.where(top_scores > self.conf_threshold, top_scores,
                                  torch.full_like(top_scores, float("-inf")))
        keep, keep_scores = batched_nms(cand_boxes, cand_scores, class_idx,
                                        iou_threshold=self.nms_threshold,
                                        max_output=min(self.objects_per_image, k))
        safe = keep.clamp(min=0)
        out_boxes = cand_boxes.gather(1, safe[..., None].expand(-1, -1, 4)).clamp(0.0, 1.0)
        out_labels = class_idx.gather(1, safe)
        out_scores = torch.where((keep >= 0) & torch.isfinite(keep_scores), keep_scores,
                                 torch.zeros_like(keep_scores))
        return DetectionPredTuple(labels=out_labels, scores=out_scores, boxes=out_boxes)

    @torch.no_grad()
    def predict(self, x: torch.Tensor) -> DetectionPredTuple:
        return self.postprocess(self.eval()(x))
