"""Mask R-CNN (counterpart of cvnets_tpu/models/detection/mask_rcnn.py), with
the JAX model's static shapes: ground truth padded to ``MAX_GT`` boxes an
image (label 0 = padding), a fixed ``pre_nms_top_n`` of anchors into a padded
NMS that keeps ``post_nms_top_n`` proposals (empty slots hold zero boxes),
sampling as 0/1 masks ranked by uniform draws, and a fixed number of
positive slots for the mask head. Nothing is read back to the host, so a
step or a ``predict`` runs without a sync.

The encoder's taps at strides 4, 8, 16 and 32 (``out_l2`` … ``out_l5``; a
ViT gives them through its simple FPN) go through the feature pyramid (or,
under ``--model.detection.mask-rcnn.disable-fpn``, a 1×1 conv + norm a tap),
the RPN head over every level's anchors, then RoIAlign (``ops/roi_align.py``)
into the box head and, in training and for the kept detections, the mask
head. Proposals are detached: the RPN learns from its own losses alone.

Training (``model.train()`` with targets) returns ``{"losses": {...}}``, the
five losses ``MaskRCNNLoss`` weighs. Its random draws (the RPN's and the RoI
heads' balanced samplers, the RoI heads' compaction) are uniform tensors:
``forward(..., draws=...)`` takes them (``draw`` makes them from a
generator; the train step passes a generator seeded by (seed, step,
``DETECTION_STREAM``)). Every rank breaks ties as JAX does, by the lower
index (a stable sort), where ``torch.topk`` promises no order. Eval returns
``det_labels`` / ``det_scores`` / ``det_boxes`` (image pixels) and
``det_masks`` (28×28 probabilities); ``postprocess`` pastes the masks at the
input's size for the whole batch.
"""

from __future__ import annotations

import argparse
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
from cvnets_tpu_torch.models import MODEL_REGISTRY
from cvnets_tpu_torch.parallel import mean_divisor
from cvnets_tpu_torch.models.detection import DetectionPredTuple
from cvnets_tpu_torch.models.detection.base_detection import BaseDetection
from cvnets_tpu_torch.models.detection.utils.rcnn_utils import (
    FastRCNNConvFCHead,
    FastRCNNPredictor,
    MaskRCNNHeads,
    RPNHead,
    balanced_sample_mask,
    decode_boxes,
    encode_boxes,
    gather_rows,
    match_boxes,
    top_k_stable,
)
from cvnets_tpu_torch.modules.feature_pyramid import FeaturePyramidNetwork
from cvnets_tpu_torch.ops.mask_paste import paste_masks
from cvnets_tpu_torch.ops.nms import batched_nms, nms
from cvnets_tpu_torch.ops.roi_align import multiscale_roi_align, roi_align_matrices
from cvnets_tpu_torch.ops.seg_ce_kernel import upload

MAX_GT = 100
BOX_CODER_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
_TAPS = {4: "out_l2", 8: "out_l3", 16: "out_l4", 32: "out_l5"}
# torch.profiler ranges of a step's parts (chip_smoke.py splits device time by
# them): the encoder, the FPN, the RPN with its NMS, matching and sampling,
# RoIAlign, and the box and mask heads
BACKBONE_RANGE, FPN_RANGE, RPN_RANGE, ROI_RANGE, HEADS_RANGE = (
    "mask_rcnn_backbone", "mask_rcnn_fpn", "mask_rcnn_rpn", "mask_rcnn_roi_align",
    "mask_rcnn_heads")


def _smooth_l1(x: torch.Tensor, y: torch.Tensor, beta: float = 1.0 / 9) -> torch.Tensor:
    d = (x - y).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def _clip_boxes(boxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Corner-form boxes clipped to [0, w] × [0, h]."""
    x1, y1, x2, y2 = boxes.clamp(min=0.0).unbind(-1)
    return torch.stack([x1.clamp(max=w), y1.clamp(max=h), x2.clamp(max=w), y2.clamp(max=h)],
                       dim=-1)


def fpn_anchors(fm_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                sizes: Sequence[int], ratios=(0.5, 1.0, 2.0)) -> np.ndarray:
    """(A, 4) float32 corner-form anchors in image pixels, level by level, in
    (row, column, ratio) order (mask_rcnn.py:57-78)."""
    all_anchors = []
    for (h, w), stride, size in zip(fm_shapes, strides, sizes):
        whs = np.asarray([[size * math.sqrt(1.0 / r), size * math.sqrt(r)] for r in ratios])
        cy, cx = np.meshgrid((np.arange(h) + 0.5) * stride, (np.arange(w) + 0.5) * stride,
                             indexing="ij")
        centers = np.stack([cx.ravel(), cy.ravel()], -1)
        p, a = centers.shape[0], whs.shape[0]
        c, half = np.repeat(centers, a, 0), np.tile(whs, (p, 1)) / 2
        all_anchors.append(np.concatenate([c - half, c + half], -1).astype(np.float32))
    return np.concatenate(all_anchors, 0)


def _encoder_taps(encoder: nn.Module, strides: Sequence[int]) -> List[Tuple[str, int]]:
    """(end point, channels) of each stride's tap that the encoder gives, in
    order (``model_conf_dict``'s ``layer2`` … ``layer5``)."""
    conf = encoder.model_conf_dict
    return [(_TAPS[s], conf[f"layer{_TAPS[s][-1]}"]["out"]) for s in strides
            if s in _TAPS and f"layer{_TAPS[s][-1]}" in conf]



def roi_box_losses(scores: torch.Tensor, deltas: torch.Tensor, labels: torch.Tensor,
                   reg_targets: torch.Tensor, pos: torch.Tensor, valid: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
    """The box head's classifier CE over the valid sampled RoIs and its
    smooth-L1 over the positive ones, of (B, N, C) scores and (B, N, C, 4)
    deltas (mask_rcnn.py:310-321). Each sum is divided by the batch's count,
    the global batch's in training in a process group
    (``parallel.mean_divisor``), as the JAX model sees the whole batch."""
    valid, pos = valid.float(), pos.float()
    ce = F.cross_entropy(scores.float().flatten(0, 1), labels.flatten(),
                         reduction="none").reshape(labels.shape)
    sel = deltas.gather(2, labels.clamp(min=0)[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    reg = _smooth_l1(sel.float(), reg_targets).sum(-1)
    return {"loss_classifier": (ce * valid).sum() / mean_divisor(valid.sum()),
            "loss_box_reg": (reg * pos).sum() / mean_divisor(pos.sum())}


def roi_mask_loss(logits: torch.Tensor, targets: torch.Tensor, valid: torch.Tensor
                  ) -> torch.Tensor:
    """The mean binary CE of each positive RoI's (28, 28) mask logits against
    its target mask (> 0.5), over the positive RoIs (mask_rcnn.py:364-372),
    divided by the global batch's count as ``roi_box_losses``."""
    ls = F.binary_cross_entropy_with_logits(logits.float(), (targets > 0.5).float(),
                                            reduction="none")
    return ((ls.mean(dim=(-1, -2)) * valid).sum()
            / mean_divisor(valid.sum()))

@MODEL_REGISTRY.register(name="mask_rcnn", type="detection")
class MaskRCNNDetector(BaseDetection):
    TAKES_GENERATOR = True  # the train step passes its (seed, step) generator
    BOXES_IN_PIXELS = True  # predict's boxes are the input's pixels, not [0, 1]

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        group = parser.add_argument_group(title=cls.__name__)
        prefix = "--model.detection.mask-rcnn."
        group.add_argument(prefix + "backbone-lr-multiplier", type=float, default=1.0)
        group.add_argument(prefix + "output-strides", type=int, nargs="+",
                           default=[4, 8, 16, 32])
        group.add_argument(prefix + "anchor-sizes", type=int, nargs="+",
                           default=[32, 64, 128, 256])
        for name, default in (("fpn-out-channels", 256), ("pre-nms-top-n", 1000),
                              ("post-nms-top-n", 256), ("rpn-batch-per-image", 256),
                              ("box-batch-per-image", 128), ("mask-positives", 32),
                              ("detections-per-image", 100)):
            group.add_argument(prefix + name, type=int, default=default)
        for name, default in (("rpn-fg-iou-thresh", 0.7), ("rpn-bg-iou-thresh", 0.3),
                              ("box-fg-iou-thresh", 0.5), ("box-bg-iou-thresh", 0.5),
                              ("score-threshold", 0.05)):
            group.add_argument(prefix + name, type=float, default=default)
        group.add_argument(prefix + "disable-mask-head", action="store_true", default=False)
        group.add_argument(prefix + "disable-fpn", action="store_true", default=False,
                           help="1x1 projections per tap instead of a feature pyramid")
        group.add_argument(prefix + "norm-layer", type=str, default=None,
                           help="norm of the RPN, box and mask heads; None = no norm")
        return parser

    def __init__(self, opts) -> None:
        super().__init__()
        cfg = lambda key, default: getattr(opts, f"model.detection.mask_rcnn.{key}",  # noqa: E731
                                           default)
        self.n_detection_classes = getattr(opts, "model.detection.n_classes", 80)
        self.encoder = self.build_encoder(opts)
        self.encoder.conv_1x1_exp = None  # never called: out_l5 is the last tap
        strides = cfg("output_strides", [4, 8, 16, 32])
        self.taps, in_channels = zip(*_encoder_taps(self.encoder, strides))
        # the first len(taps) strides, as JAX pairs them (a ViT without the
        # simple FPN gives out_l5 alone, at the first stride)
        self.strides = list(strides[:len(in_channels)])
        self.anchor_sizes = list(cfg("anchor_sizes", [32, 64, 128, 256])[:len(in_channels)])
        fpn_ch = cfg("fpn_out_channels", 256)
        self.use_fpn = not cfg("disable_fpn", False)
        if self.use_fpn:
            self.fpn = FeaturePyramidNetwork(opts, in_channels, fpn_ch)
        else:
            self.proj_layers = nn.ModuleList(
                ConvLayer2d(opts, ch, fpn_ch, 1, use_act=False) for ch in in_channels)
        self.rpn_head = RPNHead(opts, fpn_ch, num_anchors=3)
        self.box_head = FastRCNNConvFCHead(opts, fpn_ch)
        self.box_predictor = FastRCNNPredictor(1024, self.n_detection_classes)
        self.use_mask = not cfg("disable_mask_head", False)
        if self.use_mask:
            self.mask_head = MaskRCNNHeads(opts, fpn_ch, n_classes=self.n_detection_classes)
        self.pre_nms_top_n = cfg("pre_nms_top_n", 1000)
        self.post_nms_top_n = cfg("post_nms_top_n", 256)
        self.rpn_iou = (cfg("rpn_fg_iou_thresh", 0.7), cfg("rpn_bg_iou_thresh", 0.3))
        self.box_iou = (cfg("box_fg_iou_thresh", 0.5), cfg("box_bg_iou_thresh", 0.5))
        self.rpn_batch = cfg("rpn_batch_per_image", 256)
        self.box_batch = cfg("box_batch_per_image", 128)
        self.mask_positives = cfg("mask_positives", 32)
        self.detections_per_image = cfg("detections_per_image", 100)
        self.score_threshold = cfg("score_threshold", 0.05)
        self.backbone_lr_multiplier = cfg("backbone_lr_multiplier", 1.0)
        self._anchors: Dict[tuple, torch.Tensor] = {}

    # ---------------------------------------------------------------- features
    def feature_maps(self, x: torch.Tensor) -> List[torch.Tensor]:
        with torch.profiler.record_function(BACKBONE_RANGE):
            end_points = self.encoder.extract_end_points_all(x, use_l5=True)
        fms = [end_points[tap] for tap in self.taps]
        with torch.profiler.record_function(FPN_RANGE):
            if self.use_fpn:
                return self.fpn(fms)
            return [proj(fm) for proj, fm in zip(self.proj_layers, fms)]

    def anchors(self, fm_shapes: Sequence[Tuple[int, int]], device: torch.device) -> torch.Tensor:
        key = (tuple(fm_shapes), device)
        if key not in self._anchors:  # made once a size, sent up without a sync
            self._anchors[key] = upload(torch.from_numpy(
                fpn_anchors(fm_shapes, self.strides, self.anchor_sizes)), device)
        return self._anchors[key]

    # ------------------------------------------------------------------ draws
    def draw(self, batch: int, n_anchors: int, n_gt: int, generator: torch.Generator) -> Dict:
        """The uniform draws of one training forward: the RPN sampler's (2, B,
        A) and the RoI heads' (3, B, post_nms_top_n + n_gt): positives',
        negatives' and the compaction's."""
        dev = generator.device
        n_cand = self.post_nms_top_n + n_gt
        return {"rpn": torch.rand((2, batch, n_anchors), generator=generator, device=dev),
                "roi": torch.rand((3, batch, n_cand), generator=generator, device=dev)}

    # -------------------------------------------------------------------- RPN
    def _proposals(self, obj: torch.Tensor, deltas: torch.Tensor, anchors: torch.Tensor,
                   img_hw: Tuple[int, int]) -> torch.Tensor:
        pre_n = min(self.pre_nms_top_n, obj.shape[1])
        scores, idx = top_k_stable(obj, pre_n)
        boxes = decode_boxes(gather_rows(deltas, idx), anchors[idx])
        boxes = _clip_boxes(boxes, *img_hw)
        keep, _ = nms(boxes, scores, iou_threshold=0.7, max_output=self.post_nms_top_n)
        out = gather_rows(boxes, keep.clamp(min=0))
        return torch.where((keep >= 0)[..., None], out, 0.0).detach()

    def _rpn_losses(self, obj, deltas, anchors, gt_boxes, gt_valid, draws) -> Dict:
        midx, labels = match_boxes(anchors, gt_boxes, gt_valid, *self.rpn_iou)
        pos, neg = balanced_sample_mask(labels, self.rpn_batch, 0.5, draws[0], draws[1])
        sel = (pos | neg).float()
        n_sel = sel.sum(-1).clamp(min=1.0)
        obj_ls = F.binary_cross_entropy_with_logits(obj, (labels == 1).to(obj.dtype),
                                                    reduction="none")
        reg_t = encode_boxes(anchors, gather_rows(gt_boxes, midx))
        reg_ls = _smooth_l1(deltas, reg_t).sum(-1)
        # per-image means, then the mean over the images: exact on a rank's
        # shard under equal per-rank batches, so no count crosses the ranks
        return {"loss_objectness": ((obj_ls * sel).sum(-1) / n_sel).mean(),
                "loss_rpn_box_reg": ((reg_ls * pos).sum(-1) / n_sel).mean()}

    # -------------------------------------------------------------- RoI heads
    def _sample(self, proposals, gt_boxes, gt_labels, gt_valid, draws):
        props = torch.cat([proposals, gt_boxes.to(proposals.dtype)], dim=1)
        box_batch = min(self.box_batch, props.shape[1])
        midx, labels = match_boxes(props, gt_boxes, gt_valid, *self.box_iou)
        pos, neg = balanced_sample_mask(labels, box_batch, 0.25, draws[0], draws[1])
        order = torch.where(pos | neg, draws[2], -1.0)
        top, take = top_k_stable(order, box_batch)
        valid = top > 0
        boxes, t_midx = gather_rows(props, take), midx.gather(1, take)
        t_pos = pos.gather(1, take) & valid
        t_labels = torch.where(t_pos, gt_labels.gather(1, t_midx), 0)
        reg_t = encode_boxes(boxes, gather_rows(gt_boxes, t_midx), BOX_CODER_WEIGHTS)
        return boxes, t_labels, reg_t, t_pos, valid, t_midx

    def _box_head(self, fms, boxes):
        with torch.profiler.record_function(ROI_RANGE):
            feats = multiscale_roi_align(fms, boxes, self.strides, (7, 7))
        b, n = feats.shape[:2]
        with torch.profiler.record_function(HEADS_RANGE):
            scores, deltas = self.box_predictor(self.box_head(feats.flatten(0, 1)))
        return scores.reshape(b, n, -1), deltas.reshape(b, n, -1, 4)

    def _mask_logits(self, fms, boxes, labels):
        """The mask head's logits of each box's class, (B, K, 28, 28)."""
        with torch.profiler.record_function(ROI_RANGE):
            feats = multiscale_roi_align(fms, boxes, self.strides, (14, 14))
        b, k = feats.shape[:2]
        with torch.profiler.record_function(HEADS_RANGE):
            logits = self.mask_head(feats.flatten(0, 1))
        idx = labels.reshape(-1, 1, 1, 1).clamp(min=0).expand(-1, 1, *logits.shape[-2:])
        return logits.gather(1, idx)[:, 0].reshape(b, k, *logits.shape[-2:])

    @staticmethod
    def _mask_targets(gt_masks, boxes, midx, img_h: int) -> torch.Tensor:
        """Each box's matched gt mask RoI-aligned to 28×28, in float32 (or the
        boxes' float64), outside autocast."""
        with torch.autocast(gt_masks.device.type, enabled=False):
            dtype = torch.promote_types(boxes.dtype, torch.float32)
            gm = gather_rows(gt_masks, midx).to(dtype)  # (B, K, Hm, Wm)
            stride = img_h / gt_masks.shape[-2]
            wy, wx = roi_align_matrices(boxes.to(dtype) / stride, gm.shape[-2], gm.shape[-1],
                                        (28, 28))
            return torch.matmul(torch.matmul(wy, gm), wx.transpose(-1, -2))

    def _head_losses(self, fms, sampled, gt_masks, img_h) -> Dict:
        s_boxes, s_labels, s_regt, s_pos, s_valid, s_midx = sampled
        scores, deltas = self._box_head(fms, s_boxes)
        losses = roi_box_losses(scores, deltas, s_labels, s_regt, s_pos, s_valid)
        if self.use_mask and gt_masks is not None:
            n = s_pos.shape[1]
            score = (torch.where(s_pos, 1.0, -1.0)
                     + torch.arange(n, device=s_pos.device, dtype=torch.float32) * 1e-6)
            _, take = top_k_stable(score, self.mask_positives)
            m_valid = s_pos.gather(1, take).float()
            m_boxes, m_labels = gather_rows(s_boxes, take), s_labels.gather(1, take)
            logits = self._mask_logits(fms, m_boxes, m_labels)
            target = self._mask_targets(gt_masks, m_boxes, s_midx.gather(1, take), img_h)
            losses["loss_mask"] = roi_mask_loss(logits, target, m_valid)
        return scores, deltas, losses

    # --------------------------------------------------------- detection core
    def detect(self, scores: torch.Tensor, deltas: torch.Tensor, proposals: torch.Tensor,
               img_hw: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Decode, score threshold and class-aware NMS of a batch (JAX's
        ``_detect_one`` on every image): (labels, scores, boxes), padded to
        ``detections_per_image``."""
        probs = torch.softmax(scores.float(), dim=-1)
        boxes = decode_boxes(deltas.float(), proposals[:, :, None, :], BOX_CODER_WEIGHTS)
        b, n, c = probs.shape
        fg = probs[..., 1:].reshape(b, -1)
        fg_boxes = boxes[:, :, 1:].reshape(b, -1, 4)
        cls_ids = torch.arange(1, c, device=probs.device).repeat(n).expand(b, -1)
        k = min(self.detections_per_image * 4, fg.shape[1])
        top, idx = top_k_stable(fg, k)
        cand = torch.where(top > self.score_threshold, top, float("-inf"))
        cand_boxes, cand_cls = gather_rows(fg_boxes, idx), cls_ids.gather(1, idx)
        keep, kept = batched_nms(cand_boxes, cand, cand_cls, iou_threshold=0.5,
                                 max_output=self.detections_per_image)
        safe = keep.clamp(min=0)
        out_boxes = _clip_boxes(gather_rows(cand_boxes, safe), *img_hw)
        found = keep >= 0
        out_scores = torch.where(found & torch.isfinite(kept), kept, 0.0)
        return torch.where(found, cand_cls.gather(1, safe), 0), out_scores, out_boxes

    # ---------------------------------------------------------------- forward
    def forward(self, x, targets: Optional[Dict] = None, draws: Optional[Dict] = None,
                generator: Optional[torch.Generator] = None) -> Dict:
        """``x`` an image batch (B, 3, H, W) or ``{"image", "targets"}``;
        ``targets``: ``box_coordinates`` (B, MAX_GT, 4) pixels,
        ``box_labels`` (B, MAX_GT) and ``masks`` (B, MAX_GT, H/4, W/4)."""
        if isinstance(x, dict):
            targets = targets or x.get("targets")
            x = x["image"]
        img_hw = tuple(x.shape[-2:])
        b = x.shape[0]
        fms = self.feature_maps(x)
        with torch.profiler.record_function(RPN_RANGE):
            logits_l, deltas_l = self.rpn_head(fms)
            anchors = self.anchors([tuple(f.shape[-2:]) for f in fms], x.device)
            obj = torch.cat([t.permute(0, 2, 3, 1).reshape(b, -1) for t in logits_l], dim=1)
            deltas = torch.cat([t.permute(0, 2, 3, 1).reshape(b, -1, 4) for t in deltas_l],
                               dim=1)
            proposals = self._proposals(obj, deltas, anchors, img_hw)
        out = {"image_hw": img_hw}
        if self.training and targets is not None:
            gt_boxes = targets["box_coordinates"].float()
            if draws is None:
                if generator is None:
                    generator = torch.Generator(device=x.device).manual_seed(0)
                draws = self.draw(b, anchors.shape[0], gt_boxes.shape[1], generator)
            gt_labels = targets["box_labels"].long()
            gt_valid = gt_labels > 0
            with torch.profiler.record_function(RPN_RANGE):
                losses = self._rpn_losses(obj, deltas, anchors, gt_boxes, gt_valid,
                                          draws["rpn"])
                sampled = self._sample(proposals, gt_boxes, gt_labels, gt_valid,
                                       draws["roi"])
            scores, box_deltas, head_losses = self._head_losses(
                fms, sampled, targets.get("masks"), img_hw[0])
            losses.update(head_losses)
            out.update(scores=scores, deltas=box_deltas, proposals=sampled[0], losses=losses)
            return out
        scores, box_deltas = self._box_head(fms, proposals)
        out.update(scores=scores, deltas=box_deltas, proposals=proposals)
        if not self.training:
            labels, det_scores, det_boxes = self.detect(scores, box_deltas, proposals, img_hw)
            out.update(det_labels=labels, det_scores=det_scores, det_boxes=det_boxes)
            if self.use_mask:
                out["det_masks"] = torch.sigmoid(
                    self._mask_logits(fms, det_boxes, labels).float())
        return out

    # ---------------------------------------------------------------- predict
    @torch.no_grad()
    def postprocess(self, prediction: Dict) -> DetectionPredTuple:
        """Labels (B, K), scores (B, K) (0 in an empty slot), boxes (B, K, 4)
        in the input's pixels and, with the mask head, masks (B, K, H, W):
        the 28×28 probabilities pasted at the input's size."""
        masks = None
        if "det_masks" in prediction:
            masks = paste_masks(prediction["det_masks"], prediction["det_boxes"],
                                prediction["image_hw"])
        return DetectionPredTuple(labels=prediction["det_labels"],
                                  scores=prediction["det_scores"],
                                  boxes=prediction["det_boxes"], masks=masks)

    @torch.no_grad()
    def predict(self, x: torch.Tensor) -> DetectionPredTuple:
        return self.postprocess(self.eval()(x))

    def get_lr_multipliers(self, opts=None) -> Dict[str, float]:
        """The encoder's parameters at ``--model.detection.mask-rcnn.backbone-lr-multiplier``."""
        mult = self.backbone_lr_multiplier
        return {} if mult == 1.0 else {r"encoder": mult}
