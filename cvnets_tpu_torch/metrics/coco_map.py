"""COCO-style box mAP in numpy (counterpart of cvnets_tpu/metrics/coco_map.py,
which stands in for pycocotools' COCOeval): AP averaged over IoU thresholds
0.50:0.05:0.95, 101-point interpolated precision, per class then mean, greedy
highest-IoU matching of score-sorted detections preferring non-ignored ground
truth, crowd boxes as ignore regions (IoU over the detection's area, matched
any number of times), the area ranges (all/small/medium/large), ``max_dets``
and the average recall, for the ``bbox`` and ``segm`` IoU types. ``segm``
scores instance masks: a detection's and a ground truth's binary masks
(``> 0.5``) of the image's size, their IoU and areas counted in pixels (the
JAX ``_mask_iou_np``, here one matrix product an image and class), and it
needs ``masks`` in every detection and ground truth it scores.

``COCOMapMetric`` gathers detections and ground truth on the host and scores
them at the end (the offline detection evaluation,
``engine/eval_detection.py``); the Trainer's per-step (sum, count) pairs
cannot carry it, so in ``stats.train`` or ``stats.val`` it raises.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from cvnets_tpu_torch.metrics import METRICS_REGISTRY
from cvnets_tpu_torch.metrics.metric_base import BaseMetric

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
MAX_DETS = 100
IOU_TYPES = ("bbox", "segm")


def _box_iou_np(a: np.ndarray, b: np.ndarray, b_crowd: np.ndarray) -> np.ndarray:
    """IoU (A, B); a crowd box's denominator is the detection's area."""
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a, area_b = _area_of(a), _area_of(b)
    union = area_a[:, None] + area_b[None, :] - inter
    denom = np.where(b_crowd[None, :], area_a[:, None], union)
    return inter / np.maximum(denom, 1e-9)


def _mask_iou_np(a: np.ndarray, b: np.ndarray, b_crowd: np.ndarray) -> np.ndarray:
    """IoU (A, B) of binary masks (A, P) and (B, P) flattened; a crowd mask's
    denominator is the detection's area."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    inter = a @ b.T
    area_a, area_b = a.sum(1), b.sum(1)
    denom = np.where(b_crowd[None, :], area_a[:, None],
                     area_a[:, None] + area_b[None, :] - inter)
    return inter / np.maximum(denom, 1e-9)


def _binary_masks(masks, n: int) -> np.ndarray:
    """(N, H·W) bool of a list or array of N masks (``> 0.5``)."""
    if n == 0:
        return np.zeros((0, 0), bool)
    return np.stack([np.asarray(m).reshape(-1) > 0.5 for m in masks])


def _evaluate_image(ious: np.ndarray, gt_ignore: np.ndarray, gt_crowd: np.ndarray,
                    det_out_of_range: np.ndarray, iou_thresholds: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """pycocotools' evaluateImg: detections sorted by score, ground truth
    non-ignored first. (true positive, detection ignored), each (T, D)."""
    nd, ng = ious.shape
    tp = np.zeros((len(iou_thresholds), nd), bool)
    dt_ig = np.zeros((len(iou_thresholds), nd), bool)
    for ti, thr in enumerate(iou_thresholds):
        gt_used = np.zeros(ng, bool)
        for d in range(nd):
            best, best_iou = -1, min(thr, 1 - 1e-10)
            for g in range(ng):
                if gt_used[g] and not gt_crowd[g]:
                    continue
                # matched to a non-ignored box: never switch to an ignored one
                if best > -1 and not gt_ignore[best] and gt_ignore[g]:
                    break
                if ious[d, g] < best_iou:
                    continue
                best_iou, best = ious[d, g], g
            if best == -1:
                dt_ig[ti, d] = det_out_of_range[d]
                continue
            gt_used[best] = True
            dt_ig[ti, d] = gt_ignore[best]
            tp[ti, d] = not gt_ignore[best]
    return tp, dt_ig


def _area_of(boxes: np.ndarray) -> np.ndarray:
    return (np.clip(boxes[:, 2] - boxes[:, 0], 0, None)
            * np.clip(boxes[:, 3] - boxes[:, 1], 0, None))


def _geometry(entry: Dict, sel: np.ndarray, iou_type: str):
    """The selected boxes (N, 4), or masks (N, H·W) bool for ``segm``, and their areas."""
    if iou_type == "segm":
        masks = _binary_masks([m for m, s in zip(entry["masks"], sel) if s], int(sel.sum()))
        return masks, masks.sum(1).astype(np.float64)
    boxes = np.asarray(entry["boxes"], np.float32).reshape(-1, 4)[sel]
    return boxes, _area_of(boxes)


def _class_ap(detections: List[Dict], ground_truths: List[Dict], cls: int, lo: float,
              hi: float, iou_thresholds: np.ndarray, max_dets: int, iou_type: str = "bbox"
              ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(AP, recall) at each threshold of one class in one area range, or None
    where the class has no ground truth there."""
    nt = len(iou_thresholds)
    iou_fn = _mask_iou_np if iou_type == "segm" else _box_iou_np
    scores_acc, tp_acc, ig_acc, n_gt = [], [], [], 0
    for det, gt in zip(detections, ground_truths):
        g_sel = np.asarray(gt["labels"]).reshape(-1) == cls
        g_geom, g_area = _geometry(gt, g_sel, iou_type)
        g_crowd = np.asarray(gt.get("iscrowd", np.zeros(len(g_sel))), bool)[g_sel]
        g_ignore = g_crowd | (g_area < lo) | (g_area > hi)
        order_g = np.argsort(g_ignore, kind="stable")  # non-ignored first
        g_geom, g_crowd, g_ignore = g_geom[order_g], g_crowd[order_g], g_ignore[order_g]
        n_gt += int((~g_ignore).sum())

        d_sel = np.asarray(det["labels"]).reshape(-1) == cls
        d_geom, d_area = _geometry(det, d_sel, iou_type)
        d_scores = np.asarray(det["scores"], np.float32)[d_sel]
        order_d = np.argsort(-d_scores, kind="stable")[:max_dets]
        d_geom, d_area, d_scores = d_geom[order_d], d_area[order_d], d_scores[order_d]
        if len(d_geom) and len(g_geom):
            ious = iou_fn(d_geom, g_geom, g_crowd)
        else:
            ious = np.zeros((len(d_geom), len(g_geom)))
        tp, dt_ig = _evaluate_image(ious, g_ignore, g_crowd, (d_area < lo) | (d_area > hi),
                                    iou_thresholds)
        scores_acc.append(d_scores)
        tp_acc.append(tp)
        ig_acc.append(dt_ig)
    if n_gt == 0:
        return None
    scores = np.concatenate(scores_acc) if scores_acc else np.zeros(0)
    tps = np.concatenate(tp_acc, axis=1) if tp_acc else np.zeros((nt, 0), bool)
    igs = np.concatenate(ig_acc, axis=1) if ig_acc else np.zeros((nt, 0), bool)
    order = np.argsort(-scores, kind="mergesort")
    tps, igs = tps[:, order], igs[:, order]
    ap, ar = np.zeros(nt), np.zeros(nt)
    for ti in range(nt):
        t = tps[ti][~igs[ti]]
        tp_cum, fp_cum = np.cumsum(t), np.cumsum(~t)
        recall = tp_cum / n_gt
        precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
        ar[ti] = recall[-1] if len(recall) else 0.0
        if len(precision) == 0:
            continue
        for i in range(len(precision) - 2, -1, -1):
            precision[i] = max(precision[i], precision[i + 1])
        idx = np.searchsorted(recall, RECALL_POINTS, side="left")
        ap[ti] = np.where(idx < len(precision),
                          precision[np.minimum(idx, len(precision) - 1)], 0.0).mean()
    return ap, ar


def compute_coco_map(detections: List[Dict], ground_truths: List[Dict],
                     iou_thresholds: np.ndarray = IOU_THRESHOLDS, iou_type: str = "bbox",
                     max_dets: int = MAX_DETS,
                     area_ranges: Optional[Sequence[str]] = ("all", "small", "medium",
                                                             "large")) -> Dict[str, float]:
    """detections: per image {"boxes" (N, 4) corner-form pixels, "scores" (N,),
    "labels" (N,), and for ``segm`` "masks" (N masks of the image's size)};
    ground_truths: per image {"boxes", "labels", optional "iscrowd", and for
    ``segm`` "masks"}. {"<type>": mAP@[.5:.95], "<type>_50", "<type>_75",
    "<type>_small/medium/large", "<type>_ar_<max_dets>"}, each in [0, 1]."""
    if iou_type not in IOU_TYPES:
        raise ValueError(f"iou_type {iou_type!r}: want one of {IOU_TYPES}")
    if iou_type == "segm" and not all("masks" in e for e in detections + ground_truths):
        raise ValueError("the segm mAP needs masks in every detection and ground truth")
    assert len(detections) == len(ground_truths)
    key = iou_type
    classes = sorted({int(lab) for gt in ground_truths for lab in gt["labels"]})
    if not classes:
        return {key: 0.0, f"{key}_50": 0.0, f"{key}_75": 0.0}
    results: Dict[str, float] = {}
    nt = len(iou_thresholds)
    for rng_name in (area_ranges or ("all",)):
        lo, hi = AREA_RANGES[rng_name]
        ap = np.full((nt, len(classes)), np.nan)
        ar = np.full((nt, len(classes)), np.nan)
        for ci, cls in enumerate(classes):
            res = _class_ap(detections, ground_truths, cls, lo, hi, iou_thresholds, max_dets,
                            iou_type)
            if res is not None:
                ap[:, ci], ar[:, ci] = res
        valid = ~np.isnan(ap[0])
        suffix = "" if rng_name == "all" else f"_{rng_name}"
        any_valid = valid.any()
        results[f"{key}{suffix}"] = float(np.nanmean(ap[:, valid])) if any_valid else 0.0
        if rng_name == "all":
            results[f"{key}_50"] = float(np.nanmean(ap[0, valid])) if any_valid else 0.0
            results[f"{key}_75"] = float(np.nanmean(ap[5, valid])) if any_valid else 0.0
            results[f"{key}_ar_{max_dets}"] = (float(np.nanmean(ar[:, valid])) if any_valid
                                               else 0.0)
    return results


@METRICS_REGISTRY.register(name="coco_map")
class COCOMapMetric(BaseMetric):
    """Per-image detections and ground truth gathered on the host; ``compute``
    gives the mAPs in percent."""

    def __init__(self, opts=None, **kwargs) -> None:
        self.iou_types = (getattr(opts, "stats.coco_map.iou_types", ["bbox"]) if opts
                          else ["bbox"]) or ["bbox"]
        unknown = [t for t in self.iou_types if t not in IOU_TYPES]
        if unknown:
            raise ValueError(f"--stats.coco-map.iou-types {unknown}: want {IOU_TYPES}")
        super().__init__(opts, **kwargs)

    def reset(self) -> None:
        self._dets: List[Dict] = []
        self._gts: List[Dict] = []

    def batch_values(self, prediction, target, extras=None):
        raise NotImplementedError(
            "coco_map is scored over a whole set on the host: run the offline detection "
            "evaluation (main_eval.main_worker_detection), not stats.train / stats.val")

    def update(self, prediction, target) -> None:
        """One image's detections and ground truth (dicts of numpy arrays), or lists."""
        if isinstance(prediction, dict):
            prediction, target = [prediction], [target]
        self._dets.extend(prediction)
        self._gts.extend(target)

    def compute(self) -> Dict[str, float]:
        if not self._dets:
            return {t: 0.0 for t in self.iou_types}
        out = {}
        for iou_type in self.iou_types:
            res = compute_coco_map(self._dets, self._gts, iou_type=iou_type)
            out.update({k: v * 100.0 for k, v in res.items()})
        return out
