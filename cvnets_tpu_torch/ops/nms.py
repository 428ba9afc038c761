"""Padded non-maximum suppression with static shapes (counterpart of
cvnets_tpu/ops/nms.py): a fixed number of candidates in, a fixed
``max_output`` of kept (index, score) slots out, empty slots index -1 and
score -inf. Plain torch (the card machine has no torchvision), batched over a
leading image axis. The candidates' pairwise IoU is built once; then
``max_output`` greedy steps, each an argmax, a gather of the best box's
score and of its suppression row, and a masked fill on every image at once
(four launches a step). Nothing is read back to the host and no shape
depends on the data, so it runs inside a CUDA stream without a sync. ``batched_nms`` is class-aware by
torchvision's coordinate-offset trick: each class's boxes are shifted to a
range of their own, so one pass never suppresses across classes."""

from __future__ import annotations

from typing import Tuple

import torch

from cvnets_tpu_torch.ops.box_utils import box_iou


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float = 0.5,
        max_output: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS of corner-form ``boxes`` (..., N, 4) by ``scores`` (..., N):
    (keep indices (..., max_output) int64, their scores). A score of -inf is
    no candidate; ties go to the lowest index, as ``jnp.argmax``."""
    lead, n = scores.shape[:-1], scores.shape[-1]
    boxes = boxes.reshape(-1, n, 4)
    active = scores.reshape(-1, n)
    # row i: the candidates box i suppresses, itself included (a box of no
    # area has an IoU of 0 with itself)
    over = box_iou(boxes, boxes) > iou_threshold
    over |= torch.eye(n, dtype=torch.bool, device=over.device)
    neg_inf = active.new_full((), float("-inf"))  # a fill on the device, no host copy
    idxs, kept = [], []
    for _ in range(max_output):
        best = active.argmax(dim=-1, keepdim=True)  # (B, 1)
        kept.append(active.gather(1, best))
        idxs.append(best)
        active = torch.where(over.gather(1, best[..., None].expand(-1, 1, n))[:, 0],
                             neg_inf, active)
    kept = torch.cat(kept, -1)
    idxs = torch.where(kept > neg_inf, torch.cat(idxs, -1), -1)
    return idxs.reshape(*lead, max_output), kept.reshape(*lead, max_output)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, class_ids: torch.Tensor,
                iou_threshold: float = 0.5, max_output: int = 100
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-aware ``nms``: each image's boxes shifted by class id × (its
    largest coordinate + 1)."""
    max_coord = boxes.flatten(-2).amax(dim=-1)[..., None, None] + 1.0
    shifted = boxes + class_ids.to(boxes.dtype)[..., None] * max_coord
    return nms(shifted, scores, iou_threshold=iou_threshold, max_output=max_output)
