"""Offline detection evaluation (counterpart of cvnets_tpu/engine/eval_detection.py):

    python -m cvnets_tpu_torch.engine.eval_detection --common.config-file <yaml> \
        --model.detection.pretrained <checkpoint.pt> \
        [--evaluation.detection.mode validation_set|single_image|image_folder]

(``main_eval.main_worker_detection`` from Python), under
``--evaluation.detection.mode``:

* ``validation_set``: the COCO mAPs (``metrics/coco_map.compute_coco_map``,
  fractions in [0, 1]) of the model over the test loader, boxes always and
  instance masks (``segm``) where ``--stats.coco-map.iou-types`` names it
  and the model predicts masks (Mask R-CNN). SSD sees each image at its own
  size unless ``--evaluation.detection.resize-input-images`` (so use an eval
  batch of 1 then, as in the JAX package); Mask R-CNN sees the loader's crop
  size. Boxes are scaled to the image's annotated size (from [0, 1] for SSD,
  from the input's pixels for a model with ``BOXES_IN_PIXELS``) and scored
  against its annotations; a predicted mask (``> 0.5``) is resized to the
  annotated size as Pillow's ``NEAREST`` does, and scored against the
  annotation's polygons rasterized there (its box where it has none). The
  JAX evaluation passes the raw polygon lists as ground-truth masks, which
  its mask IoU cannot read;
* ``single_image`` / ``image_folder``: the boxes (and instance masks, blended
  half and half with the class color) drawn on each image (resized to the
  eval size), saved under ``<results_loc>/detections`` as
  ``<name>_boxes.png``.

The forward runs in eval mode under the options' autocast, and decode and
NMS (the model's ``postprocess``) run on the model's device for a whole
batch; the predictions are read back once, after the last batch, or, where
masks are scored, once a batch (a batch's pasted masks are large). The
weights come from ``--model.detection.pretrained`` or ``--common.resume``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Union

import numpy as np
import torch
import torch.nn as nn

from cvnets_tpu_torch.engine.eval_segmentation import eval_size, load_image
from cvnets_tpu_torch.engine.train_state import UnitNormalizer
from cvnets_tpu_torch.layers.dtype_utils import autocast
from cvnets_tpu_torch.metrics.coco_map import compute_coco_map
from cvnets_tpu_torch.models.detection import DetectionPredTuple
from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.color_map import Colormap

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def predict(opts, model: nn.Module, samples, to_unit: UnitNormalizer = None
            ) -> DetectionPredTuple:
    """Labels, scores, boxes (and masks) of a batch of uint8 (or float)
    images, or of samples ``{"image", ...}``."""
    if isinstance(samples, dict):
        samples = samples["image"]
    x = (to_unit or UnitNormalizer(opts))(samples)
    with torch.no_grad(), autocast(opts, x.device):
        prediction = model.eval()(x)
    return model.postprocess(prediction)


def _to_host(out: DetectionPredTuple, with_masks: bool) -> DetectionPredTuple:
    masks = out.masks > 0.5 if with_masks and out.masks is not None else None
    return DetectionPredTuple(*(t.cpu().numpy() for t in out[:3]),
                              masks=None if masks is None else masks.cpu())


def predict_labeled_dataset(opts, model: nn.Module, loader,
                            device: Union[str, torch.device]) -> Dict[str, float]:
    """The COCO mAPs of ``model`` over ``loader``'s images."""
    from cvnets_tpu_torch.data.datasets.detection.coco_mask_rcnn import instance_mask
    from cvnets_tpu_torch.data.transforms.image import InstanceGeometry, resize_mask

    iou_types = getattr(opts, "stats.coco_map.iou_types", ["bbox"]) or ["bbox"]
    want_segm = "segm" in iou_types and getattr(model, "use_mask", False)
    in_pixels = getattr(model, "BOXES_IN_PIXELS", False)
    to_unit, outputs = UnitNormalizer(opts), []
    for batch in loader:
        samples = batch["samples"]
        image = samples["image"] if isinstance(samples, dict) else samples
        out = predict(opts, model, image.to(device, non_blocking=True), to_unit)
        if want_segm:  # read back now: a batch's masks are (B, K, H, W)
            out = _to_host(out, True)
        outputs.append((batch["targets"]["image_id"], tuple(image.shape[-2:]), out))
    dataset = loader.dataset
    detections: List[Dict] = []
    ground_truths: List[Dict] = []
    for image_ids, (in_h, in_w), out in outputs:
        if not want_segm:
            out = _to_host(out, False)
        for i, img_id in enumerate(image_ids.tolist()):
            info = dataset.coco.load_image_info(img_id)
            iw, ih = info.get("width", 1), info.get("height", 1)
            keep = out.scores[i] > 0
            scale = (np.array([iw / in_w, ih / in_h] * 2, np.float32) if in_pixels
                     else np.array([iw, ih, iw, ih], np.float32))
            det = {"boxes": out.boxes[i][keep] * scale, "scores": out.scores[i][keep],
                   "labels": out.labels[i][keep]}
            if want_segm:
                det["masks"] = [resize_mask(m, (ih, iw)).numpy()
                                for m in out.masks[i][torch.from_numpy(keep)]]
                gt_boxes, gt_labels, segs = dataset.get_boxes_and_labels(
                    img_id, iw, ih, include_masks=True)
                gt = {"boxes": gt_boxes, "labels": gt_labels,
                      "masks": [instance_mask(seg, InstanceGeometry(), box, (ih, iw), (ih, iw))
                                for seg, box in zip(segs, gt_boxes)]}
            else:
                gt_boxes, gt_labels = dataset.get_boxes_and_labels(img_id, iw, ih)
                gt = {"boxes": gt_boxes, "labels": gt_labels}
            detections.append(det)
            ground_truths.append(gt)
    res = compute_coco_map(detections, ground_truths)
    if want_segm:
        res.update(compute_coco_map(detections, ground_truths, iou_type="segm"))
    logger.info(f"COCO mAP: {res}")
    return res


def render_detections(image: np.ndarray, out: DetectionPredTuple,
                      score_threshold: float = 0.3) -> np.ndarray:
    """Boxes with ``label:score`` captions drawn on an HWC uint8 image
    (Pillow), each kept detection's mask (``> 0.5``) first blended half and
    half with its class color."""
    from PIL import Image, ImageDraw

    cmap = Colormap().get_color_map()
    if out.masks is not None:
        image = image.copy()
        for mask, label, score in zip(out.masks, out.labels, out.scores):
            if score >= score_threshold:
                color = np.asarray(cmap[int(label) % len(cmap)], np.float32)
                m = np.asarray(mask) > 0.5
                image[m] = (0.5 * image[m] + 0.5 * color).astype(np.uint8)
    pil = Image.fromarray(image)
    draw = ImageDraw.Draw(pil)
    for box, label, score in zip(out.boxes, out.labels, out.scores):
        if score < score_threshold:
            continue
        color = tuple(int(c) for c in cmap[int(label) % len(cmap)])
        x1, y1, x2, y2 = (float(v) for v in box)
        draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
        draw.text((x1 + 2, max(0, y1 - 12)), f"{int(label)}:{score:.2f}", fill=color)
    return np.asarray(pil)


def main_detection_evaluation(opts, device: Union[str, torch.device, None] = None):
    """The mode's result: the mAPs, or the directory of the drawn images."""
    from cvnets_tpu_torch.data.data_loaders import create_test_loader
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.utils.checkpoint_utils import load_model_weights
    from cvnets_tpu_torch.utils.common_utils import device_setup

    device = device_setup(opts, device)
    mode = getattr(opts, "evaluation.detection.mode", "validation_set")
    if mode not in ("validation_set", "single_image", "image_folder"):
        raise NotImplementedError(f"--evaluation.detection.mode {mode}")
    # the test loader first: its dataset sets the number of classes
    loader = (create_test_loader(opts, pin_memory=device.type == "cuda")
              if mode == "validation_set" else None)
    model = get_model(opts, device=device)
    weights = (getattr(opts, "model.detection.pretrained", None)
               or getattr(opts, "common.resume", None))
    if weights:
        model.load_state_dict(load_model_weights(weights))
    if loader is not None:
        return predict_labeled_dataset(opts, model, loader, device)
    path = getattr(opts, "evaluation.detection.path", None)
    if path is None:
        logger.error(f"--evaluation.detection.path is required in the {mode} mode")
    paths = [path] if mode == "single_image" else sorted(
        os.path.join(path, f) for f in os.listdir(path) if f.lower().endswith(IMAGE_EXTENSIONS))
    res_dir = os.path.join(getattr(opts, "common.results_loc", "results"), "detections")
    os.makedirs(res_dir, exist_ok=True)
    size = eval_size(opts)
    for p in paths:
        from PIL import Image

        img = load_image(p, size)
        out = predict(opts, model, img.to(device).unsqueeze(0))
        out = DetectionPredTuple(*(None if t is None else t[0].cpu().numpy() for t in out))
        boxes = out.boxes if getattr(model, "BOXES_IN_PIXELS", False) else (
            out.boxes * np.array([size[1], size[0], size[1], size[0]], np.float32))
        rgb = render_detections(img.permute(1, 2, 0).numpy(), out._replace(boxes=boxes))
        name = os.path.splitext(os.path.basename(p))[0]
        Image.fromarray(rgb).save(os.path.join(res_dir, f"{name}_boxes.png"))
    logger.info(f"Saved {len(paths)} detection rendering(s) under {res_dir}")
    return res_dir


if __name__ == "__main__":
    import sys

    from cvnets_tpu_torch.options.opts import get_eval_arguments

    main_detection_evaluation(get_eval_arguments(args=sys.argv[1:]))
