"""Offline detection evaluation (counterpart of cvnets_tpu/engine/eval_detection.py):

    python -m cvnets_tpu_torch.engine.eval_detection --common.config-file <yaml> \
        --model.detection.pretrained <checkpoint.pt> \
        [--evaluation.detection.mode validation_set|single_image|image_folder]

(``main_eval.main_worker_detection`` from Python), under
``--evaluation.detection.mode``:

* ``validation_set``: the COCO box mAP (``metrics/coco_map.compute_coco_map``,
  fractions in [0, 1]) of the model over the test loader, each image at its
  own size unless ``--evaluation.detection.resize-input-images`` (so use an
  eval batch of 1 then, as in the JAX package); boxes are scaled to the
  image's annotated size and scored against its annotations;
* ``single_image`` / ``image_folder``: the boxes drawn on each image (resized
  to the eval size), saved under ``<results_loc>/detections`` as
  ``<name>_boxes.png``.

The forward runs in eval mode under the options' autocast, and decode and
NMS (``SingleShotMaskDetector.postprocess``) run on the model's device for a
whole batch; the predictions are read back once, after the last batch. The
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


def predict(opts, model: nn.Module, samples: torch.Tensor,
            to_unit: UnitNormalizer = None) -> DetectionPredTuple:
    """Labels, scores and [0, 1] boxes of a batch of uint8 (or float) samples."""
    x = (to_unit or UnitNormalizer(opts))(samples)
    with torch.no_grad(), autocast(opts, x.device):
        prediction = model.eval()(x)
    return model.postprocess(prediction)


def predict_labeled_dataset(opts, model: nn.Module, loader,
                            device: Union[str, torch.device]) -> Dict[str, float]:
    """The COCO mAPs of ``model`` over ``loader``'s images."""
    to_unit, outputs = UnitNormalizer(opts), []
    for batch in loader:
        out = predict(opts, model, batch["samples"].to(device, non_blocking=True), to_unit)
        outputs.append((batch["targets"]["image_id"], out))
    dataset = loader.dataset
    detections: List[Dict] = []
    ground_truths: List[Dict] = []
    for image_ids, out in outputs:
        labels, scores, boxes = (t.cpu().numpy() for t in (out.labels, out.scores, out.boxes))
        for i, img_id in enumerate(image_ids.tolist()):
            info = dataset.coco.load_image_info(img_id)
            iw, ih = info.get("width", 1), info.get("height", 1)
            keep = scores[i] > 0
            detections.append({"boxes": boxes[i][keep] * np.array([iw, ih, iw, ih], np.float32),
                               "scores": scores[i][keep], "labels": labels[i][keep]})
            gt_boxes, gt_labels = dataset.get_boxes_and_labels(img_id, iw, ih)
            ground_truths.append({"boxes": gt_boxes, "labels": gt_labels})
    res = compute_coco_map(detections, ground_truths)
    logger.info(f"COCO mAP: {res}")
    return res


def render_detections(image: np.ndarray, out: DetectionPredTuple,
                      score_threshold: float = 0.3) -> np.ndarray:
    """Boxes with ``label:score`` captions drawn on an HWC uint8 image (Pillow)."""
    from PIL import Image, ImageDraw

    pil = Image.fromarray(image)
    draw = ImageDraw.Draw(pil)
    cmap = Colormap().get_color_map()
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
    from cvnets_tpu_torch.main_train import device_setup
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.utils.checkpoint_utils import load_model_weights

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
        boxes = out.boxes * np.array([size[1], size[0], size[1], size[0]], np.float32)
        rgb = render_detections(img.permute(1, 2, 0).numpy(), out._replace(boxes=boxes))
        name = os.path.splitext(os.path.basename(p))[0]
        Image.fromarray(rgb).save(os.path.join(res_dir, f"{name}_boxes.png"))
    logger.info(f"Saved {len(paths)} detection rendering(s) under {res_dir}")
    return res_dir


if __name__ == "__main__":
    import sys

    from cvnets_tpu_torch.options.opts import get_eval_arguments

    main_detection_evaluation(get_eval_arguments(args=sys.argv[1:]))
