"""Offline segmentation evaluation (counterpart of
cvnets_tpu/engine/eval_segmentation.py):

    python -m cvnets_tpu_torch.engine.eval_segmentation --common.config-file <yaml> \
        --model.segmentation.pretrained <checkpoint.pt> \
        [--evaluation.segmentation.mode validation_set|single_image|image_folder]

(``main_eval.main_worker_segmentation`` from Python), under
``--evaluation.segmentation.mode``:

* ``validation_set``: the mIoU of the model over the test loader, from a
  confusion matrix summed on the device and read back once at the end;
* ``single_image`` / ``image_folder``: the predicted labels of one image or of
  every image of a folder (resized to the eval size, bilinear), saved under
  ``<results_loc>/predictions`` as a palette PNG in the PASCAL colours
  (``<name>_mask.png``: under ``apply-color-map``, or when no output is
  chosen), the raw labels (``<name>_labels.png``, ``save-masks``) and the image
  blended with the colours (``<name>_overlay.jpg``, ``save-overlay-rgb-pred``).

The weights come from ``--model.segmentation.pretrained`` or ``--common.resume``.
The forward runs in eval mode under the options' autocast, as a validation
epoch does. Files are read and written through Pillow (imported where they are).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from cvnets_tpu_torch.engine.train_state import UnitNormalizer
from cvnets_tpu_torch.layers.dtype_utils import autocast
from cvnets_tpu_torch.metrics.intersection_over_union import (
    confusion_matrix,
    intersection_union,
    mean_iou,
)
from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.color_map import Colormap

IGNORE_INDEX = 255
IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp")


def _predict(opts, model: nn.Module, samples: torch.Tensor,
             to_unit: Optional[UnitNormalizer] = None) -> torch.Tensor:
    """(B, H, W) labels of an eval forward of uint8 samples, taken to the
    model's input as the train and eval steps take them (``UnitNormalizer``:
    [0, 1], and the options' mean/std normalization), or of float samples."""
    x = (to_unit or UnitNormalizer(opts))(samples)
    with torch.no_grad(), autocast(opts, x.device):
        logits = model.eval()(x)
    if isinstance(logits, dict):
        logits = logits["segmentation_output"]
    return logits.argmax(dim=1)


def predict_and_save(opts, model: nn.Module, image: torch.Tensor,
                     out_dir: Optional[str] = None, fname: str = "pred") -> np.ndarray:
    """The (H, W) uint8 labels of one uint8 (3, H, W) image, saved under
    ``out_dir`` as the flags ask."""
    device = next(model.parameters()).device
    mask = _predict(opts, model, image.to(device).unsqueeze(0))[0].to(torch.uint8).cpu().numpy()
    if out_dir:
        from PIL import Image

        os.makedirs(out_dir, exist_ok=True)
        colored = Image.frombytes("P", (mask.shape[1], mask.shape[0]), mask.tobytes())
        colored.putpalette(Colormap().get_color_map_list())
        save_masks = getattr(opts, "evaluation.segmentation.save_masks", False)
        overlay = getattr(opts, "evaluation.segmentation.save_overlay_rgb_pred", False)
        if getattr(opts, "evaluation.segmentation.apply_color_map", False) or not (
                save_masks or overlay):
            colored.save(os.path.join(out_dir, f"{fname}_mask.png"))
        if save_masks:
            Image.fromarray(mask).save(os.path.join(out_dir, f"{fname}_labels.png"))
        if overlay:
            w = getattr(opts, "evaluation.segmentation.overlay_mask_weight", 0.5)
            rgb = image.permute(1, 2, 0).numpy()
            blend = rgb * (1 - w) + np.asarray(colored.convert("RGB")) * w
            Image.fromarray(blend.astype(np.uint8)).save(
                os.path.join(out_dir, f"{fname}_overlay.jpg"))
    return mask


def predict_labeled_dataset(opts, model: nn.Module, loader,
                            device: Union[str, torch.device]) -> float:
    """The confusion-matrix mIoU of ``model`` over ``loader``'s batches."""
    n_classes = getattr(opts, "model.segmentation.n_classes", 21)
    conf, to_unit = None, UnitNormalizer(opts)
    for batch in loader:
        pred = _predict(opts, model, batch["samples"].to(device, non_blocking=True), to_unit)
        c = confusion_matrix(pred, batch["targets"].to(device, non_blocking=True),
                             n_classes, IGNORE_INDEX)
        conf = c if conf is None else conf + c
    if conf is None:
        return 0.0
    inter, union = torch.stack(intersection_union(conf)).cpu().numpy()
    miou = mean_iou(inter, union)
    logger.info(f"mIoU: {miou:.2f}")
    return miou


def eval_size(opts) -> Tuple[int, int]:
    """(H, W) of the single-image and folder modes: the fixed size of
    ``resize-input-images-fixed-size``, else the sampler's crop size."""
    fixed = getattr(opts, "evaluation.segmentation.resize_input_images_fixed_size", None)
    if fixed:  # one entry: a square
        return int(fixed[0]), int(fixed[-1])
    return (getattr(opts, "sampler.bs.crop_size_height", 512) or 512,
            getattr(opts, "sampler.bs.crop_size_width", 512) or 512)


def load_image(path: str, size_hw: Tuple[int, int]) -> torch.Tensor:
    """A file as uint8 (3, H, W), resized by Pillow's bilinear filter."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB").resize((size_hw[1], size_hw[0]), Image.BILINEAR)
        return torch.from_numpy(np.array(img)).permute(2, 0, 1).contiguous()


def image_paths(opts, mode: str):
    path = getattr(opts, "evaluation.segmentation.path", None)
    if path is None:
        logger.error(f"--evaluation.segmentation.path is required in the {mode} mode")
    if mode == "single_image":
        return [path]
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.lower().endswith(IMAGE_EXTENSIONS))


def main_segmentation_evaluation(opts, device: Union[str, torch.device, None] = None):
    """The mode's result: the mIoU, or the directory of the saved predictions."""
    from cvnets_tpu_torch.data.data_loaders import create_test_loader
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.utils.checkpoint_utils import load_model_weights
    from cvnets_tpu_torch.utils.common_utils import device_setup

    device = device_setup(opts, device)
    mode = getattr(opts, "evaluation.segmentation.mode", "validation_set")
    if mode not in ("validation_set", "single_image", "image_folder"):
        raise NotImplementedError(f"--evaluation.segmentation.mode {mode}")
    # the test loader first: its dataset sets the number of classes
    loader = (create_test_loader(opts, pin_memory=device.type == "cuda")
              if mode == "validation_set" else None)
    model = get_model(opts, device=device)
    weights = (getattr(opts, "model.segmentation.pretrained", None)
               or getattr(opts, "common.resume", None))
    if weights:
        model.load_state_dict(load_model_weights(weights))
    if loader is not None:
        return predict_labeled_dataset(opts, model, loader, device)
    res_dir = os.path.join(getattr(opts, "common.results_loc", "results"), "predictions")
    paths, size = image_paths(opts, mode), eval_size(opts)
    for path in paths:
        predict_and_save(opts, model, load_image(path, size), out_dir=res_dir,
                         fname=os.path.splitext(os.path.basename(path))[0])
    logger.info(f"Saved {len(paths)} prediction(s) under {res_dir}")
    return res_dir


if __name__ == "__main__":
    import sys

    from cvnets_tpu_torch.options.opts import get_eval_arguments

    main_segmentation_evaluation(get_eval_arguments(args=sys.argv[1:]))
