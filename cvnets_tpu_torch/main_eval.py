"""Evaluation entry points of the port (counterpart of main_eval.py):

    python -m cvnets_tpu_torch.main_eval --common.config-file <yaml> \
        --model.classification.pretrained <checkpoint.pt>

the ``stats.val`` metrics of the model over the test loader (the dataset's
``root_test``, else ``root_val``, at ``--dataset.eval-batch-size0``), or
CLIP's zero-shot top-1 / top-5 when the test dataset has class captions
(``imagenet_zero_shot``), its weights from ``--model.<category>.pretrained``
(``classification``, ``multi_modal_image_text``) or ``--common.resume``, on
``device``, the CUDA card unless the caller asks for the CPU; and
``main_worker_segmentation`` and ``main_worker_detection``, the offline
segmentation and detection evaluations (``engine/eval_segmentation.py`` and
``engine/eval_detection.py``, which are their command lines).
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Union

import torch

from cvnets_tpu_torch.data.data_loaders import create_test_loader
from cvnets_tpu_torch.engine import Evaluator
from cvnets_tpu_torch.main_train import device_setup
from cvnets_tpu_torch.models import get_model
from cvnets_tpu_torch.options.opts import get_eval_arguments
from cvnets_tpu_torch.utils.checkpoint_utils import load_model_weights


def main(opts, device: Union[str, torch.device, None] = None, **kwargs) -> Dict[str, float]:
    device = device_setup(opts, device)
    test_loader = create_test_loader(opts, pin_memory=device.type == "cuda")
    model = get_model(opts, device=device)
    category = getattr(opts, "dataset.category", "classification")
    weights = (getattr(opts, f"model.{category}.pretrained", None)
               or getattr(opts, "common.resume", None))
    if weights:
        model.load_state_dict(load_model_weights(weights))
    return Evaluator(opts, model, test_loader, device=device).run()


def main_worker(args: Optional[List[str]] = None,
                device: Union[str, torch.device, None] = None, **kwargs) -> Dict[str, float]:
    return main(get_eval_arguments(args=args), device=device, **kwargs)


def main_worker_segmentation(args: Optional[List[str]] = None,
                             device: Union[str, torch.device, None] = None, **kwargs):
    """The offline segmentation evaluation: an mIoU, or the directory of the
    saved predictions."""
    from cvnets_tpu_torch.engine.eval_segmentation import main_segmentation_evaluation

    return main_segmentation_evaluation(get_eval_arguments(args=args), device=device)


def main_worker_detection(args: Optional[List[str]] = None,
                          device: Union[str, torch.device, None] = None, **kwargs):
    """The offline detection evaluation: the COCO mAPs, or the directory of
    the drawn images."""
    from cvnets_tpu_torch.engine.eval_detection import main_detection_evaluation

    return main_detection_evaluation(get_eval_arguments(args=args), device=device)


if __name__ == "__main__":
    main_worker(sys.argv[1:])
