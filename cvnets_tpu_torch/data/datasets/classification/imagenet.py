"""ImageNet dataset (counterpart of cvnets_tpu/data/datasets/classification/imagenet.py).
The distribution-shift sets (``imagenet_v2``, ``_a``, ``_r``, ``_sketch``) and
``places365`` are not ported yet (ROADMAP.md queue 1 item 13)."""

from cvnets_tpu_torch.data.datasets import DATASET_REGISTRY
from cvnets_tpu_torch.data.datasets.classification.base_image_classification_dataset import (
    BaseImageClassificationDataset,
)


@DATASET_REGISTRY.register(name="imagenet", type="classification")
class ImageNetDataset(BaseImageClassificationDataset):
    """ImageNet-1k in ImageFolder layout (train/<wnid>/*.JPEG)."""
