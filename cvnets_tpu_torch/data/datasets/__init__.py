"""Dataset registry (counterpart of cvnets_tpu/data/datasets/__init__.py)."""

from __future__ import annotations

import argparse

from cvnets_tpu_torch.data.datasets.dataset_base import BaseDataset
from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.registry import Registry

DATASET_REGISTRY = Registry(registry_name="torch_dataset", base_class=BaseDataset)


def arguments_dataset(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    parser = BaseDataset.add_arguments(parser)
    return DATASET_REGISTRY.all_arguments(parser)


def build_dataset_from_registry(opts, is_training: bool = True, is_evaluation: bool = False,
                                *args, **kwargs):
    """The dataset ``dataset.name`` of ``dataset.category``. A name neither
    package registers (``pascal_voc``, which
    config/segmentation/pascal_voc/deeplabv3_mobilevit.yaml sets) fails as in
    the JAX package, with the names registered for the category."""
    name, category = getattr(opts, "dataset.name"), getattr(opts, "dataset.category")
    if (name, category) not in DATASET_REGISTRY:
        registered = sorted(k.split(":", 1)[1] for k in DATASET_REGISTRY.keys()
                            if k.startswith(f"{category}:") and not k.endswith(":__base__"))
        logger.error(f"dataset.name {name!r} is not a registered {category} dataset; set "
                     f"dataset.name in the yaml to one of {registered}")
    return DATASET_REGISTRY[name, category](
        opts, is_training=is_training, is_evaluation=is_evaluation, *args, **kwargs)


def get_train_val_datasets(opts):
    """(train, val or None). Under ``--dataset.multi-modal-img-text.zero-shot-eval``
    an image-text run validates on the zero-shot set (``zero-shot.name``,
    default ``imagenet_zero_shot``, at ``zero-shot.root-val``), as the JAX
    package does (data/datasets/__init__.py:31-56)."""
    train_ds = build_dataset_from_registry(opts, is_training=True)
    if getattr(opts, "dataset.disable_val", False):
        return train_ds, None
    prefix = "dataset.multi_modal_img_text."
    if (getattr(opts, "dataset.category", None) == "multi_modal_image_text"
            and getattr(opts, prefix + "zero_shot_eval", False)):
        zs_opts = argparse.Namespace(**vars(opts))
        setattr(zs_opts, "dataset.name",
                getattr(opts, prefix + "zero_shot.name", None) or "imagenet_zero_shot")
        root = getattr(opts, prefix + "zero_shot.root_val", None)
        if root:
            setattr(zs_opts, "dataset.root_val", root)
        return train_ds, build_dataset_from_registry(zs_opts, is_training=False)
    return train_ds, build_dataset_from_registry(opts, is_training=False)


def get_test_dataset(opts):
    return build_dataset_from_registry(opts, is_training=False, is_evaluation=True)


# registers the ported datasets (after DATASET_REGISTRY exists)
from cvnets_tpu_torch.data.datasets.audio_classification import (  # noqa: E402,F401
    speech_commands_v2,
)
from cvnets_tpu_torch.data.datasets.classification import imagenet  # noqa: E402,F401
from cvnets_tpu_torch.data.datasets.detection import coco_mask_rcnn, coco_ssd  # noqa: E402,F401
from cvnets_tpu_torch.data.datasets.multi_modal_img_text import (  # noqa: E402,F401
    base_multi_modal_img_text,
)
from cvnets_tpu_torch.data.datasets.segmentation import ade20k  # noqa: E402,F401
from cvnets_tpu_torch.data.datasets.video_classification import kinetics  # noqa: E402,F401
