"""Kinetics-style video classification (counterpart of
cvnets_tpu/data/datasets/video_classification/kinetics.py).

``root/<class>/<video>``: a video is a folder of frames or a container file,
read by ``--video-reader.name``. An item is ``{"samples": (n_clips, T, C, H,
W) uint8, "targets": class, "sample_id": index}``: each frame resized by
Pillow to the batch's crop, as the JAX dataset does, and no
``--video-augmentation.*`` applied (the JAX dataset applies none either). A
video with no frames reads as zeros with target -1, which the collate
replaces by a valid item. The reader's draws (each training clip's start,
the frames' erasing) come from the loader's ``random.Random``
(``draw_params``), its reads in the worker (``get_item``).
``default_video_collate_fn`` stacks the items into (B, n_clips, T, C, H, W);
the train step trains each clip as a sample and the evaluation votes over a
video's clips.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Tuple

import numpy as np
import torch

from cvnets_tpu_torch.data.collate import COLLATE_FN_REGISTRY
from cvnets_tpu_torch.data.collate.collate_functions import default_collate_fn
from cvnets_tpu_torch.data.datasets import DATASET_REGISTRY
from cvnets_tpu_torch.data.datasets.dataset_base import BaseDataset
from cvnets_tpu_torch.data.video_reader import get_video_reader

DEFAULT_CROP = 224


@DATASET_REGISTRY.register(name="kinetics", type="video_classification")
class KineticsDataset(BaseDataset):
    def __init__(self, opts, is_training: bool = True, is_evaluation: bool = False,
                 *args, **kwargs) -> None:
        super().__init__(opts, is_training=is_training, is_evaluation=is_evaluation,
                         *args, **kwargs)
        self.video_reader = get_video_reader(opts, is_training=is_training)
        self.samples: List[Tuple[str, int]] = []
        self.class_to_idx: Dict[str, int] = {}
        root = self.root
        if root and os.path.isdir(root):
            classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
            self.class_to_idx = {c: i for i, c in enumerate(classes)}
            for cls in classes:
                cdir = os.path.join(root, cls)
                for entry in sorted(os.listdir(cdir)):
                    self.samples.append((os.path.join(cdir, entry), self.class_to_idx[cls]))
        self._rng = random.Random(getattr(opts, "common.seed", 0) or 0)

    def share_dataset_arguments(self) -> Dict:
        if self.class_to_idx:
            return {"model.classification.n_classes": len(self.class_to_idx)}
        return {}

    def __len__(self) -> int:
        return len(self.samples)

    def draw_params(self, sample_size_and_index, rng: random.Random):
        _, _, idx = self._parse_batch_tuple(sample_size_and_index)
        return self.video_reader.draw(self.samples[idx][0], rng)

    def get_item(self, sample_size_and_index, params) -> Dict:
        from PIL import Image

        crop_h, crop_w, idx = self._parse_batch_tuple(sample_size_and_index)
        if crop_h <= 0:
            crop_h = crop_w = DEFAULT_CROP
        path, target = self.samples[idx]
        blob = None if params is None else self.video_reader.read_video(path, params)
        reader = self.video_reader
        if blob is None:
            video = np.zeros((reader.clips_per_video, reader.frames_per_clip, crop_h, crop_w,
                              3), np.uint8)
            target = -1
        else:
            video = np.stack([np.stack([np.asarray(Image.fromarray(f).resize((crop_w, crop_h)),
                                                   np.uint8) for f in clip])
                              for clip in blob["video"]])
        samples = torch.from_numpy(np.ascontiguousarray(video)).permute(0, 1, 4, 2, 3)
        return {"samples": samples, "targets": int(target), "sample_id": idx}

    def __getitem__(self, sample_size_and_index) -> Dict:
        return self.get_item(sample_size_and_index,
                             self.draw_params(sample_size_and_index, self._rng))


@COLLATE_FN_REGISTRY.register(name="default_video_collate_fn")
def default_video_collate_fn(batch: List[Dict], opts=None) -> Dict:
    """(B, n_clips, T, C, H, W) samples."""
    return default_collate_fn(batch, opts)
