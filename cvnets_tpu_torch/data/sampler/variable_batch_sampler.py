"""Variable-batch and multi-scale samplers (counterpart of
cvnets_tpu/data/sampler/variable_batch_sampler.py): each batch draws a
(crop_h, crop_w, batch size) from the constant-pixel-budget schedule with
``random.Random(seed + epoch)``, the JAX sampler's draws; ``update_scales``
widens the crop range at the configured epochs."""

from __future__ import annotations

import argparse
import random
from typing import Iterator, List, Tuple

from cvnets_tpu_torch.constants import DEFAULT_IMAGE_HEIGHT, DEFAULT_IMAGE_WIDTH
from cvnets_tpu_torch.data.sampler import SAMPLER_REGISTRY
from cvnets_tpu_torch.data.sampler.base_sampler import BaseSampler
from cvnets_tpu_torch.data.sampler.utils import (
    create_intervallic_integer_list,
    image_batch_pairs,
)
from cvnets_tpu_torch.utils import logger


@SAMPLER_REGISTRY.register(name="variable_batch_sampler")
class VariableBatchSampler(BaseSampler):
    def __init__(self, opts, n_data_samples: int, is_training: bool = True,
                 **kwargs) -> None:
        super().__init__(opts, n_data_samples, is_training, **kwargs)
        self.crop_size_h = getattr(opts, "sampler.vbs.crop_size_height", DEFAULT_IMAGE_HEIGHT)
        self.crop_size_w = getattr(opts, "sampler.vbs.crop_size_width", DEFAULT_IMAGE_WIDTH)
        self.min_crop_size_h = getattr(opts, "sampler.vbs.min_crop_size_height", 160)
        self.max_crop_size_h = getattr(opts, "sampler.vbs.max_crop_size_height", 320)
        self.min_crop_size_w = getattr(opts, "sampler.vbs.min_crop_size_width", 160)
        self.max_crop_size_w = getattr(opts, "sampler.vbs.max_crop_size_width", 320)
        self.max_n_scales = getattr(opts, "sampler.vbs.max_n_scales", 5)
        self.check_scale = getattr(opts, "sampler.vbs.check_scale", 32)
        self.scale_inc = getattr(opts, "sampler.vbs.scale_inc", False)
        self.min_scale_inc_factor = getattr(opts, "sampler.vbs.min_scale_inc_factor", 1.0)
        self.max_scale_inc_factor = getattr(opts, "sampler.vbs.max_scale_inc_factor", 1.0)
        ep_intervals = getattr(opts, "sampler.vbs.ep_intervals", [40])
        self.scale_ep_intervals = [ep_intervals] if isinstance(ep_intervals, int) else ep_intervals
        if is_training:
            self.batch_size = getattr(opts, "dataset.train_batch_size0", 32)
            self.img_batch_tuples = self._schedule()
        else:
            self.batch_size = getattr(opts, "dataset.val_batch_size0", 32)
            self.img_batch_tuples = [(self.crop_size_h, self.crop_size_w, self.batch_size)]

    def _schedule(self) -> List[Tuple[int, int, int]]:
        return image_batch_pairs(
            crop_size_h=self.crop_size_h, crop_size_w=self.crop_size_w,
            batch_size_gpu0=self.batch_size, max_scales=self.max_n_scales,
            check_scale_div_factor=self.check_scale,
            min_crop_size_h=self.min_crop_size_h, max_crop_size_h=self.max_crop_size_h,
            min_crop_size_w=self.min_crop_size_w, max_crop_size_w=self.max_crop_size_w)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != VariableBatchSampler:
            return parser
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--sampler.vbs.crop-size-width", type=int, default=DEFAULT_IMAGE_WIDTH)
        group.add_argument("--sampler.vbs.crop-size-height", type=int,
                           default=DEFAULT_IMAGE_HEIGHT)
        group.add_argument("--sampler.vbs.min-crop-size-width", type=int, default=160)
        group.add_argument("--sampler.vbs.max-crop-size-width", type=int, default=320)
        group.add_argument("--sampler.vbs.min-crop-size-height", type=int, default=160)
        group.add_argument("--sampler.vbs.max-crop-size-height", type=int, default=320)
        group.add_argument("--sampler.vbs.max-n-scales", type=int, default=5)
        group.add_argument("--sampler.vbs.check-scale", type=int, default=32)
        group.add_argument("--sampler.vbs.ep-intervals", type=int, nargs="+", default=[40])
        group.add_argument("--sampler.vbs.min-scale-inc-factor", type=float, default=1.0)
        group.add_argument("--sampler.vbs.max-scale-inc-factor", type=float, default=1.0)
        group.add_argument("--sampler.vbs.scale-inc", action="store_true", default=False)
        return parser

    def update_scales(self, epoch: int, is_master_node: bool = False) -> None:
        """Grow the crop-size range at the epochs of ``ep_intervals``."""
        if not (self.is_training and self.scale_inc) or epoch not in self.scale_ep_intervals:
            return
        self.min_crop_size_h += int(self.min_crop_size_h * self.min_scale_inc_factor)
        self.max_crop_size_h += int(self.max_crop_size_h * self.max_scale_inc_factor)
        self.min_crop_size_w += int(self.min_crop_size_w * self.min_scale_inc_factor)
        self.max_crop_size_w += int(self.max_crop_size_w * self.max_scale_inc_factor)
        self.img_batch_tuples = self._schedule()
        if is_master_node:
            logger.log(f"Scales updated in {self.__class__.__name__}")
            logger.log(f"New scales: {self.img_batch_tuples}")

    def __iter__(self) -> Iterator[List[Tuple[int, int, int]]]:
        indices, n_valid = self.get_indices_rank_i(), self.n_valid_rank_i()
        rng = random.Random(self.seed + self.epoch)
        start = 0
        while start < len(indices):
            crop_h, crop_w, bsz = rng.choice(self.img_batch_tuples)
            bsz = max(1, int(bsz))
            batch = self._pad_cyclic(indices[start: start + bsz], indices, bsz)
            yield self.batch_of([(crop_h, crop_w, idx) for idx in batch], start, n_valid)
            start += bsz

    def __len__(self) -> int:
        # an estimate, as in the JAX package: the batch sizes are drawn
        return max(1, len(self.get_indices_rank_i()) // max(self.batch_size, 1))

    def extra_repr(self) -> str:
        return (super().extra_repr() + f", base_batch_size={self.batch_size},"
                f" scales={self.img_batch_tuples}")


@SAMPLER_REGISTRY.register(name="multi_scale_sampler")
class MultiScaleSampler(VariableBatchSampler):
    """Multi-scale crops at a fixed batch size."""

    def __init__(self, opts, n_data_samples: int, is_training: bool = True,
                 **kwargs) -> None:
        super().__init__(opts, n_data_samples, is_training, **kwargs)
        self.crop_size_h = getattr(opts, "sampler.msc.crop_size_height", DEFAULT_IMAGE_HEIGHT)
        self.crop_size_w = getattr(opts, "sampler.msc.crop_size_width", DEFAULT_IMAGE_WIDTH)
        if is_training:
            check = getattr(opts, "sampler.msc.check_scale", 32)
            n_scales = getattr(opts, "sampler.msc.max_n_scales", 5)
            hs = create_intervallic_integer_list(
                self.crop_size_h, getattr(opts, "sampler.msc.min_crop_size_height", 160),
                getattr(opts, "sampler.msc.max_crop_size_height", 320), n_scales, check)
            ws = create_intervallic_integer_list(
                self.crop_size_w, getattr(opts, "sampler.msc.min_crop_size_width", 160),
                getattr(opts, "sampler.msc.max_crop_size_width", 320), n_scales, check)
            self.img_batch_tuples = [(h, w, self.batch_size) for h, w in zip(hs, ws)]
        else:
            self.img_batch_tuples = [(self.crop_size_h, self.crop_size_w, self.batch_size)]

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != MultiScaleSampler:
            return parser
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--sampler.msc.crop-size-width", type=int, default=DEFAULT_IMAGE_WIDTH)
        group.add_argument("--sampler.msc.crop-size-height", type=int,
                           default=DEFAULT_IMAGE_HEIGHT)
        group.add_argument("--sampler.msc.min-crop-size-width", type=int, default=160)
        group.add_argument("--sampler.msc.max-crop-size-width", type=int, default=320)
        group.add_argument("--sampler.msc.min-crop-size-height", type=int, default=160)
        group.add_argument("--sampler.msc.max-crop-size-height", type=int, default=320)
        group.add_argument("--sampler.msc.max-n-scales", type=int, default=5)
        group.add_argument("--sampler.msc.check-scale", type=int, default=32)
        return parser
