"""Fixed-resolution batch sampler (counterpart of
cvnets_tpu/data/sampler/batch_sampler.py)."""

from __future__ import annotations

import argparse
from typing import Iterator, List, Tuple

from cvnets_tpu_torch.constants import DEFAULT_IMAGE_HEIGHT, DEFAULT_IMAGE_WIDTH
from cvnets_tpu_torch.data.sampler import SAMPLER_REGISTRY
from cvnets_tpu_torch.data.sampler.base_sampler import BaseSampler


@SAMPLER_REGISTRY.register(name="batch_sampler")
class BatchSampler(BaseSampler):
    def __init__(self, opts, n_data_samples: int, is_training: bool = True,
                 **kwargs) -> None:
        super().__init__(opts, n_data_samples, is_training, **kwargs)
        self.crop_size_h = getattr(opts, "sampler.bs.crop_size_height", DEFAULT_IMAGE_HEIGHT)
        self.crop_size_w = getattr(opts, "sampler.bs.crop_size_width", DEFAULT_IMAGE_WIDTH)
        self.batch_size = getattr(
            opts, "dataset.train_batch_size0" if is_training else "dataset.val_batch_size0", 32)

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != BatchSampler:
            return parser
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--sampler.bs.crop-size-width", type=int, default=DEFAULT_IMAGE_WIDTH)
        group.add_argument("--sampler.bs.crop-size-height", type=int,
                           default=DEFAULT_IMAGE_HEIGHT)
        return parser

    def __iter__(self) -> Iterator[List[Tuple[int, int, int]]]:
        indices, n_valid = self.get_indices_rank_i(), self.n_valid_rank_i()
        bsz = max(1, int(self.batch_size))
        for start in range(0, len(indices), bsz):
            batch = self._pad_cyclic(indices[start: start + bsz], indices, bsz)
            yield self.batch_of([(self.crop_size_h, self.crop_size_w, idx) for idx in batch],
                                start, n_valid)

    def __len__(self) -> int:
        return -(-len(self.get_indices_rank_i()) // max(1, int(self.batch_size)))

    def extra_repr(self) -> str:
        return (super().extra_repr() + f", batch_size={self.batch_size},"
                f" crop=({self.crop_size_h}x{self.crop_size_w})")
