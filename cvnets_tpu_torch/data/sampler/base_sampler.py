"""Base sampler (counterpart of cvnets_tpu/data/sampler/base_sampler.py).

Samplers yield whole batches of ``(crop_h, crop_w, sample_index)`` tuples. The
epoch's shuffle is drawn from ``random.Random(seed + epoch)``, so the port's lists
are the JAX package's. The port runs one process a card: ``rank`` and
``num_replicas`` default to 0 and 1, and a batch size is the configured one (the
JAX sampler multiplies it by the local device count, the devices one process
feeds there).
"""

from __future__ import annotations

import argparse
import random
from typing import Iterator, List, Optional, Tuple


class BaseSampler:
    def __init__(self, opts, n_data_samples: int, is_training: bool = True,
                 rank: Optional[int] = None, num_replicas: Optional[int] = None) -> None:
        self.opts = opts
        self.n_data_samples = n_data_samples
        self.is_training = is_training
        self.shuffle = bool(is_training)
        self.epoch = 0
        self.num_replicas = 1 if num_replicas is None else num_replicas
        self.rank = 0 if rank is None else rank

        num_repeats = getattr(opts, "sampler.num_repeats", 1) if is_training else 1
        self.num_repeats = max(1, num_repeats or 1)
        self.trunc_rep_aug = getattr(opts, "sampler.truncated_repeat_aug_sampler", False)
        self.use_shards = getattr(opts, "sampler.use_shards", False)
        self.seed = getattr(opts, "common.seed", 0) or 0

        n_total = n_data_samples if self.trunc_rep_aug else n_data_samples * self.num_repeats
        # padded so that every replica gets as many samples
        self.n_samples_per_replica = -(-n_total // self.num_replicas)
        self.total_size = self.n_samples_per_replica * self.num_replicas

    @staticmethod
    def _pad_cyclic(batch: list, indices: list, bsz: int) -> list:
        """Pad a trailing batch to exactly ``bsz`` by cycling ``indices``: every
        batch of an epoch has one shape."""
        if len(batch) >= bsz:
            return batch[:bsz]
        reps = -(-(bsz - len(batch)) // max(1, len(indices)))
        return (batch + indices * reps)[:bsz]

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        return parser

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def update_scales(self, epoch: int, is_master_node: bool = False) -> None:
        """Hook for the multi-scale samplers."""

    def get_indices(self) -> List[int]:
        """The epoch's shuffled, repeated and padded index list."""
        img_indices = list(range(self.n_data_samples))
        rng = random.Random(self.seed + self.epoch)
        if self.shuffle:
            rng.shuffle(img_indices)
        if self.num_repeats > 1:
            img_indices = [i for i in img_indices for _ in range(self.num_repeats)]
            if self.trunc_rep_aug:
                img_indices = img_indices[: self.n_data_samples]
        if len(img_indices) < self.total_size:
            img_indices += img_indices[: self.total_size - len(img_indices)]
        return img_indices

    def get_indices_rank_i(self) -> List[int]:
        """This replica's share: a contiguous block under ``use_shards``, every
        ``num_replicas``-th index otherwise."""
        indices = self.get_indices()
        if self.use_shards:
            start = self.rank * self.n_samples_per_replica
            return indices[start: start + self.n_samples_per_replica]
        return indices[self.rank:: self.num_replicas]

    def __iter__(self) -> Iterator[List[Tuple[int, int, int]]]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def extra_repr(self) -> str:
        return (f"num_repeats={self.num_repeats}, rank={self.rank},"
                f" num_replicas={self.num_replicas}")

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.extra_repr()})"
