"""Base sampler (counterpart of cvnets_tpu/data/sampler/base_sampler.py).

Samplers yield whole batches of ``(crop_h, crop_w, sample_index)`` tuples. The
epoch's shuffle is drawn from ``random.Random(seed + epoch)``, so the port's lists
are the JAX package's, and every rank draws the same list and the same
(crop_h, crop_w, batch size) sequence: a step's batches have one size on every
rank. The port runs one process a card: ``rank`` and ``num_replicas`` come from
the process group when the caller gives none (0 and 1 without one), and a
batch size is the yaml's per-card one (the JAX sampler multiplies it by the
local device count, the devices one process feeds there). A rank takes every
``num_replicas``-th index of the list padded to ``total_size`` (under
``--sampler.use-shards`` a contiguous block), as the JAX sampler's process
does: the union of the ranks' i-th batches is the JAX sampler's i-th batch at
one replica and ``num_replicas`` times the batch wherever the list fills it.

Each batch is a ``SampledBatch``: a list whose ``n_valid`` counts its leading
rows that are samples of the list; the rest are the padding that evens out
the ranks and fills the trailing batch. Evaluation counts only the valid
rows, so each sample counts once whatever the number of ranks.

``update_indices`` (sample-efficient training) replaces the list the epoch
shuffles, on every rank alike.
"""

from __future__ import annotations

import argparse
import random
from typing import Iterator, List, Optional, Sequence, Tuple


class SampledBatch(list):
    """A batch of ``(crop_h, crop_w, index)`` tuples; ``n_valid`` leading rows
    are samples of the list, the rest padding."""

    n_valid: int

    def __init__(self, rows, n_valid: int) -> None:
        super().__init__(rows)
        self.n_valid = n_valid


class BaseSampler:
    def __init__(self, opts, n_data_samples: int, is_training: bool = True,
                 rank: Optional[int] = None, num_replicas: Optional[int] = None) -> None:
        from cvnets_tpu_torch import parallel

        self.opts = opts
        self.n_data_samples = n_data_samples
        self.is_training = is_training
        self.shuffle = bool(is_training)
        self.epoch = 0
        # the data axis: the ranks of a model group read the same rows
        self.num_replicas = parallel.data_size() if num_replicas is None else num_replicas
        self.rank = parallel.data_index() if rank is None else rank
        self.img_indices: Optional[List[int]] = None  # set by update_indices

        num_repeats = getattr(opts, "sampler.num_repeats", 1) if is_training else 1
        self.num_repeats = max(1, num_repeats or 1)
        self.trunc_rep_aug = getattr(opts, "sampler.truncated_repeat_aug_sampler", False)
        self.use_shards = getattr(opts, "sampler.use_shards", False)
        self.seed = getattr(opts, "common.seed", 0) or 0
        self._set_sizes(n_data_samples)

    def _set_sizes(self, n_samples: int) -> None:
        self.n_total = n_samples if self.trunc_rep_aug else n_samples * self.num_repeats
        # padded so that every replica gets as many samples
        self.n_samples_per_replica = -(-self.n_total // self.num_replicas)
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

    def update_indices(self, new_indices: Sequence[int]) -> None:
        """The samples later epochs shuffle (sample-efficient training)."""
        self.img_indices = list(new_indices)
        self._set_sizes(len(self.img_indices))

    def get_indices(self) -> List[int]:
        """The epoch's shuffled, repeated and padded index list."""
        img_indices = (list(self.img_indices) if self.img_indices is not None
                       else list(range(self.n_data_samples)))
        n_samples = len(img_indices)
        rng = random.Random(self.seed + self.epoch)
        if self.shuffle:
            rng.shuffle(img_indices)
        if self.num_repeats > 1:
            img_indices = [i for i in img_indices for _ in range(self.num_repeats)]
            if self.trunc_rep_aug:
                img_indices = img_indices[:n_samples]
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

    def n_valid_rank_i(self) -> int:
        """How many leading entries of this replica's share are samples of the
        list, not the padding that evens out the replicas."""
        if self.use_shards:
            start = self.rank * self.n_samples_per_replica
            return max(0, min(self.n_samples_per_replica, self.n_total - start))
        return max(0, -(-(self.n_total - self.rank) // self.num_replicas))

    @staticmethod
    def batch_of(rows: List[Tuple[int, int, int]], start: int, n_valid: int) -> "SampledBatch":
        """The batch whose first row is entry ``start`` of a share whose first
        ``n_valid`` entries are samples."""
        return SampledBatch(rows, max(0, min(len(rows), n_valid - start)))

    def __iter__(self) -> Iterator[List[Tuple[int, int, int]]]:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def extra_repr(self) -> str:
        return (f"num_repeats={self.num_repeats}, rank={self.rank},"
                f" num_replicas={self.num_replicas}")

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}({self.extra_repr()})"
