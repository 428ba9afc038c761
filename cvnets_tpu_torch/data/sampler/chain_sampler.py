"""Chain sampler (counterpart of cvnets_tpu/data/sampler/chain_sampler.py:18-84):
child samplers, each from an entry of the ``sampler.chain_sampler`` list (a
yaml list of ``{task_name, sampler_name, <sampler keys>}``), iterated one
after another (``--sampler.chain-sampler-mode sequential``) or in turns
(``interleave``, until every child is spent). ``n_data_samples`` is a count,
or a dict of counts by task name. A ``*_ddp`` child name is its plain
sampler's. Each child shards over the ranks itself, and every rank iterates
the children in one order, so a step's batches come from one child on every
rank."""

from __future__ import annotations

import argparse
import copy
from typing import Dict, Iterator, List, Tuple

from cvnets_tpu_torch.data.sampler import SAMPLER_REGISTRY
from cvnets_tpu_torch.data.sampler.base_sampler import BaseSampler
from cvnets_tpu_torch.options.utils import flatten_yaml_as_dict


@SAMPLER_REGISTRY.register(name="chain_sampler")
class ChainSampler(BaseSampler):
    def __init__(self, opts, n_data_samples, is_training: bool = True, **kwargs) -> None:
        super().__init__(opts, n_data_samples=0 if isinstance(n_data_samples, dict)
                         else n_data_samples, is_training=is_training, **kwargs)
        chain_cfg = getattr(opts, "sampler.chain_sampler", None)
        if not isinstance(chain_cfg, list) or not chain_cfg:
            raise ValueError("sampler.chain_sampler must be a non-empty list (set it in a yaml)")
        self.mode = getattr(opts, "sampler.chain_sampler_mode", "sequential")
        self.child_samplers: Dict[str, BaseSampler] = {}
        for entry in chain_cfg:
            entry = dict(entry)
            task_name = entry.pop("task_name")
            child_name = entry.pop("sampler_name", None) or entry.pop("name", None)
            sub_opts = copy.copy(opts)
            for k, v in flatten_yaml_as_dict(entry).items():
                setattr(sub_opts, k if k.startswith("sampler.") else f"sampler.{k}", v)
            n = (n_data_samples[task_name] if isinstance(n_data_samples, dict)
                 else n_data_samples)
            if child_name.endswith("_ddp"):
                child_name = child_name[: -len("_ddp")]
            self.child_samplers[task_name] = SAMPLER_REGISTRY[child_name](
                sub_opts, n_data_samples=n, is_training=is_training, rank=self.rank,
                num_replicas=self.num_replicas)
        self.n_samples_per_replica = sum(s.n_samples_per_replica
                                         for s in self.child_samplers.values())

    @classmethod
    def add_arguments(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        if cls != ChainSampler:
            return parser
        group = parser.add_argument_group(cls.__name__)
        group.add_argument("--sampler.chain-sampler", type=str, default=None,
                           help="List of child sampler configs; set via yaml")
        group.add_argument("--sampler.chain-sampler-mode", type=str, default="sequential",
                           choices=["sequential", "interleave"])
        return parser

    def set_epoch(self, epoch: int) -> None:
        super().set_epoch(epoch)
        for s in self.child_samplers.values():
            s.set_epoch(epoch)

    def update_scales(self, epoch: int, is_master_node: bool = False) -> None:
        for s in self.child_samplers.values():
            s.update_scales(epoch, is_master_node)

    def update_indices(self, new_indices) -> None:
        for s in self.child_samplers.values():
            s.update_indices(new_indices)

    def __iter__(self) -> Iterator[List[Tuple[int, int, int]]]:
        if self.mode == "sequential":
            for s in self.child_samplers.values():
                yield from s
            return
        live = [iter(s) for s in self.child_samplers.values()]
        while live:
            nxt = []
            for it in live:
                try:
                    yield next(it)
                    nxt.append(it)
                except StopIteration:
                    pass
            live = nxt

    def __len__(self) -> int:
        return sum(len(s) for s in self.child_samplers.values())

    def extra_repr(self) -> str:
        return f"mode={self.mode}, children={list(self.child_samplers.values())}"
