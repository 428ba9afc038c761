"""Host-side data loader (counterpart of cvnets_tpu/data/loader/dataloader.py).

The batch sampler yields whole batches of (crop_h, crop_w, idx) tuples. A
producer thread takes them in order, draws every sample's transform
parameters from the epoch's ``random.Random`` (in sample order, before any
worker runs), has a pool of ``num_workers`` threads read and transform the
samples (Pillow and torch's resampling release the GIL; each worker runs
torch ops on one intra-op thread), collates them and, with ``pin_memory``,
pins the batch, so that the Trainer's ``non_blocking`` copy to the card
overlaps the step. ``prefetch_factor`` batches wait in a queue; an error in
the producer or a worker is raised in the consumer.

The epoch's generator is ``random.Random(f"transforms:{seed}:{epoch}")``, the
epoch being the sampler's: an epoch's batches are the same in an unbroken run
and in one resumed at that epoch.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import torch

_SENTINEL = object()


def _pin(batch):
    if isinstance(batch, dict):
        return {k: _pin(v) for k, v in batch.items()}
    return batch.pin_memory() if isinstance(batch, torch.Tensor) else batch


def _one_intra_op_thread() -> None:
    torch.set_num_threads(1)  # per thread: the workers do not oversubscribe the cores


class CVNetsDataLoader:
    def __init__(self, dataset, batch_sampler, collate_fn: Optional[Callable] = None,
                 num_workers: int = 0, prefetch_factor: int = 2, pin_memory: bool = False,
                 opts=None) -> None:
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.collate_fn = collate_fn
        self.num_workers = max(0, num_workers)
        self.prefetch_factor = max(1, prefetch_factor)
        self.pin_memory = pin_memory
        self.opts = opts
        self.seed = getattr(opts, "common.seed", 0) or 0
        self._pool = (ThreadPoolExecutor(max_workers=self.num_workers,
                                         initializer=_one_intra_op_thread)
                      if self.num_workers > 0 else None)

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def _fetch_batch(self, batch_tuples, rng: random.Random) -> Dict:
        draw = getattr(self.dataset, "draw_params", None)
        if draw is not None:
            params = [draw(t, rng) for t in batch_tuples]  # in sample order, in this thread
            work = lambda tp: self.dataset.get_item(*tp)  # noqa: E731
            jobs = list(zip(batch_tuples, params))
        else:
            work, jobs = self.dataset.__getitem__, batch_tuples
        items = list(self._pool.map(work, jobs)) if self._pool is not None else \
            [work(j) for j in jobs]
        batch = self.collate_fn(items, self.opts) if self.collate_fn is not None else items
        return _pin(batch) if self.pin_memory else batch

    def __iter__(self) -> Iterator[Dict]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_factor)
        rng = random.Random(f"transforms:{self.seed}:{getattr(self.batch_sampler, 'epoch', 0)}")
        stop = threading.Event()

        def producer():
            try:
                for batch_tuples in self.batch_sampler:
                    if stop.is_set():
                        return
                    out_q.put(self._fetch_batch(batch_tuples, rng))
            except BaseException as e:  # raised again in the consumer
                out_q.put(e)
                return
            out_q.put(_SENTINEL)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is _SENTINEL:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:  # a consumer that stops early lets the producer finish its batch and end
            stop.set()
            while thread.is_alive():
                try:
                    out_q.get(timeout=0.05)
                except queue.Empty:
                    pass
