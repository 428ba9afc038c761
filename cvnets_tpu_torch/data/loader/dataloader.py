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
and in one resumed at that epoch. A rank other than 0 of a process group adds
its rank to that string, so that ranks draw different crops and flips.

A batch whose sampler rows end in padding (``SampledBatch.n_valid``, the rows
that even out the ranks and fill the trailing batch) carries ``n_valid``, the
number of its leading rows that are samples; evaluation counts only those.
``update_indices`` hands sample-efficient training's list to the sampler.

A batch the dataset can take whole through the native decoder (its
``_native_batch_eligible``, with a collate of ``NATIVE_BATCH_COLLATES``, those
of cvnets_tpu/data/loader/dataloader.py:57-59) goes through its
``fetch_batch_native`` on ``device`` (on a card, nvJPEG decodes its files in
``num_workers`` chunks at once on the pool's threads); any other batch takes the per-sample
route above, as the JAX loader routes them. On a card the producer enqueues
the decode on a stream of its own and records an event; the consumer's
stream waits on it and the batch's tensors are marked as used there
(``record_stream``), so neither reads nor frees early. That batch is already
on the card and is not pinned (its host tensors are). The route of the first
training batch is logged once.
"""

from __future__ import annotations

import queue
import random
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Union

import torch

from cvnets_tpu_torch.utils import logger

_SENTINEL = object()
# collates whose output the native whole-batch route reproduces
NATIVE_BATCH_COLLATES = ("default_collate_fn", "image_classification_data_collate_fn")


def _pin(batch):
    if isinstance(batch, dict):
        return {k: _pin(v) for k, v in batch.items()}
    if isinstance(batch, torch.Tensor) and batch.device.type == "cpu":
        return batch.pin_memory()
    return batch


class _OnStream:
    """A batch enqueued on the producer's stream, and the event after it."""

    def __init__(self, batch: Dict, ready: "torch.cuda.Event", device: torch.device) -> None:
        self.batch, self.ready, self.device = batch, ready, device

    def wait(self) -> Dict:
        """The batch, ordered before the current stream's later work."""
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.ready)
        for v in self.batch.values():
            if isinstance(v, torch.Tensor) and v.device.type == "cuda":
                v.record_stream(stream)
        return self.batch


def _with_valid_rows(item, batch_tuples):
    """``item`` with ``n_valid`` set where its sampler rows end in padding."""
    n_valid = getattr(batch_tuples, "n_valid", None)
    batch = item.batch if isinstance(item, _OnStream) else item
    if n_valid is not None and n_valid < len(batch_tuples) and isinstance(batch, dict):
        batch["n_valid"] = n_valid
    return item


def _one_intra_op_thread() -> None:
    torch.set_num_threads(1)  # per thread: the workers do not oversubscribe the cores


class CVNetsDataLoader:
    def __init__(self, dataset, batch_sampler, collate_fn: Optional[Callable] = None,
                 num_workers: int = 0, prefetch_factor: int = 2, pin_memory: bool = False,
                 opts=None, device: Union[str, torch.device] = "cuda") -> None:
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
        self.device = torch.device(device)  # where the native route decodes
        self._stream = self._decoder = None  # the native route's, on a card
        self._logged_route = False

    def _native(self, batch_tuples) -> bool:
        fn = getattr(self.collate_fn, "func", self.collate_fn)  # a partial's function
        native = (hasattr(self.dataset, "fetch_batch_native")
                  and (fn is None or getattr(fn, "__name__", "") in NATIVE_BATCH_COLLATES)
                  and self.dataset._native_batch_eligible(batch_tuples))
        if not self._logged_route and getattr(self.dataset, "is_training", False):
            self._logged_route = True
            route = (f"the native whole-batch route on {self.device}" if native
                     else "the per-sample route")
            logger.log(f"train loader: {route} (--dataset.decoder "
                       f"{getattr(self.opts, 'dataset.decoder', None)})")
        return native

    def _fetch_native(self, batch_tuples, rng: random.Random):
        if self.device.type != "cuda":
            batch = self.dataset.fetch_batch_native(batch_tuples, rng, self.device)
            return _pin(batch) if self.pin_memory else batch
        if self._stream is None:
            from cvnets_tpu_torch.native import JpegDecoder

            self.device = torch.device("cuda", torch.cuda.current_device()) \
                if self.device.index is None else self.device
            self._stream = torch.cuda.Stream(self.device)
            self._decoder = JpegDecoder(self.device, threads=max(1, self.num_workers),
                                        pool=self._pool)
        with torch.cuda.stream(self._stream):
            batch = self.dataset.fetch_batch_native(batch_tuples, rng, self.device,
                                                    self._decoder)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return _OnStream(_pin(batch) if self.pin_memory else batch, ready, self.device)

    def __len__(self) -> int:
        return len(self.batch_sampler)

    def update_indices(self, new_indices) -> None:
        self.batch_sampler.update_indices(new_indices)

    def _fetch_batch(self, batch_tuples, rng: random.Random) -> Dict:
        if self._native(batch_tuples):
            return self._fetch_native(batch_tuples, rng)
        draw = getattr(self.dataset, "draw_params", None)
        if draw is not None:
            params = [draw(t, rng) for t in batch_tuples]  # in sample order, in this thread
            work = lambda tp: self.dataset.get_item(*tp)  # noqa: E731
            jobs = list(zip(batch_tuples, params))
        else:
            work, jobs = self.dataset.__getitem__, batch_tuples
        items = list(self._pool.map(work, jobs)) if self._pool is not None else \
            [work(j) for j in jobs]
        if self.collate_fn is None:
            batch = items
        elif getattr(self.collate_fn, "takes_rng", False):  # draws in this thread, in order
            batch = self.collate_fn(items, self.opts, rng=rng)
        else:
            batch = self.collate_fn(items, self.opts)
        return _pin(batch) if self.pin_memory else batch

    def __iter__(self) -> Iterator[Dict]:
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_factor)
        epoch = getattr(self.batch_sampler, "epoch", 0)
        rank = getattr(self.batch_sampler, "rank", 0)
        rng = random.Random(f"transforms:{self.seed}:{epoch}" + (f":{rank}" if rank else ""))
        stop = threading.Event()

        def producer():
            try:
                for batch_tuples in self.batch_sampler:
                    if stop.is_set():
                        return
                    out_q.put(_with_valid_rows(self._fetch_batch(batch_tuples, rng),
                                               batch_tuples))
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
                yield item.wait() if isinstance(item, _OnStream) else item
        finally:  # a consumer that stops early lets the producer finish its batch and end
            stop.set()
            while thread.is_alive():
                try:
                    out_q.get(timeout=0.05)
                except queue.Empty:
                    pass
