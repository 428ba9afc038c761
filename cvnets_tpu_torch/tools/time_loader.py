"""Time the classification loader on the host, piece by piece.

    python3 -m cvnets_tpu_torch.tools.time_loader [--batches N]

Run from the repository root: it takes ``chip_smoke.py``'s flagship flags
(``MAIN_TRAIN_ARGS``) and its ``smoke_imagenet`` dataset (seeded uint8 images of
about 500 × 375, made where a file would be decoded). No device is used; every
number is the host's. It prints, one line each:

* one sample on one thread (torch on one intra-op thread, as in a loader
  worker): the size probe and the transforms' draws, making the image, and the
  whole item (making the image, random resized crop bicubic to 256², flip),
  ms each, the median over 64 samples;
* the loader's img/s over N training batches of 128 (default 4) with 1, 2, 4
  and 8 worker threads (the first batch included);
* the bicubic crop-resize alone (``resize_image`` of a 290 × 380 crop to 256²)
  over 256 crops in 1, 4 and 8 threads and in 1, 4 and 8 processes, crops a
  second: how far threads scale against processes.
"""

from __future__ import annotations

import argparse
import multiprocessing
import random
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor


def _one_thread() -> None:
    import torch

    torch.set_num_threads(1)


def _crop():
    import numpy as np
    import torch

    img = np.random.default_rng(0).integers(0, 256, (375, 500, 3), dtype=np.uint8)
    return torch.from_numpy(img).permute(2, 0, 1)[:, 10:300, 20:400]


def _resize(_):
    from cvnets_tpu_torch.data.transforms.image import resize_image

    return int(resize_image(_CROP, (256, 256), "bicubic")[0, 0, 0])


_CROP = None


def _init_worker() -> None:
    global _CROP
    _one_thread()
    _CROP = _crop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batches", type=int, default=4)
    args = parser.parse_args(argv)
    sys.path.insert(0, ".")
    import torch

    import chip_smoke
    from cvnets_tpu_torch.data.data_loaders import create_train_val_loader
    from cvnets_tpu_torch.data.datasets import build_dataset_from_registry
    from cvnets_tpu_torch.options.opts import get_training_arguments

    chip_smoke.register_smoke_dataset()
    opts = get_training_arguments(args=chip_smoke.MAIN_TRAIN_ARGS)
    dataset = build_dataset_from_registry(opts, is_training=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rng = random.Random(0)
    parts = {"draw": [], "read": [], "item": []}
    for i in range(64):
        t0 = time.perf_counter()
        params = dataset.draw_params((256, 256, i), rng)
        t1 = time.perf_counter()
        dataset.read_image(i)
        t2 = time.perf_counter()
        dataset.get_item((256, 256, i), params)
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(1e3 * dt)
    torch.set_num_threads(threads)
    print("one sample, one thread (median ms): " + ", ".join(
        f"{k} {statistics.median(v):.3f}" for k, v in parts.items())
        + " (item: making the image, RRC bicubic to 256^2, flip)", flush=True)

    for workers in (1, 2, 4, 8):
        opts = get_training_arguments(args=chip_smoke.MAIN_TRAIN_ARGS
                                      + ["--dataset.workers", str(workers)])
        loader, _, _ = create_train_val_loader(opts)
        n, t0 = 0, time.perf_counter()
        for i, batch in enumerate(loader):
            n += batch["samples"].shape[0]
            if i + 1 == args.batches:
                break
        print(f"loader, {workers} threads: {n / (time.perf_counter() - t0):.1f} img/s "
              f"({n} images)", flush=True)

    for kind in ("threads", "processes"):
        for workers in (1, 4, 8):
            if kind == "threads":
                pool = ThreadPoolExecutor(workers, initializer=_init_worker)
            else:
                pool = multiprocessing.get_context("spawn").Pool(workers,
                                                                 initializer=_init_worker)
            with pool:
                list(pool.map(_resize, range(2 * workers)))  # warm-up
                t0 = time.perf_counter()
                list(pool.map(_resize, range(256)))
                dt = time.perf_counter() - t0
            print(f"resize alone, {workers} {kind}: {256 / dt:.1f} crops/s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
