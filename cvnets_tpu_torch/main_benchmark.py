"""Inference and data-pipeline throughput of the port (counterpart of
main_benchmark.py):

    python -m cvnets_tpu_torch.main_benchmark --common.config-file <yaml> \
        [--benchmark.batch-size 128] [--benchmark.warmup-iter 10] [--benchmark.n-iter 100]
    python -m cvnets_tpu_torch.main_benchmark --benchmark.data-pipeline \
        [--benchmark.data-pipeline-samples 512]

The first times the model's eval forward on a seeded batch at the config's
crop size, under the options' autocast: ``warmup-iter`` forwards, then
``n-iter`` timed ones ending in ``torch.cuda.synchronize`` on a card, and
logs and returns samples/s. Under ``--common.int8-inference`` the weights are
prequantized first, as served. The second writes a seeded ImageFolder of
random 512 × 512 JPEGs and times one epoch of the port's train loader over
it (decode, train transforms, collate; on a card the native nvJPEG route and
the ``crop_resize_flip`` kernel), after one warm batch, and returns images/s.
Both run on ``device``, the CUDA card unless the caller asks for the CPU.
"""

from __future__ import annotations

import os
import sys
import tempfile
import time
from typing import List, Optional, Union

import numpy as np
import torch

from cvnets_tpu_torch.options.opts import get_benchmarking_arguments
from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.common_utils import device_setup


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def write_jpeg_folder(root: str, n: int, seed: int = 0, classes: int = 4, side: int = 512) -> None:
    """``classes`` folders of ``n // classes`` (at least one) random ``side``²
    JPEGs at quality 85, drawn from ``seed``."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for c in range(classes):
        folder = os.path.join(root, f"class_{c}")
        os.makedirs(folder)
        for i in range(max(1, n // classes)):
            pixels = rng.integers(0, 255, (side, side, 3), dtype=np.uint8)
            Image.fromarray(pixels).save(os.path.join(folder, f"{i}.jpg"), quality=85)


def benchmark_data_pipeline(opts, device: torch.device) -> float:
    """Images/s of one epoch of the train loader over a seeded JPEG folder."""
    from cvnets_tpu_torch.data.data_loaders import create_train_val_loader

    n = getattr(opts, "benchmark.data_pipeline_samples", 512)
    with tempfile.TemporaryDirectory() as root:
        write_jpeg_folder(root, n, seed=getattr(opts, "common.seed", 0) or 0)
        for dest, value in (("dataset.name", "imagenet"), ("dataset.category", "classification"),
                            ("dataset.root_train", root), ("dataset.root_val", root)):
            setattr(opts, dest, value)
        if getattr(opts, "sampler.name", None) is None:
            setattr(opts, "sampler.name", "batch_sampler")
        loader, _, _ = create_train_val_loader(opts, pin_memory=device.type == "cuda",
                                               device=device)
        for _ in loader:  # the threads and decoders start
            break
        seen = 0
        t0 = time.perf_counter()
        for batch in loader:
            seen += int(batch["samples"].shape[0])
        _sync(device)
        dt = time.perf_counter() - t0
    rate = seen / dt
    logger.info(f"Preprocess: {rate:.1f} imgs/sec ({seen} imgs decoded+transformed+collated "
                f"in {dt:.2f}s)")
    return rate


def benchmark_inference(opts, device: torch.device) -> float:
    """Samples/s of the model's eval forward."""
    from cvnets_tpu_torch.layers.dtype_utils import autocast
    from cvnets_tpu_torch.main_conversion import crop_size
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.quantization import int8_inference_enabled, prequantize

    batch = getattr(opts, "benchmark.batch_size", 1)
    warmup = getattr(opts, "benchmark.warmup_iter", 10)
    n_iter = getattr(opts, "benchmark.n_iter", 100)
    model = get_model(opts, device=device).eval()
    if int8_inference_enabled(opts):
        prequantize(model)
    rng = np.random.default_rng(getattr(opts, "common.seed", 0) or 0)
    x = torch.from_numpy(rng.standard_normal((batch, 3, *crop_size(opts)),
                                             dtype=np.float32)).to(device)
    with torch.no_grad(), autocast(opts, device):
        for _ in range(warmup):
            model(x)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n_iter):
            model(x)
        _sync(device)
        dt = time.perf_counter() - t0
    rate = batch * n_iter / dt
    logger.info(f"Inference: {rate:.2f} samples/sec (batch={batch}, {n_iter} iters, {dt:.3f}s)")
    return rate


def main(opts, device: Union[str, torch.device, None] = None, **kwargs) -> float:
    device = device_setup(opts, device)
    if getattr(opts, "benchmark.data_pipeline", False):
        return benchmark_data_pipeline(opts, device)
    return benchmark_inference(opts, device)


def main_benchmark(args: Optional[List[str]] = None,
                   device: Union[str, torch.device, None] = None, **kwargs) -> float:
    return main(get_benchmarking_arguments(args=args), device=device, **kwargs)


if __name__ == "__main__":
    main_benchmark(sys.argv[1:])
