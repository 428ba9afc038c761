"""``cvnets_tpu_torch.main_benchmark`` on the CPU, both routes: the inference
timing of a micro MobileViTv2 (float, and int8 dynamic, whose weights it
prequantizes and whose products take ``torch._int_mm``), and the data pipeline
over a seeded JPEG folder through the port's loader (the plain decode route on
the CPU). Only that each returns a positive, finite rate and runs what it says
is checked here; the rates themselves are the card's to measure."""

from __future__ import annotations

import math
import sys

import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import SMALL_MODEL_ARGS, torch_threads  # noqa: E402

SMALL = SMALL_MODEL_ARGS + ["--sampler.bs.crop-size-width", "32",
                            "--sampler.bs.crop-size-height", "32"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.mark.parametrize("extra", [[], ["--common.int8-inference", "--common.int8-mode",
                                         "dynamic"]], ids=["float", "int8_dynamic"])
def test_inference_samples_per_second(extra, monkeypatch):
    from cvnets_tpu_torch import main_benchmark, quantization

    calls, built = [], []
    real_mm, real_prequantize = torch._int_mm, quantization.prequantize

    def counted_mm(a, b):
        calls.append(a.shape)
        return real_mm(a, b)

    def seen_prequantize(model):
        built.append(model)
        return real_prequantize(model)

    monkeypatch.setattr(torch, "_int_mm", counted_mm)
    monkeypatch.setattr(quantization, "prequantize", seen_prequantize)
    rate = main_benchmark.main_benchmark(args=SMALL + extra + [
        "--benchmark.batch-size", "2", "--benchmark.warmup-iter", "1",
        "--benchmark.n-iter", "2"], device="cpu")
    assert rate > 0 and math.isfinite(rate)
    if extra:
        layers = quantization.int8_layers(built[0])
        assert all(m.weight.dtype == torch.int8 for m in layers.values())
        assert len(calls) == 3 * len(layers)  # every layer, every forward
    else:
        assert not calls and not built


def test_data_pipeline_images_per_second(monkeypatch):
    from cvnets_tpu_torch import main_benchmark

    written = []
    real_write = main_benchmark.write_jpeg_folder

    def small_folder(root, n, seed=0):
        written.append(n)
        return real_write(root, n, seed=seed, side=48)

    monkeypatch.setattr(main_benchmark, "write_jpeg_folder", small_folder)
    rate = main_benchmark.main_benchmark(args=[
        "--benchmark.data-pipeline", "--benchmark.data-pipeline-samples", "16",
        "--sampler.bs.crop-size-width", "32", "--sampler.bs.crop-size-height", "32",
        "--dataset.train-batch-size0", "4", "--dataset.workers", "2"], device="cpu")
    assert written == [16] and rate > 0 and math.isfinite(rate)
