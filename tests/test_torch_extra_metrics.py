"""The port's remaining metrics (``cvnets_tpu_torch/metrics/extra_metrics.py``)
against the JAX package's (cvnets_tpu/metrics/extra_metrics.py), on the same
numpy-seeded predictions and targets: ``psnr`` a batch at a time, and
``average_precision``, ``confusion_matrix`` and ``prob_hist`` over an epoch
of several batches, through the port's (sum, count) and gathered-row
read-back (``metrics.stats``). And the log writers (``engine/utils.py``):
JSON lines, and TensorBoard falling back to them where it cannot load."""

from __future__ import annotations

import json
import sys

import numpy as np
import pytest
import torch


def _port_epoch(name, batches):
    from cvnets_tpu_torch.metrics.stats import Statistics, add_pairs, gathered_pairs
    from cvnets_tpu_torch.options.opts import get_training_arguments

    stats = Statistics(get_training_arguments(args=[]), [name])
    pairs = None
    for pred, target in batches:
        pairs = add_pairs(pairs, {name: stats.metrics[name].batch_values(
            torch.from_numpy(pred), torch.from_numpy(target))})
    stats.update(gathered_pairs(pairs))
    return stats.avg_statistics()[name]


def _jax_epoch(name, batches):
    from cvnets_tpu.metrics import build_metrics

    metric = next(iter(build_metrics(None, [name]).values()))
    for pred, target in batches:
        metric.update(pred, target)
    return metric.compute()


def _batches(seed, n_batches=3, rows=7, classes=6, multi_hot=False, probs=False):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        pred = rng.standard_normal((rows, classes)).astype(np.float32)
        if probs:
            pred = np.exp(pred) / np.exp(pred).sum(-1, keepdims=True)
        target = ((rng.random((rows, classes)) < 0.3).astype(np.float32) if multi_hot
                  else rng.integers(0, classes, rows))
        out.append((pred, target))
    return out


def _assert_same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-9), k
    else:
        assert got == pytest.approx(want, rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("multi_hot", [False, True])
def test_average_precision_matches_jax(multi_hot):
    batches = _batches(0, multi_hot=multi_hot)
    _assert_same(_port_epoch("average_precision", batches),
                 _jax_epoch("average_precision", batches))


def test_confusion_matrix_matches_jax():
    batches = _batches(1)
    _assert_same(_port_epoch("confusion_matrix", batches), _jax_epoch("confusion_matrix",
                                                                       batches))


@pytest.mark.parametrize("probs", [False, True])
def test_prob_hist_matches_jax(probs):
    batches = _batches(2, probs=probs)
    _assert_same(_port_epoch("prob_hist", batches), _jax_epoch("prob_hist", batches))


def test_psnr_matches_jax_batch_by_batch():
    rng = np.random.default_rng(3)
    batches = [(rng.random((2, 3, 8, 8)).astype(np.float32),
                rng.random((2, 3, 8, 8)).astype(np.float32)) for _ in range(3)]
    batches.append((batches[0][0], batches[0][0]))  # mse 0: the 1e-10 floor
    _assert_same(_port_epoch("psnr", batches), _jax_epoch("psnr", batches))


def test_extra_metrics_are_registered_under_the_jax_names():
    from cvnets_tpu_torch.metrics import METRICS_REGISTRY

    for name in ("psnr", "average_precision", "confusion_matrix", "prob_hist"):
        assert METRICS_REGISTRY[name].__module__ == "cvnets_tpu_torch.metrics.extra_metrics"


def test_jsonl_writer_appends_one_line_a_scalar(tmp_path):
    from cvnets_tpu_torch.engine.utils import JSONLLogWriter, log_metrics

    writer = JSONLLogWriter(str(tmp_path))
    log_metrics([writer], {"loss": 1.5, "top1": 50, "skipped": "text"}, 3, prefix="val/")
    writer.close()
    lines = [json.loads(line) for line in (tmp_path / "scalars.jsonl").read_text().splitlines()]
    assert lines == [{"tag": "val/loss", "value": 1.5, "step": 3},
                     {"tag": "val/top1", "value": 50.0, "step": 3}]


def test_tensorboard_flag_falls_back_to_jsonl_where_tensorboard_cannot_load(
        tmp_path, monkeypatch):
    from cvnets_tpu_torch.engine.utils import JSONLLogWriter, get_log_writers
    from cvnets_tpu_torch.options.opts import get_training_arguments

    assert get_log_writers(get_training_arguments(args=[]), str(tmp_path)) == []
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # the import fails
    writers = get_log_writers(get_training_arguments(args=["--common.tensorboard-logging"]),
                              str(tmp_path))
    assert len(writers) == 1 and isinstance(writers[0], JSONLLogWriter)
    writers[0].close()


def test_the_trainer_writes_its_epoch_summaries_on_the_master(tmp_path, monkeypatch):
    """One epoch of the micro Trainer with --common.tensorboard-logging (here
    through the JSON-lines fallback): the train and val summaries a line each."""
    sys.path.insert(0, "tests")
    from torch_port_helpers import TRAINER_MICRO_ARGS, uint8_batches

    from cvnets_tpu_torch.engine import Trainer
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    opts = get_training_arguments(args=TRAINER_MICRO_ARGS + [
        "--common.tensorboard-logging", "--scheduler.max-epochs", "1",
        "--common.results-loc", str(tmp_path)])
    batches = uint8_batches(0, 2)
    trainer = Trainer(opts, get_model(opts, device="cpu"), build_loss_fn(opts), batches,
                      batches[:1], device="cpu")
    trainer.run()
    tags = [json.loads(line)["tag"] for line in
            open(f"{trainer.save_dir}/scalars.jsonl").read().splitlines()]
    assert {"train/loss", "val/loss", "val/top1", "val_ema/top1"} <= set(tags)
