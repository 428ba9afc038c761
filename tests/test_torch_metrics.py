"""The port's metrics against the JAX package's, on the same numpy-seeded inputs:
``top_k_correct`` and the top-k metrics (ties, soft targets, registry key
arguments), ``Statistics`` over the same (sum, count) pairs, and
``AdjustBatchNormMomentum`` in its four modes. Counts and momenta compare
exactly; averages to 1e-6 relative, as the JAX loss metric holds its sums in
float32."""

from __future__ import annotations

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import both_opts  # noqa: E402


def _tied_logits(rng: np.random.Generator, n: int = 64, c: int = 10) -> np.ndarray:
    """Logits on a grid of 0.5, so that most rows hold ties, some at the
    target's value."""
    return (np.round(2 * rng.standard_normal((n, c))) / 2).astype(np.float32)


@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("soft", [False, True])
def test_top_k_correct_matches_jax_with_ties_and_soft_targets(k, soft):
    from cvnets_tpu.metrics.topk_accuracy import top_k_correct as jax_top_k
    from cvnets_tpu_torch.metrics.topk_accuracy import top_k_correct

    rng = np.random.default_rng(k + 10 * soft)
    logits = _tied_logits(rng)
    labels = rng.integers(0, 10, 64)
    # the target's logit tied with another class in a fifth of the rows
    logits[::5, (labels[::5] + 1) % 10] = logits[np.arange(0, 64, 5), labels[::5]]
    target = labels
    if soft:  # mixup-like rows whose arg-max is the label
        target = 0.5 * np.eye(10, dtype=np.float32)[labels] + 0.05
    want = float(jax_top_k(jnp.asarray(logits), jnp.asarray(target), k))
    got = top_k_correct(torch.from_numpy(logits), torch.from_numpy(target), k)
    assert got.dtype == torch.float32 and got.item() == want
    # torch.topk breaks ties by position: it disagrees on these rows
    if not soft and k == 1:
        by_topk = (torch.from_numpy(logits).topk(k).indices
                   == torch.from_numpy(labels)[:, None]).any(1).sum().item()
        assert by_topk != want


def test_top_k_metrics_take_registry_key_arguments_as_jax():
    from cvnets_tpu.metrics import build_metrics as jax_build
    from cvnets_tpu_torch.metrics import build_metrics

    opts_jax, opts_torch = both_opts([])
    names = ["top1(pred=logits)", "top5(pred=logits)"]
    jax_metrics, port_metrics = jax_build(opts_jax, names), build_metrics(opts_torch, names)
    assert sorted(jax_metrics) == sorted(port_metrics) == ["top1", "top5"]
    rng = np.random.default_rng(3)
    logits, labels = _tied_logits(rng, 33, 13), rng.integers(0, 13, 33)
    for name in port_metrics:
        want = jax_metrics[name].batch_values({"logits": jnp.asarray(logits)},
                                              jnp.asarray(labels))
        got = port_metrics[name].batch_values({"logits": torch.from_numpy(logits),
                                               "aux": None}, torch.from_numpy(labels))
        (wsum, wcount), = want.values()
        (gsum, gcount), = got.values()
        assert list(got) == list(want) and gcount == wcount == 33.0
        assert gsum.item() == float(wsum)


def _pairs(rng: np.random.Generator, dict_loss: bool):
    loss = ({"total_loss": rng.random(), "seg_loss": rng.random(), "aux_loss": rng.random()}
            if dict_loss else rng.random())
    n = int(rng.integers(1, 9))
    return loss, rng.random(), rng.integers(0, n + 1) * 100.0, n


@pytest.mark.parametrize("dict_loss", [False, True])
def test_statistics_average_the_same_pairs_as_jax(dict_loss):
    """The same per-batch loss (a scalar or a dict of parts), grad norm and top-k
    sums through both packages' metric objects and ``Statistics``: averages,
    the ``metric.sub`` flattening and ``metric_value``."""
    from cvnets_tpu.metrics.stats import Statistics as JaxStatistics
    from cvnets_tpu_torch.metrics.stats import Statistics, add_pairs, pairs_to_host

    names = ["loss", "grad_norm", "top1", "top5"]
    opts_jax, opts_torch = both_opts([])
    jax_stats, port_stats = JaxStatistics(opts_jax, names), Statistics(opts_torch, names)
    rng = np.random.default_rng(7 + dict_loss)
    total = None
    for i in range(5):
        loss, norm, correct, n = _pairs(rng, dict_loss)
        extras = {"loss": loss, "grad_norm": norm}
        jax_pairs = {name: m.batch_values(None, None, extras)
                     for name, m in jax_stats.metrics.items() if name.startswith(("loss", "grad"))}
        jax_pairs.update({f"top{k}": {f"top{k}": (correct, float(n))} for k in (1, 5)})
        jax_stats.update(precomputed=jax_pairs)
        t = (lambda v: torch.tensor(v, dtype=torch.float64))
        port_extras = {"loss": ({k: t(v) for k, v in loss.items()} if dict_loss else t(loss)),
                       "grad_norm": t(norm)}
        step = {name: m.batch_values(None, None, port_extras)
                for name, m in port_stats.metrics.items() if name.startswith(("loss", "grad"))}
        step.update({f"top{k}": {f"top{k}": (t(correct), float(n))} for k in (1, 5)})
        total = add_pairs(total, step)
        if i % 2 == 1:  # read back every second batch, as at log_freq 2
            port_stats.update(pairs_to_host(total))
            total = None
    port_stats.update(pairs_to_host(total))
    want, got = jax_stats.avg_statistics_all(), port_stats.avg_statistics_all()
    assert list(got) == list(want)
    for key in want:
        assert got[key] == pytest.approx(float(want[key]), rel=1e-6, abs=0), key
    if dict_loss:
        assert {"loss", "loss.seg_loss", "loss.aux_loss"} <= set(got)
    for name in ["loss", "top1", "top5", "grad_norm"]:
        assert port_stats.metric_value(name) == pytest.approx(
            jax_stats.metric_value(name), rel=1e-6, abs=0), name
    if dict_loss:  # the JAX metric_value raises a KeyError for a loss part
        assert port_stats.metric_value("loss.seg_loss") == got["loss.seg_loss"]


@pytest.mark.parametrize("anneal", ["cosine", "linear"])
@pytest.mark.parametrize("iteration_based", [False, True])
def test_adjust_bn_momentum_matches_jax(anneal, iteration_based):
    from cvnets_tpu.layers.normalization import AdjustBatchNormMomentum as JaxAdjust
    from cvnets_tpu_torch.layers.normalization import AdjustBatchNormMomentum

    args = ["--model.normalization.adjust-bn-momentum.enable",
            "--model.normalization.adjust-bn-momentum.anneal-type", anneal,
            "--model.normalization.adjust-bn-momentum.final-momentum-value", "1e-3",
            "--model.normalization.momentum", "0.2",
            "--scheduler.max-epochs", "30", "--scheduler.max-iterations", "500",
            "--scheduler.warmup-iterations", "40"]
    if iteration_based:
        args.append("--scheduler.is-iteration-based")
    opts_jax, opts_torch = both_opts(args)
    ref, port = JaxAdjust(opts_jax), AdjustBatchNormMomentum(opts_torch)
    seen = set()
    for epoch, it in [(0, 0), (0, 39), (1, 40), (2, 41), (7, 123), (15, 250), (29, 459),
                      (30, 460), (31, 499), (40, 600)]:
        m = port.get_momentum(epoch, it)
        assert m == ref.get_momentum(epoch, it), (epoch, it)
        seen.add(m)
    assert len(seen) >= 6 and max(seen) == 0.2 and min(seen) == pytest.approx(1e-3)
