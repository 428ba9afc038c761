"""The port's ``iou`` metric against the JAX ``IoUMetric`` on the same logits and
labels (ignored pixels, classes absent from both prediction and labels, three
batches summed through ``add_pairs`` and read back once through
``pairs_to_host``), the confusion matrix against numpy's ``bincount``, and the
exactness of vector sums: int64 per-class counts past 2^24 (where float32 stops
counting by one) come back exact."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import both_opts  # noqa: E402

ARGS = ["--dataset.category", "segmentation", "--model.segmentation.n-classes", "7",
        "--stats.val", "loss", "iou"]


def _batches(seed: int, n: int = 3, c: int = 7):
    """Logits that never predict classes 5 and 6, labels never 6 and with 10%
    ignored pixels."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        logits = rng.standard_normal((2, c, 9, 11)).astype(np.float32)
        logits[:, 5:] -= 10.0
        labels = rng.integers(0, c - 1, (2, 9, 11))
        labels[rng.random(labels.shape) < 0.1] = 255
        out.append((logits, labels))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_iou_matches_jax(seed):
    import jax.numpy as jnp

    from cvnets_tpu.metrics import build_metrics as jax_metrics
    from cvnets_tpu_torch.metrics.stats import Statistics, add_pairs, pairs_to_host

    jax_opts, opts = both_opts(ARGS)
    ref = jax_metrics(jax_opts, ["iou"])["iou"]
    stats = Statistics(opts, ["iou"])
    pairs = None
    for logits, labels in _batches(seed):
        ref.update_values(ref.batch_values(jnp.asarray(logits.transpose(0, 2, 3, 1)),
                                           jnp.asarray(labels)))
        step = {"iou": stats.metrics["iou"].batch_values(torch.from_numpy(logits),
                                                         torch.from_numpy(labels))}
        assert all(s.dtype == torch.int64 for s, _ in step["iou"].values())
        pairs = add_pairs(pairs, step)
    stats.update(pairs_to_host(pairs))
    got, want = stats.avg_statistics_all(), ref.compute()
    assert set(got) == {"iou"} and 0.0 < want < 100.0
    assert got["iou"] == pytest.approx(want, rel=1e-12)
    assert stats.metric_value("iou") == got["iou"]


def test_iou_of_a_dict_prediction_reads_the_segmentation_output():
    from cvnets_tpu_torch.metrics import build_metrics

    _, opts = both_opts(ARGS)
    (logits, labels), = _batches(5, n=1)
    metric = build_metrics(opts, ["iou"])["iou"]
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    plain = metric.batch_values(x, y)
    in_dict = metric.batch_values({"segmentation_output": x, "aux_output": -x}, y)
    for name in plain:
        assert torch.equal(plain[name][0], in_dict[name][0])


def test_confusion_matrix_is_numpys_bincount():
    from cvnets_tpu_torch.metrics.intersection_over_union import confusion_matrix

    rng = np.random.default_rng(0)
    pred = rng.integers(0, 5, (3, 17, 19))
    target = rng.integers(0, 5, (3, 17, 19))
    target[rng.random(target.shape) < 0.2] = 255
    target[0, 0, :3] = 9  # out of range, not the ignore label: not counted
    valid = (target != 255) & (target < 5)
    want = np.bincount(5 * target[valid] + pred[valid], minlength=25).reshape(5, 5)
    got = confusion_matrix(torch.from_numpy(pred), torch.from_numpy(target), 5, 255)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_vector_sums_stay_exact_past_2_to_24():
    from cvnets_tpu_torch.metrics.stats import add_pairs, pairs_to_host

    big = 2**24 + 1  # float32 holds 2^24 + 2 but not 2^24 + 1
    counts = torch.tensor([big, 2**40 + 3, 0, 7], dtype=torch.int64)
    assert torch.tensor(float(big), dtype=torch.float32).item() != big
    total = None
    for _ in range(3):
        total = add_pairs(total, {"iou": {"intersection": (counts, 1.0)},
                                  "loss": {"loss": (torch.tensor(0.1, dtype=torch.float32),
                                                    1.0)}})
    assert total["iou"]["intersection"][0].dtype == torch.int64
    host = pairs_to_host(total)
    np.testing.assert_array_equal(host["iou"]["intersection"][0],
                                  np.array([3 * big, 3 * (2**40 + 3), 0, 21], np.float64))
    assert host["iou"]["intersection"][0].astype(np.int64).tolist() == \
        (3 * counts).tolist()
    # a scalar sum comes back as the Python float of its float32 value, as before
    value, count = host["loss"]["loss"]
    assert isinstance(value, float) and value == total["loss"]["loss"][0].item()
    assert count == 3.0
