"""``cvnets_tpu_torch.main_loss_landscape`` on the CPU against the JAX package's
``main_loss_landscape``: a micro MobileViTv2 (13 classes, 64 px, label-smoothed
CE) on the same perturbed weights, the same dummy batch and the same two
filter-normalized directions (drawn by JAX's
``generate_filter_normalized_direction`` and carried across as the weights
are), gives JAX's ``loss_at`` grid at every point within 1e-5 relative (float32
forward and loss, the sums in another order); the port's own directions are
filter-normalized and seeded by ``common.seed``; the entry point writes the
grid's JSON."""

from __future__ import annotations

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    SMALL_MODEL_ARGS,
    both_opts,
    nchw,
    perturbed_variables,
    port_model_from,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

ARGS = SMALL_MODEL_ARGS + ["--loss.category", "classification",
                           "--loss.classification.name", "cross_entropy",
                           "--loss.classification.cross-entropy.label-smoothing", "0.1"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def _as_port(tree: dict) -> dict:
    """A flax params tree as the port's parameter dict (torch names, layouts)."""
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    from torch_port_helpers import flat_leaves

    return {torch_key(path): torch.from_numpy(np.array(to_torch_layout(path, leaf)))
            for path, leaf in flat_leaves(tree)}


def test_the_grid_matches_jax_on_the_same_directions():
    from cvnets_tpu.loss import build_loss_fn as jax_loss
    from cvnets_tpu.models import get_model as jax_get_model
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.main_loss_landscape import loss_grid

    from main_loss_landscape import generate_filter_normalized_direction

    opts_jax, opts_torch = both_opts(ARGS)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 64, 64, 3)).astype(np.float32)
    y = rng.integers(0, 13, 4)
    jmodel = jax_get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    key = jax.random.PRNGKey(3)
    d1, d2 = (jax.tree_util.tree_map(np.asarray, generate_filter_normalized_direction(
        jax.random.fold_in(key, i), variables["params"])) for i in (1, 2))
    criteria = jax_loss(opts_jax)

    @jax.jit
    def loss_at(alpha, beta):  # main_loss_landscape.py:65-73
        p = jax.tree_util.tree_map(lambda w, a, b: w + alpha * a + beta * b,
                                   variables["params"], d1, d2)
        pred = jmodel.apply(dict(variables, params=p), jnp.asarray(x), training=False)
        loss = criteria(jnp.asarray(x), pred, jnp.asarray(y), training=False)
        return loss["total_loss"] if isinstance(loss, dict) else loss

    xs, ys = np.linspace(-1.0, 1.0, 3), np.linspace(-0.5, 0.5, 3)
    want = np.array([[float(loss_at(a, b)) for b in ys] for a in xs])
    model = port_model_from(opts_torch, variables)
    got = loss_grid(model, build_loss_fn(opts_torch), nchw(x), torch.from_numpy(y),
                    _as_port(d1), _as_port(d2), xs, ys)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    assert got[1, 1] < got.max()  # the grid is not flat


def test_port_directions_are_filter_normalized_and_seeded():
    from cvnets_tpu_torch.main_loss_landscape import filter_normalized_direction

    params = {"a": torch.randn(4, 3, 3, 3), "b": torch.zeros(5), "c": torch.randn(7)}
    d = filter_normalized_direction(params, torch.Generator().manual_seed(0))
    again = filter_normalized_direction(params, torch.Generator().manual_seed(0))
    for k, p in params.items():
        assert d[k].shape == p.shape and torch.equal(d[k], again[k])
        torch.testing.assert_close(d[k].norm(), p.norm(), rtol=1e-6, atol=0)


def test_the_entry_point_writes_the_grid(tmp_path, monkeypatch):
    import builtins

    from cvnets_tpu_torch.main_loss_landscape import main_loss_landscape

    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):  # the plots are gated on it, as in JAX
        if name.split(".")[0] == "matplotlib":
            raise ImportError(name)
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    grid = main_loss_landscape(args=ARGS + [
        "--loss-landscape.n-points", "2", "--sampler.bs.crop-size-width", "32",
        "--sampler.bs.crop-size-height", "32", "--common.results-loc", str(tmp_path)],
        device="cpu")
    with open(os.path.join(str(tmp_path), "run_1", "loss_landscape.json")) as f:
        saved = json.load(f)
    assert grid.shape == (2, 2) and np.isfinite(grid).all()
    np.testing.assert_array_equal(np.array(saved["loss"]), grid)
    assert saved["x"] == [-1.0, 1.0] and saved["y"] == [-1.0, 1.0]
    assert not os.path.exists(os.path.join(str(tmp_path), "run_1", "loss_contour.png"))
