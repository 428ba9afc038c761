"""The ring attention's arithmetic in one process, and ``MultiHeadAttention``'s
routing under ``--dev.sequence-parallel`` (``parallel/ring_attention.py``),
against the JAX package's ``ring_attention`` on the CPU.

* The in-process form (``ring_attention_in_process``: M ranks' ring steps,
  the code a group runs, in lockstep in one process: the blocks' forward,
  their log-sum-exp merge and the block backward from the whole row's
  statistics)
  at M = 2 and 4, against JAX's ``ring_attention`` on a (2, 4) (data, model)
  mesh: the output to 1e-5 and the gradients of Σ out² to 1e-4 (relative
  and absolute), tests/test_ring_attention.py's bounds, with and without a
  key mask that masks every key of one sample: that sample's rows stay the
  einsum reference's uniform mean of its values.
* ``mha_attention_block_backward_plain`` summed over a row's key blocks is
  ``mha_attention_backward_plain`` of the whole row, to 1e-6 of the largest
  gradient (float32 sums in another order).
* The layer takes the ring when the model axis divides the sequence, and
  keeps its local route when it does not, or at one model rank (as JAX's
  ``ring_attention_eligible``).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_tensor_parallel import RING, jax_ring, ring_inputs  # noqa: E402


@pytest.fixture(scope="module")
def jax_results():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("JAX's ring runs on 8 devices (tests/conftest.py gives 8 CPU devices)")
    run = ring_inputs()
    return run, jax_ring(run)


@pytest.mark.parametrize("mask", ["none", "masked"])
@pytest.mark.parametrize("n", [2, 4])
def test_in_process_ring_matches_jaxs_ring(jax_results, n, mask):
    from cvnets_tpu_torch.parallel.ring_attention import ring_attention_in_process

    run, want = jax_results
    q, k, v = (torch.from_numpy(run[name]) for name in ("q", "k", "v"))
    km = torch.from_numpy(run["mask"]) if mask == "masked" else None
    out = ring_attention_in_process(q, k, v, RING["h"], n, km)
    grads = ring_attention_in_process(q, k, v, RING["h"], n, km, g=2 * out)[1:]
    want = want[mask]
    np.testing.assert_allclose(out.numpy(), want[0], rtol=0, atol=1e-5)
    for got, w in zip(grads, want[1:]):
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4, atol=1e-4)
    if mask == "masked":
        row = out[1].numpy()
        np.testing.assert_allclose(row, np.broadcast_to(run["v"][1].mean(0), row.shape),
                                   atol=1e-5)


def test_block_backward_sums_to_the_whole_rows_backward():
    from cvnets_tpu_torch.ops.mha_attention import (
        mha_attention_backward_plain,
        mha_attention_block_backward_plain,
        mha_attention_plain,
        mha_attention_stats_plain,
    )

    run = ring_inputs()
    q, k, v, km = (torch.from_numpy(run[name]) for name in ("q", "k", "v", "mask"))
    heads, s = RING["h"], q.shape[1]
    out = mha_attention_plain(q, k, v, heads, km)
    stats = mha_attention_stats_plain(q, k, v, heads, km)
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(q.shape).astype(np.float32))
    want = mha_attention_backward_plain(q, k, v, km, out, g, heads)
    dq = torch.zeros_like(q)
    dk, dv = [], []
    for b in range(4):  # four key blocks of the row
        cut = slice(b * s // 4, (b + 1) * s // 4)
        dq_b, dk_b, dv_b = mha_attention_block_backward_plain(
            q, k[:, cut].contiguous(), v[:, cut].contiguous(), km[:, cut].contiguous(), out, g,
            stats, heads)
        dq += dq_b
        dk.append(dk_b)
        dv.append(dv_b)
    for got, w in zip((dq, torch.cat(dk, 1), torch.cat(dv, 1)), want):
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                   atol=1e-6 * float(w.abs().max()))


@pytest.mark.parametrize("model, seq, takes_ring", [(2, 16, True), (4, 50, False),
                                                    (1, 16, False)],
                         ids=["divides", "does_not_divide", "one_model_rank"])
def test_mha_takes_the_ring_where_the_model_axis_divides_the_sequence(
        monkeypatch, model, seq, takes_ring):
    from cvnets_tpu_torch.layers import multi_head_attention as mha
    from cvnets_tpu_torch.ops.mha_attention import mha_attention_plain
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.parallel import mesh

    calls = []

    def ring(q, k, v, heads, key_mask=None):  # the local arithmetic, recorded
        calls.append(q.shape)
        return mha_attention_plain(q, k, v, heads, key_mask)

    monkeypatch.setattr(mha, "ring_attention", ring)
    monkeypatch.setattr(mesh, "_GRID", mesh.Grid(1, model, 0, 0))
    torch.manual_seed(0)
    layer = mha.MultiHeadAttention(get_training_arguments(args=["--dev.sequence-parallel"]),
                                   32, 4)
    local = mha.MultiHeadAttention(get_training_arguments(args=[]), 32, 4)
    local.load_state_dict(layer.state_dict())
    x = torch.randn(2, seq, 32)
    np.testing.assert_allclose(layer(x).detach().numpy(), local(x).detach().numpy(),
                               rtol=0, atol=1e-6)
    assert calls == ([(2, seq, 32)] if takes_ring else [])
