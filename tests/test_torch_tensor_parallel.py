"""The port's tensor parallelism and ring attention over a model axis of 2
(grid (1, 2): ``parallel/tensor_parallel.py``, ``parallel/ring_attention.py``),
held against the JAX package on the CPU: two gloo processes, both on the
whole batch, each with its half of the model.

One spawn of two ranks (over a ``file://`` store, with a timeout) runs every
port computation of this file:

* the micro ViT's SGD step with the clip and its AdamW steps with EMA and
  accumulation, with test_torch_fsdp's bounds against JAX's steps; the
  blocks after the steps (column-parallel ``qkv_proj``/``ffn_fc1``,
  row-parallel ``out_proj``/``ffn_fc2``, the LayerNorm scales stored as
  halves);
* ``--dev.sequence-parallel`` on the micro ViT without its CLS token (16
  tokens): every ``MultiHeadAttention`` takes the ring (two calls a step), and
  the SGD step keeps JAX's bounds (JAX's ring equals its local route);
* ring attention alone on (B 2, S 64, 4 heads of 16) with a key mask that
  masks a whole row: forward to 1e-5 and the gradients of Σ out² to 1e-4 of
  JAX's ``ring_attention`` on a (2, 4) mesh (tests/test_ring_attention.py's
  bounds);
* MobileNetV2 at width 0.5 (column-parallel pointwise and depthwise convs,
  row-parallel ``red_1x1``), in float64 without dropout: the loss and each
  rank's gradient blocks against one process of the port, to 1e-9 relative
  and 1e-9 of the largest gradient (in float32 the 17 batch-statistic BNs
  amplify the sums' reordering to 4e-3 of a tensor's gradient, measured);
* the draws: the two model ranks draw alike.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_fsdp import (  # noqa: E402
    SGD_ARGS,
    check_adamw_steps,
    check_sgd_step,
    check_shards,
    draws,
    jax_steps,
    run_ranks,
    vit_inputs,
)
from torch_port_helpers import (  # noqa: E402
    MP_SGD_ARGS,
    MP_SGD_LR,
    mp_grid_opts,
    mp_init,
    mp_steps,
)

WORLD = 2
SHAPE = [1, 2]
SP_ARGS = SGD_ARGS + ["--model.classification.vit.no-cls-token"]
MNV2_ARGS = ["--model.classification.name", "mobilenetv2",
             "--model.classification.mobilenetv2.width-multiplier", "0.5",
             "--model.classification.n-classes", "13", "--model.activation.name", "relu",
             "--dataset.category", "classification"] + MP_SGD_ARGS
RING = dict(b=2, s=64, h=4, d=16)


def _rank_main(index: int, store: str, inputs: str, out_dir: str) -> None:
    from cvnets_tpu_torch.parallel import mesh

    mp_init(index, WORLD, store)
    try:
        data = torch.load(inputs, weights_only=False)
        torch.save(_suite(data), os.path.join(out_dir, f"rank{index}.pt"))
    finally:
        mesh.destroy_group()


def _suite(data: dict) -> dict:
    opts = mp_grid_opts(SGD_ARGS, SHAPE)
    sgd, adam = data["sgd"], data["adamw"]
    out = {"sgd": mp_steps(opts, data["state"], sgd["xs"], sgd["ys"], sgd["lrs"])}
    opts = mp_grid_opts(adam["args"], SHAPE)
    out["adamw"] = mp_steps(opts, data["state"], adam["xs"], adam["ys"], adam["lrs"], accum=2)
    out["sp"] = sp_step(data["sp"])
    out["ring"] = ring_rank(data["ring"])
    out["mnv2"] = mnv2_grads(data["mnv2"], mp_grid_opts(MNV2_ARGS, SHAPE))
    out["draws"] = draws(opts)
    return out


def sp_step(run: dict) -> dict:
    """The SGD step under ``--dev.sequence-parallel``, counting the layers'
    calls of the ring."""
    from cvnets_tpu_torch.layers import multi_head_attention as mha

    calls = []
    real = mha.ring_attention
    mha.ring_attention = lambda *a, **k: calls.append(a[0].shape) or real(*a, **k)
    try:
        opts = mp_grid_opts(SP_ARGS, SHAPE, ["--dev.sequence-parallel"])
        out = mp_steps(opts, run["state"], run["xs"], run["ys"], [MP_SGD_LR])
    finally:
        mha.ring_attention = real
    return {**out, "ring_calls": calls}


def ring_rank(run: dict) -> dict:
    """``ring_attention`` on the whole tensors (this rank computing its slice),
    and the gradients of Σ out²."""
    from cvnets_tpu_torch.parallel.ring_attention import ring_attention

    q, k, v = (torch.from_numpy(run[n]).requires_grad_() for n in ("q", "k", "v"))
    out = {}
    for name, mask in (("none", None), ("masked", torch.from_numpy(run["mask"]))):
        for t in (q, k, v):
            t.grad = None
        y = ring_attention(q, k, v, RING["h"], mask)
        (y ** 2).sum().backward()
        out[name] = (y.detach(), q.grad.clone(), k.grad.clone(), v.grad.clone())
    return out


def mnv2_grads(run: dict, opts=None) -> dict:
    """MobileNetV2's float64 loss and gradients, without dropout: each rank's
    blocks over the grid of ``opts`` (whole in one process without them)."""
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.parallel import mesh
    from cvnets_tpu_torch.parallel.fsdp import ShardedState
    from cvnets_tpu_torch.parallel.sharding_rules import infer_param_specs

    model = get_model(opts or get_training_arguments(args=MNV2_ARGS), device="cpu")
    model.load_state_dict(run["state"])
    model.double().train()
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    shards = None
    if opts is not None:
        shards = ShardedState(model, None, None, infer_param_specs(model, 1, mesh.model_size()))
        shards.gather()
    x = torch.from_numpy(run["xs"][0].transpose(0, 3, 1, 2)).double() / 255.0
    loss = torch.nn.functional.cross_entropy(model(x), torch.from_numpy(run["ys"][0]))
    loss.backward()
    if shards is None:
        return {"loss": loss.item(), "grads": {n: p.grad for n, p in model.named_parameters()}}
    shards.reduce_grads()
    return {"loss": loss.item(), "grads": {leaf.name: leaf.storage.grad for leaf in shards.leaves},
            "specs": {leaf.name: leaf.spec for leaf in shards.leaves},
            "local": sorted(leaf.name for leaf in shards.leaves if leaf.local)}


# -------------------------------------------------------------- the parent
def ring_inputs() -> dict:
    """JAX's ring test's q, k, v and a key mask with a fully masked row."""
    rng = np.random.default_rng(5)
    b, s, e = RING["b"], RING["s"], RING["h"] * RING["d"]
    mask = np.where(rng.random((b, s)) < 0.2, -1e30, 0.0).astype(np.float32)
    mask[1] = -1e30  # every key of the second sample: its rows are uniform
    return {"q": (0.4 * rng.standard_normal((b, s, e))).astype(np.float32),
            "k": (0.4 * rng.standard_normal((b, s, e))).astype(np.float32),
            "v": rng.standard_normal((b, s, e)).astype(np.float32), "mask": mask}


def jax_ring(run: dict) -> dict:
    """JAX's ``ring_attention`` on a (2, 4) mesh and the gradients of Σ out²."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from cvnets_tpu.parallel.ring_attention import ring_attention

    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    qkv = tuple(jnp.asarray(run[n]) for n in ("q", "k", "v"))
    out = {}
    for name, mask in (("none", None), ("masked", jnp.asarray(run["mask"]))):
        def f(q, k, v, mask=mask):
            return ring_attention(q, k, v, RING["h"], mesh, mask)

        y = jax.jit(f)(*qkv)
        grads = jax.jit(jax.grad(lambda *t: jnp.sum(f(*t) ** 2), argnums=(0, 1, 2)))(*qkv)
        out[name] = (np.asarray(y), *(np.asarray(g) for g in grads))
    return out


def mnv2_inputs() -> dict:
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments

    torch.manual_seed(0)
    model = get_model(get_training_arguments(args=MNV2_ARGS), device="cpu")
    rng = np.random.default_rng(11)
    return {"state": model.state_dict(),
            "xs": [rng.integers(0, 256, (8, 64, 64, 3)).astype(np.uint8)],
            "ys": [rng.integers(0, 13, (8,))]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    if len(jax.devices()) < 8:
        pytest.skip("JAX's ring runs on 8 devices (tests/conftest.py gives 8 CPU devices)")
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    vit, sp = vit_inputs(), vit_inputs(SP_ARGS)
    ring, mnv2 = ring_inputs(), mnv2_inputs()
    data = {"state": vit["state"], "sgd": vit["sgd"], "adamw": vit["adamw"],
            "sp": {"state": sp["state"], "xs": sp["sgd"]["xs"], "ys": sp["sgd"]["ys"]},
            "ring": ring, "mnv2": mnv2}

    def jax_work():
        from test_torch_distributed import _jax_trajectory

        return {**jax_steps(vit), "ring": jax_ring(ring),
                "sp": _jax_trajectory({**sp["sgd"], "variables": sp["variables"]}),
                "mnv2": mnv2_grads(mnv2)}

    ranks, jax_runs = run_ranks(sys.modules[__name__], WORLD, tmp, data, jax_work)
    return {"ranks": ranks, "jax": jax_runs, "vit": vit}


# ----------------------------------------------------------------- tests
def test_tp_sgd_step_with_the_clip_matches_jax(runs):
    check_sgd_step(runs, 1, 2)


def test_tp_adamw_steps_with_ema_and_accumulation_match_jax(runs):
    check_adamw_steps(runs, 1, 2)


def test_tp_keeps_each_ranks_shards_after_the_steps(runs):
    check_shards(runs, 1, 2, fsdp=False)
    shapes = runs["ranks"][0]["adamw"]["shapes"]
    assert shapes["transformer_0.mha.qkv_proj.weight"] == (96, 64)  # column: outputs
    assert shapes["transformer_0.mha.out_proj.weight"] == (64, 32)  # row: inputs
    assert shapes["transformer_0.ffn_fc2.weight"] == (64, 128)
    assert shapes["transformer_0.pre_norm_mha.weight"] == (32,)
    assert shapes["transformer_0.ffn_fc2.bias"] == (64,)  # a row layer's bias stays whole


def test_sequence_parallel_vit_step_takes_the_ring_and_matches_jax(runs):
    from torch_port_helpers import assert_sgd_step_matches

    state, jloss, jnorm = runs["jax"]["sp"][0]
    for r in runs["ranks"]:
        sp = r["sp"]
        assert [tuple(s) for s in sp["ring_calls"]] == [(8, 16, 64)] * 2  # 2 blocks, 1 step
        sd, _, loss, norm = sp["steps"][0]
        assert norm == pytest.approx(jnorm, rel=1e-4)
        assert_sgd_step_matches(sd, state, loss, jloss)


@pytest.mark.parametrize("mask", ["none", "masked"])
def test_ring_attention_over_two_ranks_matches_jaxs_ring(runs, mask):
    want = runs["jax"]["ring"][mask]
    for r in runs["ranks"]:
        got = [t.numpy() for t in r["ring"][mask]]
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    if mask == "masked":  # the fully masked sample's rows: the mean of its values
        v = runs["ranks"][0]["ring"][mask][0][1].numpy()
        np.testing.assert_allclose(v, np.broadcast_to(v.mean(0), v.shape), atol=1e-5)


def test_tp_mobilenetv2_convs_match_one_process_in_float64(runs):
    from cvnets_tpu_torch.parallel import mesh
    from cvnets_tpu_torch.parallel.fsdp import block

    ref = runs["jax"]["mnv2"]
    gmax = max(float(g.abs().max()) for g in ref["grads"].values())
    for index, r in enumerate(runs["ranks"]):
        got = r["mnv2"]
        assert got["loss"] == pytest.approx(ref["loss"], rel=1e-9)
        real = mesh._GRID
        mesh._GRID = mesh.Grid(1, 2, 0, index)  # this rank's blocks of the whole gradients
        try:
            for name, g in got["grads"].items():
                want = block(ref["grads"][name], got["specs"][name])
                np.testing.assert_allclose(g.numpy(), want.numpy(), rtol=1e-9, atol=1e-9 * gmax,
                                           err_msg=f"rank {index} {name}")
        finally:
            mesh._GRID = real
        split = got["local"]
        assert any("red_1x1" in k for k in split) and any("exp_1x1" in k for k in split)
        assert any("conv_3x3" in k for k in split)  # the depthwise convs, groups and all


def test_model_ranks_draw_alike(runs):
    a, b = (r["draws"] for r in runs["ranks"])
    assert a == b
