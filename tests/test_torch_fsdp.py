"""The port's FSDP (``--dev.fsdp`` over a data axis of 2, ``parallel/fsdp.py``)
and MoE's global routing at grid (2, 1), held against the JAX package's step
and MoE layer on the global batch: two gloo processes on the CPU, each with
its half of every batch.

One spawn of two ranks (over a ``file://`` store, with a timeout) runs every
port computation of this file; the tests compare the ranks' results with
JAX's:

* one SGD step (no momentum) of the micro ViT with grad clip 1 (its norm is
  about 5, so the clip scales the step): the loss to 1e-4 relative and every
  parameter to 5e-4 (the JAX package's own FSDP test's bounds), the global
  gradient norm the clip sees to 1e-4 relative;
* three AdamW steps with EMA and ``--common.accum-freq 2``:
  test_torch_distributed's bounds for the same steps over data parallelism;
* the shards after the steps: each leaf of 8,192 elements or more keeps half
  its largest divisible dim (ties toward JAX's trailing dim), its AdamW
  moments the same shape, the small leaves whole, and each rank's state
  bytes under one process's;
* MoE (4 experts, top 2, capacity factor 0.5 and 8) on each rank's half of the
  tokens: the global routing's decisions token for token (drops included),
  the load-balance loss to 1e-6, the outputs and the gradients to 2e-6 of
  their largest value, against JAX's layer on all the tokens (test_torch_moe
  holds one process to 1e-6; across ranks the load-balance loss's gradient
  is the sum of the ranks' copies, float32 sums in another order: measured
  1.04e-6 on the tokens' gradient without drops);
* the draws: two data ranks draw differently on the host and the device.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_helpers import (  # noqa: E402
    MP_SGD_ARGS,
    MP_SGD_LR,
    VIT_MICRO_ARGS,
    mp_global_loss,
    mp_grid_opts,
    mp_init,
    mp_pairs,
    mp_spawn,
    mp_steps,
)

WORLD = 2
SGD_ARGS = VIT_MICRO_ARGS + MP_SGD_ARGS + ["--common.grad-clip", "1.0"]
MOE_CFS = (0.5, 8.0)


def _rank_main(index: int, store: str, inputs: str, out_dir: str) -> None:
    from cvnets_tpu_torch.parallel import mesh

    mp_init(index, WORLD, store)
    try:
        data = torch.load(inputs, weights_only=False)
        torch.save(_suite(data), os.path.join(out_dir, f"rank{index}.pt"))
    finally:
        mesh.destroy_group()


def _suite(data: dict) -> dict:
    opts = mp_grid_opts(SGD_ARGS, [WORLD], ["--dev.fsdp"])
    sgd = data["sgd"]
    out = {"sgd": mp_steps(opts, data["state"], sgd["xs"], sgd["ys"], sgd["lrs"])}
    adam = data["adamw"]
    opts = mp_grid_opts(adam["args"], [WORLD], ["--dev.fsdp"])
    out["adamw"] = mp_steps(opts, data["state"], adam["xs"], adam["ys"], adam["lrs"], accum=2)
    out["moe"] = {cf: moe_rank(data["moe"][cf], cf) for cf in MOE_CFS}
    out["draws"] = draws(opts)
    return out


def moe_rank(run: dict, cf: float) -> dict:
    """The port's MoE layer on this rank's rows of the tokens, its experts
    split over the model group where the grid has one: the loss D·Σ y² over
    its rows plus the load-balance loss (their average over the data ranks is
    JAX's Σ y² + aux), the gradients averaged over the data group, and the
    global routing's decisions."""
    from test_torch_moe import D, E, F_DIM, K

    from cvnets_tpu_torch.modules import moe
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.parallel import mesh
    from cvnets_tpu_torch.parallel.sharding_rules import infer_param_specs
    from cvnets_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel

    layer = moe.MoEFFN(get_training_arguments(args=VIT_MICRO_ARGS), D, F_DIM, num_experts=E,
                       top_k=K, capacity_factor=cf).train()
    params = run["params"]
    with torch.no_grad():
        layer.router.weight.copy_(torch.from_numpy(params["router"]["kernel"].T.copy()))
        for name in ("experts_fc1", "experts_fc1_bias", "experts_fc2", "experts_fc2_bias"):
            getattr(layer, name).copy_(torch.from_numpy(params[name]))
    apply_tensor_parallel(layer, infer_param_specs(layer, mesh.data_size(), mesh.model_size()))
    g = mesh.grid()
    n = run["x"].shape[0] // g.data
    x = torch.from_numpy(run["x"][g.data_index * n:(g.data_index + 1) * n]).requires_grad_()
    routed = []
    real_route = moe.route
    moe.route = lambda *a: routed.append(real_route(*a)) or routed[-1]
    try:
        y = layer(x)
    finally:
        moe.route = real_route
    (g.data * (y ** 2).sum() + layer.aux_loss).backward()
    mesh.sync_gradients(list(layer.parameters()))
    expert, place, kept, weight, _ = routed[0]
    return {"y": y.detach(), "aux": layer.aux_loss.item(), "gx": x.grad / g.data,
            "grads": {name: p.grad.clone() for name, p in layer.named_parameters()},
            "route": (expert, place, kept, weight), "dropped": int(layer.dropped),
            "offset": layer.expert_offset}


def draws(opts) -> dict:
    """This rank's first host draw of a step and its default generator's first
    draw after the device set-up."""
    from cvnets_tpu_torch.engine.train_state import AUGMENT_STREAM, step_rng
    from cvnets_tpu_torch.utils.common_utils import device_setup

    device_setup(opts, "cpu")
    return {"host": int(step_rng(0, 3, AUGMENT_STREAM).integers(1 << 30)),
            "device": float(torch.rand(1))}


# -------------------------------------------------------------- the parent
def vit_inputs(args=SGD_ARGS, batch: int = 8) -> dict:
    """The micro ViT's perturbed JAX variables, the port's state dict of them,
    the SGD step's batch and the AdamW steps' batches, LRs and flags."""
    from cvnets_tpu.models import get_model
    from cvnets_tpu_torch.optim.scheduler import build_scheduler
    from test_torch_train_step import STEP_ARGS
    from torch_port_helpers import both_opts, perturbed_variables, port_model_from

    rng = np.random.default_rng(7)
    opts_jax, opts_torch = both_opts(args)
    x0 = rng.integers(0, 256, (batch, 64, 64, 3)).astype(np.uint8)
    variables = perturbed_variables(get_model(opts_jax), x0[:2].astype(np.float32) / 255.0)
    adam_args = VIT_MICRO_ARGS + STEP_ARGS + ["--common.accum-freq", "2"]
    adam_torch = both_opts(adam_args)[1]
    return {"variables": variables,
            "state": port_model_from(opts_torch, variables).state_dict(),
            "sgd": {"args": args, "xs": [x0], "ys": [rng.integers(0, 13, (batch,))],
                    "lrs": [MP_SGD_LR]},
            "adamw": {"args": adam_args,
                      "xs": [rng.integers(0, 256, (2 * batch, 64, 64, 3)).astype(np.uint8)
                             for _ in range(3)],
                      "ys": [rng.integers(0, 13, (2 * batch,)) for _ in range(3)],
                      "lrs": [build_scheduler(adam_torch).retrieve_lr(0, i) for i in range(3)]}}


def moe_inputs() -> dict:
    """JAX's MoE layer on all the tokens (test_torch_moe's ``run_both``) at each
    capacity factor, with its parameters and tokens."""
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.modules import moe as jax_moe
    from test_torch_moe import D, E, F_DIM, K, CaptureCombine
    from torch_port_helpers import both_opts

    out = {}
    for cf in MOE_CFS:
        jm = jax_moe.MoEFFN(opts=both_opts(VIT_MICRO_ARGS)[0], embed_dim=D,
                            ffn_latent_dim=F_DIM, num_experts=E, top_k=K, capacity_factor=cf)
        x = np.random.default_rng(3).standard_normal((4, 10, D)).astype(np.float32)
        params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(3),
                                                            jnp.asarray(x))["params"])

        def loss_fn(p, xx, jm=jm):
            y, sown = jm.apply({"params": p}, xx, mutable=["moe_loss"])
            aux = sown["moe_loss"]["load_balance"][0]
            return (y ** 2).sum() + aux, (y, aux)

        capture = CaptureCombine()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_moe, "jnp", capture)
            jm.apply({"params": params}, jnp.asarray(x), mutable=["moe_loss"])
        (_, (y, aux)), (g, gx) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
            params, jnp.asarray(x))
        out[cf] = {"x": x, "params": params, "y": np.asarray(y), "aux": float(aux),
                   "grads": jax.tree_util.tree_map(np.asarray, g), "gx": np.asarray(gx),
                   "combine": capture.combine}
    return out


def run_ranks(module, world: int, tmp, data: dict, jax_work=None):
    """``module._rank_main`` in ``world`` gloo ranks on ``data``, ``jax_work()``
    while they run; the ranks' results and its."""
    from torch_port_helpers import torch_threads

    torch.save(data, tmp / "inputs.pt")
    with torch_threads(2):
        ranks = mp_spawn(module._rank_main, world, (str(tmp / "store"), str(tmp / "inputs.pt"),
                                                     str(tmp)))
        extra = jax_work() if jax_work is not None else None
        ranks.join()
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)], extra


def jax_steps(vit: dict) -> dict:
    """JAX's SGD step and AdamW steps on the global batches."""
    from test_torch_distributed import _jax_trajectory

    return {name: _jax_trajectory({**vit[name], "variables": vit["variables"]})
            for name in ("sgd", "adamw")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp")
    vit = vit_inputs()
    moe = moe_inputs()
    data = {"state": vit["state"], "sgd": vit["sgd"], "adamw": vit["adamw"],
            "moe": {cf: {k: moe[cf][k] for k in ("x", "params")} for cf in MOE_CFS}}
    ranks, jax_runs = run_ranks(sys.modules[__name__], WORLD, tmp, data,
                                lambda: jax_steps(vit))
    return {"ranks": ranks, "jax": jax_runs, "vit": vit, "moe": moe}


# ----------------------------------------------------------------- checks
def check_sgd_step(runs, data: int, model: int) -> None:
    """One SGD step against JAX's: every rank's whole parameters, the global
    loss, and the clip's global norm."""
    from torch_port_helpers import assert_sgd_step_matches

    state, jloss, jnorm = runs["jax"]["sgd"][0]
    loss = mp_global_loss([r["sgd"] for r in runs["ranks"]], 0, data, model)
    for r in runs["ranks"]:
        sd, _, _, norm = r["sgd"]["steps"][0]
        assert norm == pytest.approx(jnorm, rel=1e-4)
        assert norm > 1.0  # the clip at 1 scaled the step
        assert_sgd_step_matches(sd, state, loss, jloss)


def check_adamw_steps(runs, data: int, model: int) -> None:
    """test_torch_distributed's first-step and three-step checks."""
    from test_torch_train_step import _check_three_steps

    ranks = [r["adamw"] for r in runs["ranks"]]
    for r in ranks[1:]:  # every rank gathers the same whole state
        for (sd0, ema0, _, n0), (sd1, ema1, _, n1) in zip(ranks[0]["steps"], r["steps"]):
            assert n0 == n1
            for key, value in sd0.items():
                assert torch.equal(value, sd1[key]), key
    torch_side = [(sd, ema, mp_global_loss(ranks, i, data, model), norm)
                  for i, (sd, ema, _, norm) in enumerate(ranks[0]["steps"])]
    (state, jloss, jnorm), (sd, ema_sd, loss, norm) = runs["jax"]["adamw"][0], torch_side[0]
    lr = runs["vit"]["adamw"]["lrs"][0]
    assert loss == pytest.approx(jloss, abs=1e-5)
    assert norm == pytest.approx(jnorm, rel=2e-3)
    for key, want, got in mp_pairs(state.batch_stats, sd):
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 * np.abs(want).max(),
                                   err_msg=key)
    diffs = np.concatenate([np.abs(got - want).ravel()
                            for _, want, got in mp_pairs(state.params, sd)])
    assert diffs.max() <= 2.001 * lr and np.mean(diffs > 1e-2 * lr) < 0.01
    diffs = np.concatenate([np.abs(got - want).ravel()
                            for _, want, got in mp_pairs(state.ema_params, ema_sd)])
    assert diffs.max() <= 0.201 * lr and np.mean(diffs > 1e-3 * lr) < 0.01
    _check_three_steps({"lrs": runs["vit"]["adamw"]["lrs"], "jax": runs["jax"]["adamw"],
                        "torch": torch_side})


def expected_shapes(state_dict: dict, data: int, model: int, fsdp: bool) -> dict:
    """Each parameter's block shape on a rank, by the JAX rules as the JAX
    package states them (largest divisible dim of its own layout, ties to
    its trailing dim; the model axis's column/row rules)."""
    from cvnets_tpu_torch.parallel.sharding_rules import leaf_spec

    out = {}
    for name, t in state_dict.items():
        if name.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        spec = leaf_spec(name, tuple(t.shape), data, model, fsdp)
        shape = list(t.shape)
        if spec.model_dim is not None:
            shape[spec.model_dim] //= model
        if spec.data_dim is not None:
            shape[spec.data_dim] //= data
        out[name] = tuple(shape)
    return out


def check_shards(runs, data: int, model: int, fsdp: bool) -> None:
    """The blocks after the steps: the rules' shapes, the moments' shapes the
    blocks', and less state than one process holds."""
    state = runs["vit"]["state"]
    want = expected_shapes(state, data, model, fsdp)
    whole = sum(t.numel() * t.element_size() for k, t in state.items() if k in want)
    for r in runs["ranks"]:
        got = r["adamw"]
        assert got["shapes"] == want
        assert got["moments"] == {k: v for k, v in want.items() if k in got["moments"]}
        assert len(got["moments"]) == len(want)
        sharded = [k for k in want if want[k] != tuple(state[k].shape)]
        assert sharded, "no leaf is sharded"
        # parameters, two moments and the EMA: 4 copies of the whole, less the shards
        assert got["bytes"] < 4 * whole
        assert got["bytes"] == 4 * sum(
            int(np.prod(want[k])) * state[k].element_size() for k in want)


MOE_REL = 2e-6


def check_moe(runs, cf: float, data: int, model: int) -> None:
    from test_torch_moe import E

    from cvnets_tpu_torch.utils.jax_params import to_torch_layout

    rel = MOE_REL

    want = runs["moe"][cf]
    n = want["x"].shape[0] // data
    for rank, r in enumerate(runs["ranks"]):
        got = r["moe"][cf]
        d, m = rank // model, rank % model
        expert, place, kept, weight = got["route"]
        wrong = []
        for t in range(want["combine"].shape[0]):  # the global routing, on every rank
            jax_pairs = {(int(e), int(c)): float(want["combine"][t, e, c])
                         for e, c in zip(*np.nonzero(want["combine"][t]))}
            port_pairs = {(int(expert[t, k]), int(place[t, k])): float(weight[t, k].detach())
                          for k in range(expert.shape[1]) if kept[t, k]}
            if set(jax_pairs) != set(port_pairs) or any(
                    abs(jax_pairs[p] - port_pairs[p]) > 1e-6 for p in jax_pairs):
                wrong.append(t)
        assert not wrong, f"rank {rank}: tokens routed otherwise than JAX's: {wrong}"
        assert (got["dropped"] > 0) == (cf < 1)
        assert got["aux"] == pytest.approx(want["aux"], abs=1e-6)
        y = want["y"][d * n:(d + 1) * n]
        np.testing.assert_allclose(got["y"].numpy(), y, rtol=0,
                                   atol=rel * np.abs(want["y"]).max())
        gx = want["gx"][d * n:(d + 1) * n]
        np.testing.assert_allclose(got["gx"].numpy(), gx, rtol=0,
                                   atol=rel * np.abs(want["gx"]).max())
        g = want["grads"]
        leaves = {"router.weight": to_torch_layout(("router", "kernel"), g["router"]["kernel"]),
                  **{k: g[k] for k in ("experts_fc1", "experts_fc1_bias", "experts_fc2",
                                       "experts_fc2_bias")}}
        gmax = max(float(np.abs(v).max()) for v in leaves.values())
        share = E // model if E % model == 0 else E
        assert got["offset"] == (m * share if model > 1 else 0)
        for name, ref in leaves.items():
            part = ref[got["offset"]:got["offset"] + share] if model > 1 else ref
            np.testing.assert_allclose(got["grads"][name].numpy(), part, rtol=0,
                                       atol=rel * gmax, err_msg=f"rank {rank} {name}")


# ----------------------------------------------------------------- tests
def test_fsdp_sgd_step_with_the_clip_matches_jax_on_the_global_batch(runs):
    check_sgd_step(runs, WORLD, 1)


def test_fsdp_adamw_steps_with_ema_and_accumulation_match_jax(runs):
    check_adamw_steps(runs, WORLD, 1)


def test_fsdp_keeps_each_ranks_shards_after_the_steps(runs):
    check_shards(runs, WORLD, 1, fsdp=True)


@pytest.mark.parametrize("cf", MOE_CFS, ids=["drops", "no_drops"])
def test_moe_routes_the_global_batch_as_jax_at_grid_2_1(runs, cf):
    check_moe(runs, cf, WORLD, 1)


def test_data_ranks_draw_differently(runs):
    a, b = (r["draws"] for r in runs["ranks"])
    assert a["host"] != b["host"] and a["device"] != b["device"]
