"""The port's whole (data, model) grid at (2, 2): FSDP over the data axis with
tensor and expert parallelism over the model axis, and the ring under
``--dev.sequence-parallel``, held against the JAX package on the CPU: four
gloo processes, each data pair on its half of every batch.

One spawn of four ranks (over a ``file://`` store, with a timeout) runs every
port computation of this file, with test_torch_fsdp's bounds:

* the micro ViT's SGD step with the clip, and its AdamW steps with EMA and
  accumulation, under ``--dev.fsdp`` against JAX's steps on the global batch;
* the blocks after the steps: a leaf that both axes shard keeps a quarter
  (its model dim halved by the column/row rule, its largest free dim by the
  FSDP rule), its moments the same;
* the SGD step of the micro ViT without its CLS token under ``--dev.fsdp
  --dev.sequence-parallel``: the ring on each data pair's rows;
* MoE: each model rank holds 2 of the 4 experts and its data pair's rows;
  the global routing, the load-balance loss, the outputs and the gradients
  (each rank's experts' share) against JAX's layer;
* the draws: the ranks of a model group alike, the data pairs apart.
"""

from __future__ import annotations

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_fsdp import (  # noqa: E402
    MOE_CFS,
    SGD_ARGS,
    check_adamw_steps,
    check_moe,
    check_sgd_step,
    check_shards,
    draws,
    jax_steps,
    moe_inputs,
    moe_rank,
    run_ranks,
    vit_inputs,
)
from torch_port_helpers import MP_SGD_LR, mp_grid_opts, mp_init, mp_steps  # noqa: E402

WORLD = 4
SHAPE = [2, 2]
SP_ARGS = SGD_ARGS + ["--model.classification.vit.no-cls-token"]


def _rank_main(index: int, store: str, inputs: str, out_dir: str) -> None:
    from cvnets_tpu_torch.parallel import mesh

    mp_init(index, WORLD, store)
    try:
        data = torch.load(inputs, weights_only=False)
        torch.save(_suite(data), os.path.join(out_dir, f"rank{index}.pt"))
    finally:
        mesh.destroy_group()


def _suite(data: dict) -> dict:
    sgd, adam, sp = data["sgd"], data["adamw"], data["sp"]
    opts = mp_grid_opts(SGD_ARGS, SHAPE, ["--dev.fsdp"])
    out = {"sgd": mp_steps(opts, data["state"], sgd["xs"], sgd["ys"], sgd["lrs"])}
    opts.__dict__.update(vars(mp_opts(adam["args"])))
    out["adamw"] = mp_steps(opts, data["state"], adam["xs"], adam["ys"], adam["lrs"], accum=2)
    opts.__dict__.update(vars(mp_opts(SP_ARGS, ["--dev.sequence-parallel"])))
    out["sp"] = mp_steps(opts, sp["state"], sp["xs"], sp["ys"], [MP_SGD_LR])
    out["moe"] = {cf: moe_rank(data["moe"][cf], cf) for cf in MOE_CFS}
    out["draws"] = draws(opts)
    return out


def mp_opts(args, extra=()):
    """The options of ``args`` on this file's grid, without forming it again."""
    from cvnets_tpu_torch.options.opts import get_training_arguments

    return get_training_arguments(args=list(args) + ["--dev.mesh-shape", *map(str, SHAPE),
                                                     "--dev.fsdp", *extra])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("grid")
    vit, sp, moe = vit_inputs(), vit_inputs(SP_ARGS), moe_inputs()
    data = {"state": vit["state"], "sgd": vit["sgd"], "adamw": vit["adamw"],
            "sp": {"state": sp["state"], "xs": sp["sgd"]["xs"], "ys": sp["sgd"]["ys"]},
            "moe": {cf: {k: moe[cf][k] for k in ("x", "params")} for cf in MOE_CFS}}

    def jax_work():
        from test_torch_distributed import _jax_trajectory

        return {**jax_steps(vit),
                "sp": _jax_trajectory({**sp["sgd"], "variables": sp["variables"]})}

    ranks, jax_runs = run_ranks(sys.modules[__name__], WORLD, tmp, data, jax_work)
    return {"ranks": ranks, "jax": jax_runs, "vit": vit, "moe": moe}


def test_fsdp_and_tp_sgd_step_with_the_clip_matches_jax(runs):
    check_sgd_step(runs, 2, 2)


def test_fsdp_and_tp_adamw_steps_with_ema_and_accumulation_match_jax(runs):
    check_adamw_steps(runs, 2, 2)


def test_fsdp_and_tp_keep_each_ranks_shards_after_the_steps(runs):
    check_shards(runs, 2, 2, fsdp=True)
    shapes = runs["ranks"][0]["adamw"]["shapes"]
    # (192, 64): the model axis halves the outputs, FSDP the inputs (JAX's (64, 192)
    # has its model dim on 192 and its largest free dim, 64, takes data)
    assert shapes["transformer_0.mha.qkv_proj.weight"] == (96, 32)


def test_sequence_parallel_step_on_the_grid_matches_jax(runs):
    from torch_port_helpers import assert_sgd_step_matches, mp_global_loss

    state, jloss, jnorm = runs["jax"]["sp"][0]
    loss = mp_global_loss([r["sp"] for r in runs["ranks"]], 0, 2, 2)
    for r in runs["ranks"]:
        sd, _, _, norm = r["sp"]["steps"][0]
        assert norm == pytest.approx(jnorm, rel=1e-4)
        assert_sgd_step_matches(sd, state, loss, jloss)


@pytest.mark.parametrize("cf", MOE_CFS, ids=["drops", "no_drops"])
def test_moe_expert_parallel_routes_the_global_batch_as_jax_at_grid_2_2(runs, cf):
    check_moe(runs, cf, 2, 2)


def test_draws_follow_the_data_index(runs):
    d = [r["draws"] for r in runs["ranks"]]
    assert d[0] == d[1] and d[2] == d[3]
    assert d[0]["host"] != d[2]["host"] and d[0]["device"] != d[2]["device"]
