"""The port's MoE FFN (cvnets_tpu_torch/modules/moe.py) against the JAX
package's (cvnets_tpu/modules/moe.py) on the same weights and tokens,
float32 on the CPU.

* Routing. JAX's decisions are read from its own (T, E, C) combine tensor,
  captured from the einsum that consumes it in an eager run: each token's
  kept (expert, place) pairs and their weights. The port's index-form
  routing (``route``) must make the same decisions, drops included: the
  test names every token whose routing differs. Both routers run in
  float32 on the same ops (the JAX router is float32 whatever the compute
  dtype, so a float64 run is not open), and at the init's router scale
  some tokens' top two probabilities lie 4.2e-7 apart: the decisions still
  agree token for token.
* Outputs, the load-balance loss and the gradients of the tokens and of
  every leaf (the router's included), without drops (capacity factor 8) and
  with them (0.5: about half the second-choice rounds overflow).
* A micro ViT-MoE (E = 64, 2 blocks, the second one an MoE of 4 experts,
  top-2, capacity factor 1.25) through both packages' train steps with the
  load-balance loss at 0.01, as test_torch_train_step.py holds the dense
  ViT: the first step tightly, three steps within Adam's bounds.
* The optimizer's decay mask: the same decision for each leaf as JAX's
  ``_decay_mask`` (rank > 1), the 3-D expert biases decayed.

Tolerances: outputs to 1e-6 of their largest value and grads to 1e-6 of the
largest grad, the loss to 1e-6 (measured in a script: the outputs, the
loss and the grads differ by 1e-10 to 1e-8 on values of order 1; the
products are the same float32 ones in another order).
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import VIT_MICRO_ARGS, both_opts, torch_threads  # noqa: E402

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

E, K, D, F_DIM = 4, 2, 16, 32
MOE_ARGS = ["--model.classification.vit.moe-num-experts", "4",
            "--model.classification.vit.moe-top-k", "2",
            "--model.classification.vit.moe-capacity-factor", "1.25",
            "--model.classification.vit.moe-layer-period", "2"]
REL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def _opts():
    return both_opts(VIT_MICRO_ARGS)


class CaptureCombine:
    """The JAX module's ``jnp`` with its einsums recorded: the (T, E, C)
    combine tensor is the first operand of ``tec,ecd->td``."""

    def __init__(self) -> None:
        self.combine = None

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *operands, **kwargs):
        if spec == "tec,ecd->td":
            self.combine = np.asarray(operands[0])
        return jnp.einsum(spec, *operands, **kwargs)


def run_both(cf: float, seed: int = 0):
    from cvnets_tpu.modules import moe as jax_moe
    from cvnets_tpu_torch.modules.moe import MoEFFN

    opts_jax, opts_torch = _opts()
    jm = jax_moe.MoEFFN(opts=opts_jax, embed_dim=D, ffn_latent_dim=F_DIM, num_experts=E,
                        top_k=K, capacity_factor=cf)
    x = np.random.default_rng(seed).standard_normal((4, 10, D)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(seed),
                                                        jnp.asarray(x))["params"])

    def loss_fn(p, xx):
        y, sown = jm.apply({"params": p}, xx, mutable=["moe_loss"])
        aux = sown["moe_loss"]["load_balance"][0]
        return (y ** 2).sum() + aux, (y, aux)

    capture = CaptureCombine()
    with pytest.MonkeyPatch.context() as mp:  # an eager forward, its values concrete
        mp.setattr(jax_moe, "jnp", capture)
        jm.apply({"params": params}, jnp.asarray(x), mutable=["moe_loss"])
    (_, (y, aux)), (g, gx) = jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))

    model = MoEFFN(opts_torch, D, F_DIM, num_experts=E, top_k=K, capacity_factor=cf).train()
    with torch.no_grad():
        model.router.weight.copy_(torch.from_numpy(params["router"]["kernel"].T.copy()))
        for name in ("experts_fc1", "experts_fc1_bias", "experts_fc2", "experts_fc2_bias"):
            getattr(model, name).copy_(torch.from_numpy(params[name]))
    xt = torch.from_numpy(x).requires_grad_()
    yt = model(xt)
    ((yt ** 2).sum() + model.aux_loss).backward()
    jax_out = dict(y=np.asarray(y), aux=float(aux), grads=jax.tree_util.tree_map(np.asarray, g),
                   gx=np.asarray(gx), combine=capture.combine)
    return jax_out, dict(model=model, x=xt, y=yt.detach().numpy())


@pytest.fixture(scope="module", params=[8.0, 0.5], ids=["no_drops", "drops"])
def moe(request):
    return request.param, *run_both(request.param)


def test_routing_decisions_are_jaxs_token_for_token(moe):
    from cvnets_tpu_torch.modules.moe import capacity, route

    cf, want, got = moe
    model, x = got["model"], got["x"].detach()
    tokens = x.reshape(-1, D)
    cap = capacity(tokens.shape[0], E, K, cf)
    assert want["combine"].shape == (tokens.shape[0], E, cap)
    with torch.no_grad():
        probs = torch.softmax(model.router(tokens), dim=-1)
    expert, place, kept, weight, _ = route(probs, K, cap)
    n_dropped = int((~kept).sum())
    assert (n_dropped > 0) == (cf < 1)
    wrong = []
    for t in range(tokens.shape[0]):
        jax_pairs = {(int(e), int(c)): float(w) for e, c in zip(*np.nonzero(want["combine"][t]))
                     for w in [want["combine"][t, e, c]]}
        port_pairs = {(int(expert[t, r]), int(place[t, r])): float(weight[t, r])
                      for r in range(K) if kept[t, r]}
        if set(jax_pairs) != set(port_pairs) or any(
                abs(jax_pairs[p] - port_pairs[p]) > 1e-6 for p in jax_pairs):
            wrong.append((t, jax_pairs, port_pairs))
    assert not wrong, f"tokens routed differently (token, JAX, port): {wrong}"


def test_outputs_aux_loss_and_grads_match(moe):
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout

    _, want, got = moe
    model = got["model"]
    np.testing.assert_allclose(got["y"], want["y"], rtol=0, atol=REL * np.abs(want["y"]).max())
    assert model.aux_loss.item() == pytest.approx(want["aux"], abs=1e-6)
    g = want["grads"]
    leaves = {"router.weight": to_torch_layout(("router", "kernel"), g["router"]["kernel"]),
              **{n: g[n] for n in ("experts_fc1", "experts_fc1_bias", "experts_fc2",
                                   "experts_fc2_bias")}}
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(leaves)
    gmax = max(float(np.abs(v).max()) for v in leaves.values())
    for name, ref in leaves.items():
        np.testing.assert_allclose(named[name].grad.numpy(), ref, rtol=0, atol=REL * gmax,
                                   err_msg=name)
    np.testing.assert_allclose(got["x"].grad.numpy(), want["gx"], rtol=0,
                               atol=REL * np.abs(want["gx"]).max())


def test_eval_forward_leaves_no_aux_loss_and_the_capacity_is_the_whole_batchs():
    from cvnets_tpu_torch.modules.moe import MoEFFN, capacity

    _, opts_torch = _opts()
    model = MoEFFN(opts_torch, D, F_DIM, num_experts=E, top_k=K).eval()
    model(torch.zeros(2, 3, D))
    assert model.aux_loss is None
    # ViT-B/16-MoE at batch 128: T = 128 · 197 tokens share C = ceil(2 · T · 1.25 / 8)
    assert capacity(128 * 197, 8, 2, 1.25) == 7880
    assert capacity(3, 8, 1, 0.1) == 1 and capacity(3, 2, 2, 8.0) == 3


def test_decay_mask_is_jaxs_leaf_for_leaf():
    from cvnets_tpu.models import get_model as jax_model
    from cvnets_tpu.optim import _decay_mask
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import param_groups
    from cvnets_tpu_torch.utils.jax_params import torch_key

    opts_jax, opts_torch = both_opts(VIT_MICRO_ARGS + MOE_ARGS)
    jmodel = jax_model(opts_jax)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 64, 64, 3))))["params"]
    mask = {torch_key(tuple(p.key for p in path)): bool(m)
            for path, m in jax.tree_util.tree_flatten_with_path(_decay_mask(shapes))[0]}
    model = get_model(opts_torch, device="cpu")
    decayed = {id(p): group["weight_decay"] > 0
               for group in param_groups(model, 0.2, True) for p in group["params"]}
    got = {name: decayed[id(p)] for name, p in model.named_parameters()}
    assert got == mask
    assert got["transformer_1.moe_ffn.experts_fc1_bias"] and not got[
        "transformer_1.pre_norm_ffn.bias"]


@pytest.mark.parametrize("accum", [1, 2])
def test_vit_moe_train_step_with_the_aux_loss_matches_jax(accum):
    """Both packages' steps on the micro ViT-MoE (the load-balance loss at
    0.01, dropped tokens included); under ``--common.accum-freq 2`` each
    micro-batch routes with its own capacity and adds its own load-balance
    loss, as in JAX. The bounds are test_torch_train_step.py's."""
    from test_torch_train_step import STEP_ARGS, _check_first_step, _check_three_steps, \
        _trajectories

    runs = _trajectories(VIT_MICRO_ARGS + STEP_ARGS + MOE_ARGS
                         + ["--common.accum-freq", str(accum)])
    _check_first_step(runs)
    _check_three_steps(runs)


def test_chip_smoke_flags_are_the_yaml():
    """chip_smoke.py's ``VIT_MOE_ARGS`` parse to vit_moe.yaml's values but for
    its data roots (the card machine has no PyYAML)."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    from chip_smoke import VIT_MOE_ARGS, path_opts
    from torch_port_helpers import flags_differ_from_yaml

    assert flags_differ_from_yaml(path_opts(VIT_MOE_ARGS), os.path.join(
        repo, "config/classification/imagenet/vit_moe.yaml")) == [
        "common.config_file", "dataset.root_train", "dataset.root_val", "taskname"]
