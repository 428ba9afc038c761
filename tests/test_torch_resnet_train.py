"""ResNet in the PyTorch port against the JAX package, beyond one forward:
the output-stride 8 and 16 features of the dilated encoder, a 3-step SGD
trajectory of ResNet-18 at resnet.yaml's optimizer, and the stochastic-depth
schedule and drop semantics. float32 on the CPU; each test states its
tolerance."""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from test_torch_resnet import _args  # noqa: E402
from torch_port_helpers import (  # noqa: E402
    CONV_FAMILY_ARGS,
    assert_end_points_match,
    both_opts,
    flat_leaves,
    nchw,
    perturbed_variables,
    port_model_from,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """torch on two threads: the suite's xdist workers share the cores."""
    with torch_threads(2):
        yield


@pytest.mark.parametrize("variant,output_stride", [("se_resnet18", 8), ("resnet50", 16)])
def test_output_stride_features_match(variant, output_stride):
    """The tap points of the dilated encoder, as DeepLabv3 reads them, at 64 px
    in train mode, and the spatial sizes and dilations of the output stride."""
    model, got = assert_end_points_match(_args(variant), "resnet", output_stride)
    side = 64 // output_stride
    assert [got[f"out_l{i}"].shape[-1] for i in range(1, 6)] == [16, 16, 8, side, side]
    dilations = [b.conv2.conv.dilation[0] for b in model.layer_5]
    assert dilations == [32 // output_stride] * len(dilations)


# resnet.yaml's optimizer: SGD with momentum 0.9 and weight decay 1e-4 on every
# tensor (no_decay_bn_filter_bias false), label smoothing 0.1, no EMA and no
# clip; the yaml's warmup (from 0.05 over 7,500 iterations to a cosine from 0.4)
SGD_ARGS = [
    "--optim.name", "sgd",
    "--optim.sgd.momentum", "0.9",
    "--optim.weight-decay", "1e-4",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "150",
    "--scheduler.warmup-iterations", "7500",
    "--scheduler.warmup-init-lr", "0.05",
    "--scheduler.cosine.max-lr", "0.4",
    "--scheduler.cosine.min-lr", "2e-4",
]
N_STEPS, STEP_BATCH = 3, 8


class _LossAndNorm:
    """JAX metric object that hands the step's loss and grad norm back."""

    def batch_values(self, prediction, targets, extras):
        return extras["loss"], extras["grad_norm"]


@pytest.fixture(scope="module")
def sgd_runs():
    """Three steps of ResNet-18 in both packages' train steps from one
    perturbed state on one list of uint8 batches."""
    from cvnets_tpu.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu.loss import build_loss_fn
    from cvnets_tpu.models import get_model
    from cvnets_tpu.optim import build_optimizer
    from cvnets_tpu_torch.engine import train_state as port
    from cvnets_tpu_torch.loss import build_loss_fn as port_loss
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.optim import build_optimizer as port_optimizer
    from cvnets_tpu_torch.optim.scheduler import build_scheduler

    opts_jax, opts_torch = both_opts(_args("resnet18") + SGD_ARGS)
    assert not getattr(opts_torch, "optim.no_decay_bn_filter_bias")
    rng = np.random.default_rng(0)
    xs = [rng.integers(0, 256, (STEP_BATCH, 64, 64, 3)).astype(np.uint8)
          for _ in range(N_STEPS)]
    ys = [rng.integers(0, 13, (STEP_BATCH,)) for _ in range(N_STEPS)]
    lrs = [build_scheduler(opts_torch).retrieve_lr(0, i) for i in range(N_STEPS)]

    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, xs[0].astype(np.float32) / 255.0)
    tx = build_optimizer(opts_jax)
    state = create_train_state(jmodel, tx, jax.random.PRNGKey(0),
                               {"samples": jnp.zeros((1, 64, 64, 3))}, ema_enabled=False)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = state.replace(params=params, opt_state=tx.init(params),
                          batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                                             variables["batch_stats"]))
    jstep = jax.jit(make_train_step(jmodel, build_loss_fn(opts_jax), tx, opts_jax,
                                    {"out": _LossAndNorm()}))
    model = port_model_from(opts_torch, variables)
    optimizer = port_optimizer(opts_torch, model)
    assert [g["weight_decay"] for g in optimizer.param_groups] == [1e-4]
    tstate = port.create_train_state(model, optimizer, ema_enabled=False)
    tstep = port.make_train_step(model, port_loss(opts_torch), opts_torch,
                                 build_metrics(opts_torch, ["loss", "grad_norm"]))
    out = {"lrs": lrs, "jax": [], "torch": []}
    for i in range(N_STEPS):
        state, metrics = jstep(state, {"samples": jnp.asarray(xs[i]),
                                       "targets": jnp.asarray(ys[i])},
                               lrs[i], jax.random.PRNGKey(0))
        tstate, tmetrics = tstep(tstate, {"samples": nchw(xs[i]),
                                          "targets": torch.from_numpy(ys[i])}, lrs[i])
        out["jax"].append((jax.tree_util.tree_map(np.asarray, state.params),
                           jax.tree_util.tree_map(np.asarray, state.batch_stats),
                           *[float(v) for v in metrics["out"]]))
        out["torch"].append(({k: v.clone() for k, v in model.state_dict().items()},
                             tmetrics["loss"]["loss"][0].item(),
                             tmetrics["grad_norm"]["grad_norm"][0].item()))
    return out


def _param_diffs(params, state):
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    return {torch_key(p): np.abs(state[torch_key(p)].numpy() - to_torch_layout(p, v)).max()
            for p, v in flat_leaves(params)}


def test_three_sgd_steps_at_the_resnet_yaml_optimizer_stay_close_to_jax(sgd_runs):
    """An SGD step moves an element by lr·(g + 1e-4·p) plus momentum, so the two
    packages' params part by lr times their grads' f32 difference, which
    batch-statistic BN amplifies (5e-4 of the largest grad at one state, the
    bound above). Measured here: see the bounds' comments."""
    lrs = sgd_runs["lrs"]
    assert lrs[0] == pytest.approx(0.05)
    for i, ((_, _, jloss, jnorm), (_, loss, norm)) in enumerate(zip(sgd_runs["jax"],
                                                                    sgd_runs["torch"])):
        assert loss == pytest.approx(jloss, abs=1e-3), f"step {i}"
        assert norm == pytest.approx(jnorm, rel=1e-2), f"step {i}"
    params, stats, _, _ = sgd_runs["jax"][0]
    state = sgd_runs["torch"][0][0]
    assert max(_param_diffs(params, state).values()) <= 1e-3 * lrs[0]
    params, stats, _, _ = sgd_runs["jax"][-1]
    state = sgd_runs["torch"][-1][0]
    assert max(_param_diffs(params, state).values()) <= 1e-2 * sum(lrs)
    for path, leaf in flat_leaves(stats):
        from cvnets_tpu_torch.utils.jax_params import torch_key

        np.testing.assert_allclose(state[torch_key(path)].numpy(), leaf, rtol=0,
                                   atol=1e-3 * max(1.0, float(np.abs(leaf).max())),
                                   err_msg=torch_key(path))


@pytest.mark.parametrize("depth,sd_prob", [(18, 0.1), (50, 0.2), (101, 0.05)])
def test_stochastic_depth_schedule_is_the_jax_one(depth, sd_prob):
    """Each block's drop probability grows linearly over all blocks, as JAX's
    (read from the bound flax blocks)."""
    from cvnets_tpu.models import get_model as jax_model
    from cvnets_tpu_torch.models import get_model

    args = _args("resnet18")[:-len(CONV_FAMILY_ARGS)] + [
        "--model.classification.resnet.depth", str(depth),
        "--model.classification.resnet.stochastic-depth-prob", str(sd_prob),
        *CONV_FAMILY_ARGS]
    opts_jax, opts_torch = both_opts(args)
    model = get_model(opts_torch, device="cpu")
    got = [b.stochastic_depth.p if b.stochastic_depth is not None else 0.0
           for i in range(2, 6) for b in getattr(model, f"layer_{i}")]
    jmodel = jax_model(opts_jax).bind({})
    jmodel.setup()
    want = [b.stochastic_depth_prob for i in range(2, 6) for b in getattr(jmodel, f"layer_{i}")]
    assert got == want
    assert got[0] == 0.0 and got[-1] == pytest.approx(sd_prob) and len(got) > 2


def test_stochastic_depth_drops_whole_rows_of_the_residual_branch():
    """In training a block with drop probability p gives, for each row, either
    act(x + branch / (1 - p)) or act(shortcut) alone; over 2,000 rows the kept
    share is within 4 standard deviations of 1 - p. In eval it is the block
    without the draw."""
    from cvnets_tpu_torch.modules.resnet_modules import BasicResNetBlock
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=[])
    p = 0.3
    block = BasicResNetBlock(opts, 4, 4, 4, stochastic_depth_prob=p).train()
    x = torch.randn(2000, 4, 3, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        branch = block.conv2(block.conv1(x))
        kept = torch.relu(x + branch / (1 - p))
        dropped = torch.relu(x)
        out = block(x)
        is_kept = (out - kept).flatten(1).abs().amax(1) <= 1e-5
        is_dropped = (out - dropped).flatten(1).abs().amax(1) <= 1e-6
        assert bool((is_kept ^ is_dropped).all())
        share = is_kept.double().mean().item()
        assert abs(share - (1 - p)) <= 4 * (p * (1 - p) / 2000) ** 0.5
        block.eval()
        assert torch.allclose(block(x), torch.relu(x + block.conv2(block.conv1(x))))
