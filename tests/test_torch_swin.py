"""Swin in the PyTorch port against the JAX package on the same weights: the micro
Swin (embed 48, one pair of blocks a stage, heads 3/6/12/24 of D = 16, window 7,
GELU), batch 2, 13 classes, float32 on the CPU, at 224 px (stages 1-3 shift,
stage 4's 7×7 map is one window and never shifts) and at 112 px (stage 3 is one
window, stage 4 pads 4 → 7 and its shift is off). Every block takes the fused
window-attention route (its plain version on the CPU). Logits in eval and train
mode and every parameter gradient of the label-smoothed CE loss; the static
relative-position index and shift mask; PatchMerging's channel order; the
window-attention layer through the fused route and the einsum route against the
JAX layer; StochasticDepth; the flags that raise; ``get_model``'s device; and
chip_smoke.py's Swin flags against swin.yaml."""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    SWIN_MICRO_ARGS,
    SWIN_MICRO_MODE,
    both_opts,
    micro_swin_modes,
    nchw,
    perturbed_variables,
    port_model_from,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """torch on two threads: the suite's xdist workers share the cores."""
    from torch_port_helpers import torch_threads

    with torch_threads(2):
        yield


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWIN_YAML = os.path.join(REPO, "config/classification/imagenet/swin.yaml")
SIZES = (224, 112)

# f32 on both sides, the sums in another order (XLA vs ATen) through 8 blocks
# and 3 merges of LayerNorm'd tokens: ~1e-6 measured
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _micro_mode():
    with micro_swin_modes():
        yield


def _pair(size: int, extra=()):
    from cvnets_tpu.models import get_model

    opts_jax, opts_torch = both_opts(SWIN_MICRO_ARGS + [
        "--loss.classification.cross-entropy.label-smoothing", "0.1", *extra])
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    return dict(x=x, y=np.array([3, 11]), jmodel=jmodel, variables=variables,
                tmodel=port_model_from(opts_torch, variables), opts_jax=opts_jax,
                opts_torch=opts_torch)


@pytest.fixture(scope="module", params=SIZES, ids=[f"{s}px" for s in SIZES])
def pair(request):
    return _pair(request.param)


def test_the_sizes_cover_shift_and_padding(pair):
    """224: every stage's padded map is a whole number of windows and stages 1-3
    shift; 112: stage 3 is one window (no shift) and stage 4 pads 4 → 7."""
    model = pair["tmodel"]
    ep = model.extract_end_points_all(nchw(pair["x"]))
    sides = [ep[f"out_l{i}"].shape[1] for i in range(2, 6)]
    assert sides == ([56, 28, 14, 7] if pair["x"].shape[1] == 224 else [28, 14, 7, 4])
    assert all(ep[k].shape[-1] == SWIN_MICRO_MODE[0] * 2 ** (i - 2) for i, k in
               enumerate([f"out_l{j}" for j in range(2, 6)], start=2))


def test_eval_logits_match(pair, monkeypatch):
    """Every one of the 8 blocks reaches the fused window-attention entry."""
    from cvnets_tpu_torch.modules import swin_transformer_block

    calls = []
    fused = swin_transformer_block.fused_window_attention
    monkeypatch.setattr(swin_transformer_block, "fused_window_attention",
                        lambda *args: calls.append(args) or fused(*args))
    ref = pair["jmodel"].apply(pair["variables"], jnp.asarray(pair["x"]), training=False)
    with torch.no_grad():
        out = pair["tmodel"].eval()(nchw(pair["x"]))
    assert len(calls) == 8
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL, rtol=0)


def test_train_logits_match(pair):
    """Train mode with stochastic depth and dropout at 0: the same function."""
    ref = pair["jmodel"].apply(pair["variables"], jnp.asarray(pair["x"]), training=True,
                               rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        out = pair["tmodel"].train()(nchw(pair["x"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL, rtol=0)


def test_param_grads_match(pair):
    from cvnets_tpu.loss import build_loss_fn as jax_loss
    from cvnets_tpu_torch.loss import build_loss_fn as torch_loss
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    variables, x, y = pair["variables"], jnp.asarray(pair["x"]), jnp.asarray(pair["y"])
    jcrit = jax_loss(pair["opts_jax"])

    def loss_fn(params):
        pred = pair["jmodel"].apply({**variables, "params": params}, x, training=True,
                                    rngs={"dropout": jax.random.PRNGKey(0)})
        return jcrit(x, pred, y, training=True)

    jloss, jgrads = jax.value_and_grad(loss_fn)(variables["params"])

    model = port_model_from(pair["opts_torch"], variables).train()
    loss = torch_loss(pair["opts_torch"])(None, model(nchw(pair["x"])),
                                          torch.from_numpy(pair["y"]), training=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5)

    named = dict(model.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat) == len(named)
    keys = {torch_key(tuple(p.key for p in path)) for path, _ in flat}
    assert "stage0_block1.attn.relative_position_bias_table" in keys
    # no batch statistics in Swin: the f32 noise of two summation orders, ~1e-7
    # of the largest grad measured
    gmax = max(float(np.abs(np.asarray(g)).max()) for _, g in flat)
    for path, g in flat:
        path = tuple(p.key for p in path)
        g = to_torch_layout(path, np.asarray(g))
        np.testing.assert_allclose(named[torch_key(path)].grad.numpy(), g, rtol=0,
                                   atol=1e-5 * gmax, err_msg="/".join(path))


@pytest.mark.parametrize("h,w,ws,shift", [(56, 56, 7, 3), (28, 28, 7, 3), (14, 14, 7, 3),
                                          (35, 21, 7, 3), (16, 16, 8, 4)])
def test_static_index_and_shift_mask_equal_jax(h, w, ws, shift):
    from cvnets_tpu.modules import swin_transformer_block as J
    from cvnets_tpu_torch.modules import swin_transformer_block as P

    np.testing.assert_array_equal(P.relative_position_index(ws), J.relative_position_index(ws))
    mask = P.shifted_window_mask(h, w, ws, shift)
    np.testing.assert_array_equal(mask, J.shifted_window_mask(h, w, ws, shift))
    assert mask.dtype == np.float32 and set(np.unique(mask)) == {-100.0, 0.0}


def test_window_partition_and_reverse_equal_jax():
    from cvnets_tpu.modules import swin_transformer_block as J
    from cvnets_tpu_torch.modules import swin_transformer_block as P

    x = np.random.default_rng(2).standard_normal((2, 14, 21, 5)).astype(np.float32)
    win = P.window_partition(torch.from_numpy(x), 7)
    np.testing.assert_array_equal(win.numpy(), np.asarray(J.window_partition(jnp.asarray(x), 7)))
    np.testing.assert_array_equal(P.window_reverse(win, 7, 14, 21).numpy(), x)


@pytest.mark.parametrize("side", [6, 7])  # even, and odd (padded by one)
def test_patch_merging_matches_jax(side):
    """The concat order [x(0,0), x(1,0), x(0,1), x(1,1)]: the first C channels
    of the merged token come from the even row and column, the next C from the
    odd row; then LayerNorm and the bias-free reduction, against JAX."""
    from cvnets_tpu.modules.swin_transformer_block import PatchMerging as JaxMerge
    from cvnets_tpu_torch.modules.swin_transformer_block import PatchMerging
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    opts_jax, opts_torch = both_opts(SWIN_MICRO_ARGS)
    x = np.random.default_rng(side).standard_normal((2, side, side, 4)).astype(np.float32)
    jmerge = JaxMerge(opts=opts_jax, dim=4)
    variables = perturbed_variables(jmerge, x)
    merge = PatchMerging(opts_torch, 4)
    load_jax_params(merge, variables["params"])
    with torch.no_grad():
        out = merge(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jmerge.apply(variables, jnp.asarray(x))),
                               atol=1e-5, rtol=0)
    # the order itself, with the norm and the reduction left out
    merge.norm, merge.reduction = torch.nn.Identity(), torch.nn.Identity()
    cat = merge(torch.from_numpy(x))
    np.testing.assert_array_equal(cat[:, 0, 0].numpy(), np.concatenate(
        [x[:, 0, 0], x[:, 1, 0], x[:, 0, 1], x[:, 1, 1]], axis=-1))


@pytest.mark.parametrize("shift", [0, 3], ids=["w_msa", "sw_msa"])
@pytest.mark.parametrize("use_kernel", [True, False], ids=["fused_route", "einsum_route"])
def test_block_matches_jax(use_kernel, shift, monkeypatch):
    """One SwinTransformerBlock at 14×14, 48 channels in 3 heads of 16 (a head
    dim the fused route takes), through the port's fused route (the plain
    window attention on the CPU) and its einsum route, against the JAX block
    (its einsum route off the TPU): output and every parameter grad."""
    from cvnets_tpu.modules.swin_transformer_block import SwinTransformerBlock as JaxBlock
    from cvnets_tpu_torch.modules import swin_transformer_block
    from cvnets_tpu_torch.modules.swin_transformer_block import SwinTransformerBlock
    from cvnets_tpu_torch.utils.jax_params import load_jax_params, to_torch_layout, torch_key

    calls = []
    fused = swin_transformer_block.fused_window_attention
    monkeypatch.setattr(swin_transformer_block, "fused_window_attention",
                        lambda *args: calls.append(args) or fused(*args))
    opts_jax, opts_torch = both_opts(SWIN_MICRO_ARGS)
    rng = np.random.default_rng(shift)
    x = rng.standard_normal((2, 14, 14, 48)).astype(np.float32)
    w = rng.standard_normal((2, 14, 14, 48)).astype(np.float32)
    jblock = JaxBlock(opts=opts_jax, dim=48, num_heads=3, window_size=7, shift_size=shift)
    variables = perturbed_variables(jblock, x)

    def loss(params):
        return jnp.sum(jblock.apply({"params": params}, jnp.asarray(x)) * w)

    ref = jblock.apply(variables, jnp.asarray(x))
    jgrads = jax.grad(loss)(variables["params"])

    block = SwinTransformerBlock(opts_torch, 48, 3, window_size=7, shift_size=shift)
    load_jax_params(block, variables["params"])
    block.attn.use_kernel = use_kernel
    out = block(torch.from_numpy(x))
    (out * torch.from_numpy(w)).sum().backward()
    assert len(calls) == (1 if use_kernel else 0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    named = dict(block.named_parameters())
    for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        path = tuple(p.key for p in path)
        g = to_torch_layout(path, np.asarray(g))
        np.testing.assert_allclose(named[torch_key(path)].grad.numpy(), g, rtol=1e-4,
                                   atol=1e-4, err_msg="/".join(path))


def test_stochastic_depth_is_identity_in_eval_and_at_zero():
    from cvnets_tpu_torch.layers.random_layers import StochasticDepth

    x = torch.randn(5, 3, 4)
    assert StochasticDepth(0.5).eval()(x) is x
    assert StochasticDepth(0.0).train()(x) is x


def test_stochastic_depth_drops_rows_and_rescales_from_a_seeded_generator():
    """Each batch row is all 0 or all x / keep; the draws follow the generator
    alone, and the kept share is Bernoulli(keep) (4000 rows: std 0.007)."""
    from cvnets_tpu_torch.layers.random_layers import StochasticDepth

    x = torch.rand(4000, 3, 5) + 0.5
    outs = []
    for _ in range(2):
        layer = StochasticDepth(0.3, generator=torch.Generator().manual_seed(7)).train()
        outs.append(layer(x))
    assert torch.equal(outs[0], outs[1])
    kept = (outs[0] != 0).flatten(1)
    assert bool((kept.all(1) | (~kept).all(1)).all())  # whole rows
    rows = kept.all(1)
    torch.testing.assert_close(outs[0][rows], x[rows] / 0.7)
    assert abs(rows.float().mean().item() - 0.7) < 0.03
    # another seed, other rows
    other = StochasticDepth(0.3, generator=torch.Generator().manual_seed(8)).train()(x)
    assert not torch.equal(other, outs[0])


def test_swin_stochastic_depth_schedule_and_train_mode_drops():
    """p grows linearly to stochastic_depth_prob over all blocks, as in JAX; in
    train mode the model's output then moves off its eval output."""
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=SWIN_MICRO_ARGS + [
        "--model.classification.swin.stochastic-depth-prob", "0.5"])
    model = get_model(opts, device="cpu")
    probs = [getattr(model, f"stage{s}_block{b}").stochastic_depth.p
             for s in range(4) for b in range(2)]
    np.testing.assert_allclose(probs, [0.5 * i / 7 for i in range(8)])
    x = torch.rand(4, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    torch.manual_seed(0)
    with torch.no_grad():
        assert not torch.allclose(model.train()(x), model.eval()(x))


@pytest.mark.parametrize("option", ["norm_layer", "int8_inference"])
def test_unported_options_raise(option):
    """A norm layer other than layer_norm is an error in JAX too; int8 Dense
    layers are not ported (the port's parser has no such flag, so the option
    is set on the namespace as the JAX parser would set it)."""
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.utils.logger import LoggerError

    opts = get_training_arguments(args=SWIN_MICRO_ARGS)
    if option == "norm_layer":
        setattr(opts, "model.classification.swin.norm_layer", "batch_norm")
        error = LoggerError
    else:
        setattr(opts, "common.int8_inference", True)
        error = NotImplementedError
    with pytest.raises(error):
        get_model(opts, device="cpu")


def test_get_model_builds_on_the_card_unless_asked_for_the_cpu(monkeypatch):
    """No card: ``get_model(opts)`` raises instead of building on the CPU; with
    ``device="cpu"`` it builds, and one seed gives the same weights twice."""
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=SWIN_MICRO_ARGS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model(opts)
    a, b = get_model(opts, device="cpu"), get_model(opts, device="cpu")
    assert next(a.parameters()).device.type == "cpu"
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name


def test_init_draws_from_the_flax_distributions():
    """The bias table: flax truncated_normal(0.02), truncated at ±2 std; the
    patch conv: flax's default lecun_normal (std 1/sqrt(fan_in) after the
    truncation), not the yaml's conv init. Std estimates from n ≥ 1000 draws
    are within ~2.2%; the bound is 15%."""
    from cvnets_tpu.models import get_model as jax_model
    from cvnets_tpu_torch.models import get_model

    opts_jax, opts_torch = both_opts(SWIN_MICRO_ARGS)
    model = get_model(opts_torch, device="cpu")
    variables = jax.jit(lambda x: jax_model(opts_jax).init(
        {"params": jax.random.PRNGKey(0)}, x))(jnp.zeros((1, 64, 64, 3)))["params"]
    tables = np.concatenate([
        getattr(model, f"stage{s}_block{b}").attn.relative_position_bias_table
        .detach().numpy().ravel() for s in range(4) for b in range(2)])
    jtables = np.concatenate([np.asarray(variables[f"stage{s}_block{b}"]["attn"]
                                         ["relative_position_bias_table"]).ravel()
                              for s in range(4) for b in range(2)])
    # truncation points: 2 std of the underlying normal (0.02; sqrt(1/48) / 0.8796
    # for the 4·4·3 fan-in)
    for got, want, cut in ((tables, jtables, 0.04),
                           (model.patch_embed.weight.detach().numpy(),
                            np.asarray(variables["patch_embed"]["kernel"]),
                            2 * 48 ** -0.5 / 0.87962566)):
        assert abs(got.std() / want.std() - 1) < 0.15
        assert np.abs(got).max() <= cut * (1 + 1e-6)


def test_swin_yaml_parses_to_the_same_values():
    from cvnets_tpu.options.opts import get_training_arguments as jax_args
    from cvnets_tpu_torch.options.opts import get_training_arguments as torch_args

    args = ["--common.config-file", SWIN_YAML]
    jax_opts, torch_opts = jax_args(args=args), torch_args(args=args)
    for dest, value in vars(torch_opts).items():
        assert getattr(jax_opts, dest) == value, dest
    assert getattr(torch_opts, "model.classification.swin.mode") == "tiny"
    assert getattr(torch_opts, "model.classification.swin.stochastic_depth_prob") == 0.2
    assert getattr(torch_opts, "common.grad_clip") == 5.0


def test_chip_smoke_swin_flags_are_the_yaml_settings():
    """Every value chip_smoke.py's SWIN_ARGS set is the one swin.yaml gives, and
    nothing the yaml sets is left out but the data path's settings (dataset,
    sampler, transforms and augmentation), which the bare train steps do not
    read."""
    sys.path.insert(0, REPO)
    from chip_smoke import SWIN_ARGS
    from cvnets_tpu_torch.options.opts import get_training_arguments

    default = vars(get_training_arguments(args=[]))
    flags = vars(get_training_arguments(args=SWIN_ARGS))
    yaml = vars(get_training_arguments(args=["--common.config-file", SWIN_YAML]))
    set_by_flags = {k for k, v in flags.items() if v != default[k]}
    assert {"optim.weight_decay", "common.grad_clip", "ema.momentum",
            "model.classification.name"} <= set_by_flags
    for dest in sorted(set_by_flags - {"sampler.bs.crop_size_width",
                                       "sampler.bs.crop_size_height"}):
        assert flags[dest] == yaml[dest], dest
    # and nothing the yaml sets is left out, but the data path's settings
    data_path = ("image_augmentation.", "sampler.name", "sampler.vbs.", "dataset.root_",
                 "dataset.name", "dataset.workers", "dataset.prefetch_factor",
                 "dataset.eval_batch_size0")
    for dest, value in yaml.items():
        if (value != default[dest] and dest not in ("common.config_file", "taskname")
                and not dest.startswith(data_path)):
            assert flags[dest] == value, dest
