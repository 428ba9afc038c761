"""ViT in the PyTorch port against the JAX package on the same weights: the micro
ViT (E = 64, 2 blocks, 4 heads of D = 16, GELU, BN in the conv stem) at 64 px,
batch 2, 13 classes, float32 on the CPU. Logits in eval and train mode, the stem's
BN running statistics after one train forward, every parameter gradient of the
label-smoothed CE loss (the positional table and the CLS token included), the
MHA layer's kernel and einsum routes, the positional-table resampling, and the
ViT yaml's flags."""

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
    VIT_MICRO_ARGS,
    both_opts,
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
VIT_YAML = os.path.join(REPO, "config/classification/imagenet/vit.yaml")

# f32 on both sides; sums run in another order (XLA vs ATen): measured ~1e-6
LOGIT_ATOL = 1e-4


def _pair(extra=()):
    from cvnets_tpu.models import get_model

    opts_jax, opts_torch = both_opts(VIT_MICRO_ARGS + [
        "--loss.classification.cross-entropy.label-smoothing", "0.1", *extra])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    return dict(x=x, y=np.array([3, 11]), jmodel=jmodel, variables=variables,
                tmodel=port_model_from(opts_torch, variables), opts_jax=opts_jax,
                opts_torch=opts_torch)


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_eval_logits_match(pair):
    ref = pair["jmodel"].apply(pair["variables"], jnp.asarray(pair["x"]), training=False)
    model = pair["tmodel"].eval()
    with torch.no_grad():
        out = model(nchw(pair["x"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL, rtol=0)


def test_sinusoidal_table_and_mean_pooling_match():
    """The sinusoidal table is no flax leaf: the port keeps it out of state_dict,
    so the loader fills the model from the flax tree alone; without a CLS token
    the embedding is the token mean."""
    p = _pair(["--model.classification.vit.sinusoidal-pos-emb",
               "--model.classification.vit.no-cls-token"])
    assert "pos_embed" not in p["variables"]["params"]
    assert "cls_token" not in p["variables"]["params"]
    ref = p["jmodel"].apply(p["variables"], jnp.asarray(p["x"]), training=False)
    with torch.no_grad():
        out = p["tmodel"].eval()(nchw(p["x"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL, rtol=0)


def test_train_logits_and_bn_stats_match(pair):
    from cvnets_tpu_torch.utils.jax_params import torch_key

    ref, new_vars = pair["jmodel"].apply(
        pair["variables"], jnp.asarray(pair["x"]), training=True,
        mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
    model = port_model_from(pair["opts_torch"], pair["variables"]).train()
    with torch.no_grad():
        out = model(nchw(pair["x"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL, rtol=0)
    state = model.state_dict()
    stats = jax.tree_util.tree_flatten_with_path(new_vars["batch_stats"])[0]
    assert len(stats) == 4  # mean and var of the two stem BNs
    for path, leaf in stats:
        key = torch_key(tuple(p.key for p in path))
        leaf = np.asarray(leaf)
        # one momentum-0.1 update of batch statistics over 2·16·16 and 2·8·8
        # positions: f32 sums in another order, ~1e-7 of the largest entry
        np.testing.assert_allclose(state[key].numpy(), leaf, rtol=0,
                                   atol=1e-5 * float(np.abs(leaf).max()), err_msg=key)


def test_param_grads_match(pair):
    from cvnets_tpu.loss import build_loss_fn as jax_loss
    from cvnets_tpu_torch.loss import build_loss_fn as torch_loss
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    variables, x, y = pair["variables"], jnp.asarray(pair["x"]), jnp.asarray(pair["y"])
    jcrit = jax_loss(pair["opts_jax"])

    def loss_fn(params):
        pred, _ = pair["jmodel"].apply(
            {**variables, "params": params}, x, training=True,
            mutable=["batch_stats"], rngs={"dropout": jax.random.PRNGKey(0)})
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
    assert {"pos_embed.pos_embed", "cls_token"} <= keys
    # the stem's batch-statistic BNs amplify the f32 noise in proportion to the
    # largest upstream grads (see test_torch_mobilevit_v2); two BNs here
    gmax = max(float(np.abs(np.asarray(g)).max()) for _, g in flat)
    for path, g in flat:
        path = tuple(p.key for p in path)
        g = to_torch_layout(path, np.asarray(g))
        np.testing.assert_allclose(named[torch_key(path)].grad.numpy(), g, rtol=0,
                                   atol=5e-4 * gmax, err_msg="/".join(path))


@pytest.mark.parametrize("route", ["kernel_key_padding", "einsum_attn_mask",
                                   "einsum_cross_attention"])
def test_mha_layer_matches_jax(route):
    """The layer takes the fused route with a key-padding mask (-1e30, one batch
    element fully padded) and the einsum route with an additive attn_mask or
    with keys from another sequence (finfo.min padding there)."""
    from cvnets_tpu.layers.multi_head_attention import MultiHeadAttention as JaxMHA
    from cvnets_tpu_torch.layers.multi_head_attention import MultiHeadAttention
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    opts_jax, opts_torch = both_opts(VIT_MICRO_ARGS)
    rng = np.random.default_rng(7)
    b, s, e, h = 3, 13, 32, 2
    x = rng.standard_normal((b, s, e)).astype(np.float32)
    x_kv = rng.standard_normal((b, 9, e)).astype(np.float32)
    pad = rng.random((b, s)) < 0.3
    pad[1] = True
    kwargs = {"kernel_key_padding": dict(key_padding_mask=pad),
              "einsum_attn_mask": dict(attn_mask=np.triu(np.full((s, s), -1e9, np.float32), 1)),
              "einsum_cross_attention": dict(x_kv=x_kv, key_padding_mask=pad[:, :9])}[route]

    jmha = JaxMHA(opts=opts_jax, embed_dim=e, num_heads=h)
    params = jmha.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + 0.1 * rng.standard_normal(p.shape).astype(np.float32), params)
    ref = jmha.apply({"params": params}, jnp.asarray(x),
                     **{k: jnp.asarray(v) for k, v in kwargs.items()})

    mha = MultiHeadAttention(opts_torch, e, h).eval()
    load_jax_params(mha, jax.tree_util.tree_map(np.asarray, params))
    with torch.no_grad():
        out = mha(torch.from_numpy(x), **{k: torch.from_numpy(v) for k, v in kwargs.items()})
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def test_conv_layer_with_layer_norm_matches_jax():
    """A conv followed by layer_norm normalises each position over its channels
    (the JAX trailing-axis LayerNorm in NHWC) and keeps its bias."""
    from cvnets_tpu.layers.conv_layer import ConvLayer2d as JaxConv
    from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    opts_jax, opts_torch = both_opts(["--model.normalization.name", "layer_norm",
                                      "--model.activation.name", "gelu"])
    x = np.random.default_rng(1).standard_normal((2, 9, 9, 4)).astype(np.float32)
    jconv = JaxConv(opts=opts_jax, out_channels=6, kernel_size=3, stride=2)
    variables = perturbed_variables(jconv, x, seed=1)
    assert "bias" in variables["params"]["conv"]
    ref = jconv.apply(variables, jnp.asarray(x), training=True)
    conv = ConvLayer2d(opts_torch, 4, 6, kernel_size=3, stride=2)
    load_jax_params(conv, variables["params"])
    with torch.no_grad():
        out = conv(nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("src,dst", [(196, 16), (196, 196), (196, 400), (16, 5), (7, 13)])
def test_interpolate_pos_embed_matches_jax(src, dst):
    from cvnets_tpu.layers.positional_embedding import _sinusoidal_table
    from cvnets_tpu.layers.positional_embedding import interpolate_pos_embed as jax_interp
    from cvnets_tpu_torch.layers.positional_embedding import (
        interpolate_pos_embed,
        sinusoidal_table,
    )

    table = np.random.default_rng(src).standard_normal((src, 8)).astype(np.float32)
    np.testing.assert_allclose(interpolate_pos_embed(torch.from_numpy(table), dst).numpy(),
                               np.asarray(jax_interp(jnp.asarray(table), dst)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(sinusoidal_table(src, 8).numpy(),
                               np.asarray(_sinusoidal_table(src, 8)), atol=1e-6, rtol=0)


def test_vit_yaml_parses_to_the_same_values():
    from cvnets_tpu.options.opts import get_training_arguments as jax_args
    from cvnets_tpu_torch.options.opts import get_training_arguments as torch_args

    args = ["--common.config-file", VIT_YAML]
    jax_opts, torch_opts = jax_args(args=args), torch_args(args=args)
    for dest, value in vars(torch_opts).items():
        assert getattr(jax_opts, dest) == value, dest
    assert getattr(torch_opts, "model.classification.vit.mode") == "base"
    assert getattr(torch_opts, "model.activation.name") == "gelu"
    assert getattr(torch_opts, "optim.weight_decay") == 0.2
    assert getattr(torch_opts, "common.grad_clip") == 1.0


def test_chip_smoke_vit_flags_are_the_yaml_settings():
    """Every value chip_smoke.py's VIT_ARGS set is the one vit.yaml gives, except
    the crop size, which the yaml sets on the variable-batch sampler, and it sets
    all the yaml gives but the data path's settings (dataset, sampler,
    transforms and augmentation), which the bare train steps do not read."""
    sys.path.insert(0, REPO)
    from chip_smoke import VIT_ARGS
    from cvnets_tpu_torch.options.opts import get_training_arguments

    default = vars(get_training_arguments(args=[]))
    flags = vars(get_training_arguments(args=VIT_ARGS))
    yaml = vars(get_training_arguments(args=["--common.config-file", VIT_YAML]))
    set_by_flags = {k for k, v in flags.items() if v != default[k]}
    assert {"optim.weight_decay", "common.grad_clip", "ema.momentum",
            "model.activation.name"} <= set_by_flags
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


@pytest.mark.parametrize("flag", [
    ["--model.classification.vit.moe-num-experts", "4"],
    ["--model.classification.vit.use-simple-fpn",
     "--model.classification.vit.moe-num-experts", "2"],
])
def test_unported_options_raise(flag):
    """MoE blocks raised here until they were ported
    (``modules/moe.py``, tests/test_torch_moe.py); now the flag builds them,
    with and without the simple FPN: every second block is an MoE block of
    that many experts."""
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.modules.moe import MoETransformerEncoder
    from cvnets_tpu_torch.options.opts import get_training_arguments

    model = get_model(get_training_arguments(args=VIT_MICRO_ARGS + flag), device="cpu")
    blocks = [getattr(model, f"transformer_{i}") for i in range(model.n_layers)]
    assert [isinstance(b, MoETransformerEncoder) for b in blocks] == [False, True]
    assert blocks[1].moe_ffn.num_experts == int(flag[-1])


def test_stochastic_depth_matches_jax_in_eval_and_drops_rows_in_train():
    """--model.classification.vit.stochastic-dropout 0.1: each block's p grows
    linearly to 0.1 (the second of two blocks has it), eval mode is the JAX
    function, and train mode drops whole rows of a branch, so its output moves
    off the eval output (the drop masks come from another generator than
    JAX's, so train mode is not compared with JAX)."""
    p = _pair(["--model.classification.vit.stochastic-dropout", "0.1"])
    model = p["tmodel"]
    assert [getattr(model, f"transformer_{i}").stochastic_depth.p for i in range(2)] == [0.0, 0.1]
    ref = p["jmodel"].apply(p["variables"], jnp.asarray(p["x"]), training=False)
    with torch.no_grad():
        out = model.eval()(nchw(p["x"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=LOGIT_ATOL, rtol=0)
    # BN's batch statistics also change train mode: compare two train passes
    # with p = 0.1 and with the layers' p set to 0 on the same input
    torch.manual_seed(3)
    x = torch.from_numpy(np.concatenate([p["x"]] * 8))  # 16 rows: some drop
    with torch.no_grad():
        dropped = model.train()(nchw(x.numpy()))
        for i in range(2):
            getattr(model, f"transformer_{i}").stochastic_depth.p = 0.0
        kept = model.train()(nchw(x.numpy()))
    assert not torch.allclose(dropped, kept)


def test_no_cls_token_above_512_tokens_matches_jax():
    """At 512 px the stem gives S = 1024 tokens (no CLS token): the long-sequence
    range, which the layer sends to the fused route (the plain version on the
    CPU) and JAX to attn_core_long, here in interpret mode and through its
    reference. The 196-entry positional table is resampled to 1024."""
    import cvnets_tpu.ops.pallas.mha_attn as M
    from cvnets_tpu.models import get_model
    from cvnets_tpu_torch.ops.mha_attention import fused_attention_eligible

    opts_jax, opts_torch = both_opts(VIT_MICRO_ARGS + ["--model.classification.vit.no-cls-token"])
    x = np.random.default_rng(9).standard_normal((1, 512, 512, 3)).astype(np.float32)
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    model = port_model_from(opts_torch, variables).eval()
    assert fused_attention_eligible(1024, 64, 4)
    with torch.no_grad():
        out = model(nchw(x)).numpy()
    for interpret in (False, True):
        try:
            M._INTERPRET = interpret
            ref = jmodel.apply(variables, jnp.asarray(x), training=False)
        finally:
            M._INTERPRET = False
        np.testing.assert_allclose(out, np.asarray(ref), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"interpret={interpret}")
