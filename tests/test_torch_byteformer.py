"""The port's ByteFormer against the JAX package's, on the CPU, on the same
weights (``load_jax_params``) and the same seeded inputs:

* the positional table's "slice" mode (first rows, and the resampled table past
  its length), learnable and sinusoidal;
* token merging (an odd count, a masked run, a row masked whole) and its mask;
* ``window_partition_1d`` / ``window_reverse_1d`` / ``windows_shift_mask``
  (padding and a shift, and the round trip), ``WindowedTransformerEncoder``
  with and without ``--model.classification.byteformer.mask-windowed-attn``;
* a micro ByteFormer (E 64, 2 layers of 4 heads of D = 16, a head dim the MHA
  kernels take, so the port's windows take the fused route) with windows of
  32, a shift, token merging and padded rows: eval logits and the grads of
  every parameter against JAX's ``model.apply``, with and without the
  masks, and the route each layer takes; AudioByteFormer built from
  byteformer_wav.yaml's options;
* the AdamW decay groups against JAX's rank > 1 mask.

The JAX MHA runs as it runs on the CPU (its off-TPU reference). Float32 on
both sides: the same math in another order, held at 1e-5 (modules) and 1e-4
of max(1, |logit|) (the model); grads at 5e-4 of the largest grad.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_port_helpers import (  # noqa: E402
    assert_grads_match,
    both_opts,
    perturbed_variables,
    torch_threads,
)

# the micro ByteFormer: ViT's micro widths, windows of 32 (shift 16 on the odd
# layer), conv 4 / stride 2, token merging after layer 0, 7 classes
MICRO_ARGS = [
    "--model.classification.name", "byteformer",
    "--model.classification.n-classes", "7",
    "--model.classification.byteformer.mode", "micro",
    "--model.classification.byteformer.window-sizes", "32",
    "--model.classification.byteformer.conv-kernel-size", "4",
    "--model.classification.byteformer.downsample", "true", "false",
    "--model.activation.name", "gelu",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--dataset.category", "classification",
]
MASKED = ["--model.classification.byteformer.mask-windowed-attn"]
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def tokens(seed: int = 0, batch: int = 3, n: int = 256) -> np.ndarray:
    """Seeded bytes padded with -1: row 1 from 200, row 2 from 40 (a run of
    padding windows), as the collate pads to a bucket."""
    x = np.random.default_rng(seed).integers(0, 256, (batch, n)).astype(np.int32)
    x[1, 200:] = -1
    if batch > 2:
        x[2, 40:] = -1
    return x


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


# ------------------------------------------------------------- the modules

@pytest.mark.parametrize("learnable", [True, False], ids=["learnable", "sinusoidal"])
@pytest.mark.parametrize("seq", [5, 16, 20])
def test_sliced_positional_table_matches_jax(seq, learnable):
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.layers.positional_embedding import PositionalEmbedding as JaxPE
    from cvnets_tpu_torch.layers.positional_embedding import PositionalEmbedding

    x = np.random.default_rng(seq).standard_normal((2, seq, 8)).astype(np.float32)
    jmod = JaxPE(num_embeddings=16, embedding_dim=8, is_learnable=learnable,
                 resize_mode="slice")
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jmod.apply(variables, jnp.asarray(x))
    port = PositionalEmbedding(16, 8, is_learnable=learnable, resize_mode="slice")
    if learnable:
        port.pos_embed.data.copy_(torch.from_numpy(
            np.asarray(variables["params"]["pos_embed"])))
    _close(port(torch.from_numpy(x)).detach(), want)
    if seq <= 16:  # the first rows, untouched
        table = port.pos_embed if learnable else port.table
        _close(port(torch.zeros(1, seq, 8)).detach()[0], table.detach()[:seq], 0)


def test_token_merging_matches_jax_with_an_odd_count_and_masked_runs():
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.layers.token_merging import TokenMerging as JaxTM
    from cvnets_tpu.models.classification.byteformer import ByteFormerTokenMerging as JaxBTM
    from cvnets_tpu_torch.layers.token_merging import TokenMerging
    from cvnets_tpu_torch.models.classification.byteformer import ByteFormerTokenMerging
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    opts_jax, _ = both_opts(MICRO_ARGS)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 7, 8)).astype(np.float32)
    mask = np.zeros((3, 7), bool)
    mask[0, 4:] = True   # a masked run reaching the padded end
    mask[1, 1:3] = True  # a run inside one merged pair and across another
    mask[2] = True       # a row masked whole
    jmod = JaxBTM(opts=opts_jax, dim=8)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
        a.shape).astype(np.float32), variables["params"])
    want_x, want_mask = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    port = ByteFormerTokenMerging(8)
    load_jax_params(port, params)
    got_x, got_mask = port(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got_x.detach(), want_x)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert got_mask.tolist() == [[False, False, True, True], [False, False, False, False],
                                 [True] * 4]

    jplain = JaxTM(opts=opts_jax, dim=8)
    pv = jplain.init(jax.random.PRNGKey(1), jnp.asarray(x))
    plain = TokenMerging(8)
    load_jax_params(plain, pv["params"])
    _close(plain(torch.from_numpy(x)).detach(), jplain.apply(pv, jnp.asarray(x)))


@pytest.mark.parametrize("n,window,shift", [(45, 16, 5), (48, 16, 8), (10, 16, 0)])
def test_window_partition_reverse_and_shift_mask_match_jax(n, window, shift):
    import jax.numpy as jnp

    from cvnets_tpu.modules import windowed_transformer as J
    from cvnets_tpu_torch.modules import windowed_transformer as P

    x = np.random.default_rng(n).standard_normal((2, n, 4)).astype(np.float32)
    w = min(window, n)
    want, want_pad = J.window_partition_1d(jnp.asarray(x), w, shift)
    got, n_pad = P.window_partition_1d(torch.from_numpy(x), w, shift)
    assert n_pad == want_pad == n + (-n) % w
    _close(got, want, 0)
    back = P.window_reverse_1d(got, 2, n, w, shift)
    _close(back, J.window_reverse_1d(want, 2, n, w, shift), 0)
    _close(back, x, 0)  # the round trip
    if shift:
        np.testing.assert_array_equal(P.windows_shift_mask(n_pad, w, shift).numpy(),
                                      np.asarray(J.windows_shift_mask(n_pad, w, shift)))


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "mask_windowed_attn"])
@pytest.mark.parametrize("shift", [0, 8])
def test_windowed_transformer_encoder_matches_jax(shift, masked):
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.modules.windowed_transformer import (
        WindowedTransformerEncoder as JaxWTE,
    )
    from cvnets_tpu_torch.modules.windowed_transformer import WindowedTransformerEncoder
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    opts_jax, opts = both_opts(MICRO_ARGS + (MASKED if masked else []))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 45, 32)).astype(np.float32)
    mask = np.zeros((2, 45), bool)
    mask[1, 20:] = True  # windows of padding, one whole
    kwargs = dict(embed_dim=32, ffn_latent_dim=64, num_heads=2, window_size=16,
                  window_shift=shift)
    jmod = JaxWTE(opts=opts_jax, **kwargs)
    variables = perturbed_variables(jmod, x, init_kwargs={"key_padding_mask": jnp.asarray(mask),
                                                          "training": False})
    want = jmod.apply(variables, jnp.asarray(x), key_padding_mask=jnp.asarray(mask))
    port = WindowedTransformerEncoder(opts, **kwargs).eval()
    load_jax_params(port, variables["params"])
    got = port(torch.from_numpy(x), key_padding_mask=torch.from_numpy(mask))
    _close(got.detach(), want)


# ------------------------------------------------------------- the model

def _jax_model(opts_jax, x):
    from cvnets_tpu.models import get_model as jax_get_model

    jmodel = jax_get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    params = dict(variables["params"])
    # logits of a few units, so that a wrong token shows above the tolerance
    params["classifier"] = {**params["classifier"],
                            "kernel": params["classifier"]["kernel"] * 50.0}
    return jmodel, {**variables, "params": params}


def _jax_logits_and_grads(jmodel, variables, x, y):
    import jax
    import jax.numpy as jnp

    xj, yj = jnp.asarray(x), jnp.asarray(y)
    logits = jax.jit(lambda v: jmodel.apply(v, xj, training=False))(variables)

    def loss_fn(params):
        out = jmodel.apply({**variables, "params": params}, xj, training=True,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        logp = jax.nn.log_softmax(out, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, yj[:, None], axis=-1))

    grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    return np.asarray(logits), jax.tree_util.tree_map(np.asarray, grads)


def _port_logits_and_grads(opts, variables, x, y):
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    model = get_model(opts, device="cpu")
    load_jax_params(model, variables["params"])
    with torch.no_grad():
        logits = model.eval()(torch.from_numpy(x)).numpy()
    out = model.train()(torch.from_numpy(x))
    torch.nn.functional.cross_entropy(out, torch.from_numpy(y).long()).backward()
    return logits, {k: p.grad for k, p in model.named_parameters()}, model


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "mask_windowed_attn"])
def test_micro_byteformer_logits_and_grads_match_jax(masked, monkeypatch):
    """Every parameter's grad, the logits, and the route: the windows of both
    layers take the fused kernel's route by default (D = 16, no mask); with
    the masks, the unshifted layer takes it with the key-padding mask and the
    shifted one (an additive mask) the einsum route."""
    import cvnets_tpu_torch.layers.multi_head_attention as mha_layer

    opts_jax, opts = both_opts(MICRO_ARGS + (MASKED if masked else []))
    x = tokens()
    y = np.array([1, 4, 6], np.int64)
    jmodel, variables = _jax_model(opts_jax, x)
    want_logits, want_grads = _jax_logits_and_grads(jmodel, variables, x, y)

    fused, masks = mha_layer.fused_mha_attention, []

    def counted(q, k, v, heads, key_mask=None):
        masks.append(key_mask is not None)
        return fused(q, k, v, heads, key_mask)

    monkeypatch.setattr(mha_layer, "fused_mha_attention", counted)
    logits, grads, model = _port_logits_and_grads(opts, variables, x, y)
    scale = max(1.0, float(np.abs(want_logits).max()))
    assert scale > 1.0
    np.testing.assert_allclose(logits, want_logits, rtol=0, atol=1e-4 * scale)
    assert_grads_match(grads, want_grads)
    # eval and train forwards: two layers each
    assert masks == ([True] * 2 if masked else [False, False] * 2)
    assert model.downsample_after == [True, False]


def test_the_padded_length_changes_the_logits_as_in_jax():
    """Pinned 2: padding tokens embed as the mask token and take part in
    attention, so the same bytes padded to the bucket of 256 and to 512 give
    other logits, in JAX and in the port alike; the collate pads to JAX's
    bucket for that reason."""
    import jax
    import jax.numpy as jnp

    opts_jax, opts = both_opts(MICRO_ARGS)
    x = tokens(batch=2, n=256)
    longer = np.full((2, 512), -1, np.int32)
    longer[:, :256] = x
    jmodel, variables = _jax_model(opts_jax, x)
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    model = get_model(opts, device="cpu").eval()
    load_jax_params(model, variables["params"])
    got = {}
    for t in (x, longer):
        want = np.asarray(jax.jit(lambda v: jmodel.apply(v, jnp.asarray(t)))(variables))
        with torch.no_grad():
            got[t.shape[1]] = model(torch.from_numpy(t)).numpy()
        np.testing.assert_allclose(got[t.shape[1]], want, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(want).max())))
    assert np.abs(got[256] - got[512]).max() > 1e-2


def test_audio_byteformer_from_the_wav_yaml_matches_jax():
    from cvnets_tpu.models import get_model as jax_get_model
    from cvnets_tpu.options.opts import get_training_arguments as jax_args
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.models.classification.byteformer import AudioByteFormer
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    import jax
    import jax.numpy as jnp

    args = ["--common.config-file",
            os.path.join(REPO, "config/audio_classification/speech_commands/byteformer_wav.yaml"),
            "--common.override-kwargs", "model.classification.byteformer.mode=micro",
            "common.mixed_precision=false"]  # float32 on both sides
    opts_jax, opts = jax_args(args=args), get_training_arguments(args=args)
    assert getattr(opts, "dataset.category") == "audio_classification"
    x = tokens(seed=1, batch=2, n=512)
    jmodel = jax_get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    want = jax.jit(lambda v: jmodel.apply(v, jnp.asarray(x)))(variables)
    model = get_model(opts, device="cpu")
    assert type(model) is AudioByteFormer
    load_jax_params(model, variables["params"])
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.shape == (2, 35)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(want).max())))


def test_adamw_decay_groups_are_the_jax_rank_rule():
    """The embedding, positional and conv tables and every Linear decay; biases
    and norms do not: the JAX ``_decay_mask`` (rank > 1) on the same tree."""
    import jax

    from cvnets_tpu.models import get_model as jax_get_model
    from cvnets_tpu.optim import _decay_mask
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import param_groups
    from cvnets_tpu_torch.utils.jax_params import torch_key

    opts_jax, opts = both_opts(MICRO_ARGS)
    x = tokens()
    variables = jax.eval_shape(lambda: jax_get_model(opts_jax).init(
        jax.random.PRNGKey(0), jax.numpy.asarray(x)))
    mask = _decay_mask(variables["params"])
    want = {torch_key(tuple(p.key for p in path)) for path, leaf in
            jax.tree_util.tree_flatten_with_path(mask)[0] if leaf}
    model = get_model(opts, device="cpu")
    names = {id(p): k for k, p in model.named_parameters()}
    groups = param_groups(model, 0.05, True)
    got = {names[id(p)] for g in groups if g["weight_decay"] > 0 for p in g["params"]}
    assert got == want
    assert {"token_embedding", "pos_embed.pos_embed", "token_reduction.weight"} <= got
    assert not any(k.endswith(".bias") or "norm" in k for k in got)
