"""The port's CLIP against the JAX package's, float32 on the CPU, on the same
perturbed flax variables and seeded inputs (``torch_clip_helpers``): a
micro MobileNetV2 (width 0.25) or the micro ViT under a 2-layer causal text
tower of width 64, context 16, vocab 100, projection 32.

* The conv-encoder CLIP: image and text embeddings, ``logit_scale``, the
  contrastive loss and every grad, with BN on its running statistics (eval
  mode; grads to 5e-5 of the largest, measured 4e-6) and on batch
  statistics (train mode; 5e-4, the bound of the conv families' tests,
  measured 1.5e-4); embeddings (unit vectors) to 1e-5 in eval mode and 1e-4
  in train mode (measured 5e-7 and 1.6e-5: batch statistics amplify the
  noise), the loss to 1e-5 and 1e-4 (measured 1e-7 and 2.4e-5).
* The text tower alone, on (B, L) ids and on (B, n_captions, L) ones folded,
  mean-pooled and normalized; ``zero_shot_image_logits`` (100 · cosine, to
  1e-3).
* The three projection heads.
* The ViT tower: the JAX CLIP never runs its ViT (its ``extract_features``
  is the conv stages'), so the port's image tower is held against a JAX ViT
  whose classifier is the identity (n_classes = E, kernel I, bias 0), the
  JAX ``global_pool_nchw2nc`` head after it; and it is pinned that the JAX
  CLIP-ViT tree has no ``image_encoder`` while the port's grads reach every
  ViT parameter.
* AdamW's decay mask and the towers' LR multipliers over the CLIP tree.
* Three AdamW steps of clip_vit.yaml's optimizer (β2 0.98, weight decay 0.2
  off rank ≤ 1, clip 1.0, EMA) against the JAX train step, held as
  tests/test_torch_train_step.py holds its models.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_clip_helpers import (  # noqa: E402
    CLIP_CONV_ARGS,
    CLIP_VIT_ARGS,
    EMBED,
    clip_inputs,
    jax_samples,
    port_samples,
)
from torch_port_helpers import (  # noqa: E402
    assert_grads_match,
    both_opts,
    flat_leaves,
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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def conv():
    """The JAX conv CLIP's outputs, loss and grads in eval and train mode, and
    its zero-shot logits against 10 class embeddings."""
    from cvnets_tpu.loss import build_loss_fn
    from cvnets_tpu.models import get_model

    opts_jax, opts_torch = both_opts(CLIP_CONV_ARGS)
    jmodel = get_model(opts_jax)
    samples = clip_inputs(0)
    variables = perturbed_variables(jmodel, jax_samples(samples))
    crit = build_loss_fn(opts_jax)
    classes = np.random.default_rng(1).standard_normal((10, EMBED)).astype(np.float32)
    classes /= np.linalg.norm(classes, axis=-1, keepdims=True)

    def loss_fn(params, training):
        pred, _ = jmodel.apply({**variables, "params": params}, jax_samples(samples),
                               training=training, mutable=["batch_stats"])
        return crit(None, pred, None, training=True)["total_loss"], pred

    @jax.jit
    def run(params):
        out = {}
        for mode, training in (("eval", False), ("train", True)):
            (loss, pred), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, training)
            out[mode] = {"loss": loss, "pred": pred, "grads": grads}
        out["zero_shot"] = jmodel.apply(
            {**variables, "params": params},
            {"image": jnp.asarray(samples["image"]), "text": jnp.asarray(classes)},
            training=False)["zero_shot_image_logits"]
        return out

    return {"opts": (opts_jax, opts_torch), "model": jmodel, "variables": variables,
            "samples": samples, "classes": classes, "jax": _np(run(variables["params"]))}


def _port_outputs(conv, mode: str):
    from cvnets_tpu_torch.loss import build_loss_fn

    opts_torch = conv["opts"][1]
    model = port_model_from(opts_torch, conv["variables"]).train(mode == "train")
    pred = model(port_samples(conv["samples"]))
    loss = build_loss_fn(opts_torch)(None, pred, None, training=True)
    loss["total_loss"].backward()
    return model, pred, loss


@pytest.mark.parametrize("mode,grad_rel,tol", [("eval", 5e-5, 1e-5), ("train", 5e-4, 1e-4)])
def test_conv_clip_embeddings_logit_scale_loss_and_grads_match_jax(conv, mode, grad_rel, tol):
    want = conv["jax"][mode]
    model, pred, loss = _port_outputs(conv, mode)
    for key in ("image", "text"):
        got = pred[key].detach().numpy()
        np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
        np.testing.assert_allclose(got, want["pred"][key], rtol=0, atol=tol, err_msg=key)
    assert pred["logit_scale"].item() == pytest.approx(float(want["pred"]["logit_scale"]),
                                                       rel=1e-6)
    assert pred["logit_scale"].item() == pytest.approx(1 / 0.07, rel=1e-6)
    assert loss["total_loss"].item() == pytest.approx(float(want["loss"]), abs=tol)
    assert loss["total_loss"].item() == pytest.approx(
        0.5 * (loss["image_loss"].item() + loss["text_loss"].item()), rel=1e-6)
    assert_grads_match({k: p.grad for k, p in model.named_parameters()}, want["grads"],
                       rel=grad_rel)


def test_loss_is_zero_outside_training_as_jax(conv):
    from cvnets_tpu.loss import build_loss_fn as jax_loss_fn
    from cvnets_tpu_torch.loss import build_loss_fn

    opts_jax, opts_torch = conv["opts"]
    pred = {k: torch.from_numpy(np.asarray(v)) for k, v in conv["jax"]["eval"]["pred"].items()}
    assert build_loss_fn(opts_torch)(None, pred, None, training=False).item() == 0.0
    assert float(jax_loss_fn(opts_jax)(None, conv["jax"]["eval"]["pred"], None,
                                       training=False)) == 0.0


def test_text_tower_and_its_caption_fold_match_jax(conv):
    jmodel, variables = conv["model"], conv["variables"]
    rng = np.random.default_rng(2)
    folded = np.stack([clip_inputs(s, batch=3)["text"] for s in (3, 4)])  # (2, 3, 16)
    flat = conv["samples"]["text"]

    @jax.jit
    def encode(text):
        return jmodel.apply(variables, text, training=False, method=jmodel.encode_text)

    model = port_model_from(conv["opts"][1], variables).eval()
    with torch.no_grad():
        for text in (flat, folded, rng.permutation(flat)):
            got = model.encode_text(torch.from_numpy(text)).numpy()
            want = np.asarray(encode(jnp.asarray(text, jnp.int32)))
            assert got.shape == (text.shape[0], EMBED)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        # the fold is the normalized mean of each caption's projected features
        each = model.text_encoder(torch.from_numpy(folded.reshape(6, -1))).reshape(2, 3, -1)
        mean = each.mean(dim=1)
        np.testing.assert_allclose(model.text_encoder(torch.from_numpy(folded)).numpy(),
                                   (mean / mean.norm(dim=-1, keepdim=True)).numpy(), atol=1e-6)


def test_zero_shot_image_logits_match_jax(conv):
    model = port_model_from(conv["opts"][1], conv["variables"]).eval()
    classes = torch.from_numpy(conv["classes"])
    with torch.no_grad():
        out = model({"image": nchw(conv["samples"]["image"]), "text": classes})
    want = conv["jax"]["zero_shot"]
    assert out["zero_shot_image_logits"].shape == (4, 10)
    np.testing.assert_allclose(out["zero_shot_image_logits"].numpy(), want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(out["zero_shot_image_logits"].numpy(),
                               100.0 * out["image"].numpy() @ conv["classes"].T, atol=1e-4)


@pytest.mark.parametrize("head", ["simple_projection_nc2nc", "global_pool_nchw2nc",
                                  "attention_pool_nchw2nc"])
def test_projection_heads_match_jax(head):
    from cvnets_tpu.models.multi_modal.image_projection import (
        IMAGE_PROJECTION_HEAD_REGISTRY as JAX_HEADS,
    )
    from cvnets_tpu_torch.models.multi_modal.image_projection import (
        IMAGE_PROJECTION_HEAD_REGISTRY,
    )
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    opts_jax, opts_torch = both_opts(CLIP_CONV_ARGS + [
        "--sampler.bs.crop-size-height", "96", "--sampler.bs.crop-size-width", "64"])
    x = np.random.default_rng(5).standard_normal(
        (3, 16) if head == "simple_projection_nc2nc" else (3, 3, 2, 16)).astype(np.float32)
    jhead = JAX_HEADS[head](opts=opts_jax, in_dim=16, out_dim=8)
    params = perturbed_variables(jhead, x)["params"]
    want = np.asarray(jax.jit(lambda p: jhead.apply({"params": p}, jnp.asarray(x)))(params))
    port = IMAGE_PROJECTION_HEAD_REGISTRY[head](opts_torch, in_dim=16, out_dim=8)
    load_jax_params(port, params)
    got = port(nchw(x) if x.ndim == 4 else torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if head == "global_pool_nchw2nc":  # a (B, C) input is only projected
        flat = torch.from_numpy(x.mean(axis=(1, 2)))
        np.testing.assert_allclose(port(flat).detach().numpy(), want, atol=1e-6)


@pytest.fixture(scope="module")
def vit():
    """The JAX CLIP-ViT tree, a JAX micro ViT whose classifier is the
    identity, the JAX head after it, and the port's CLIP-ViT filled from them."""
    from cvnets_tpu.models import get_model
    from cvnets_tpu.models.multi_modal.image_projection.heads import GlobalPool2D

    opts_jax, opts_torch = both_opts(CLIP_VIT_ARGS)
    samples = clip_inputs(6)
    clip_vars = perturbed_variables(get_model(opts_jax), jax_samples(samples))
    vit_opts, _ = both_opts(CLIP_VIT_ARGS + ["--dataset.category", "classification",
                                             "--model.classification.n-classes", "64"])
    jvit = get_model(vit_opts)
    vit_vars = perturbed_variables(jvit, samples["image"], seed=7)
    vit_vars["params"]["classifier"] = {"kernel": np.eye(64, dtype=np.float32),
                                        "bias": np.zeros(64, np.float32)}
    jhead = GlobalPool2D(opts=opts_jax, in_dim=64, out_dim=EMBED)
    head_params = perturbed_variables(jhead, np.zeros((1, 64), np.float32), seed=8)["params"]

    @jax.jit
    def image_tower(vparams, hparams, image):
        emb = jhead.apply({"params": hparams},
                          jvit.apply({**vit_vars, "params": vparams}, image, training=False))
        return emb / jnp.linalg.norm(emb, axis=-1, keepdims=True)

    want = np.asarray(image_tower(vit_vars["params"], head_params,
                                  jnp.asarray(samples["image"])))
    encoder = {k: v for k, v in vit_vars["params"].items() if k != "classifier"}
    params = {"image_encoder": encoder, "image_projection": head_params,
              "text_encoder": clip_vars["params"]["text_encoder"],
              "logit_scale": clip_vars["params"]["logit_scale"]}
    model = port_model_from(opts_torch, {"params": params, "batch_stats": {
        "image_encoder": vit_vars["batch_stats"]}})
    return {"clip_vars": clip_vars, "encoder": encoder, "model": model, "samples": samples,
            "want": want, "jvit": jvit, "vit_vars": vit_vars}


def test_vit_clip_image_tower_is_the_identity_classifier_jax_vit_and_head(vit):
    model = vit["model"].eval()
    with torch.no_grad():
        got = model.encode_image(nchw(vit["samples"]["image"])).numpy()
    np.testing.assert_allclose(got, vit["want"], rtol=0, atol=1e-5)


def test_jax_clip_vit_runs_no_vit_but_the_ports_grads_reach_every_vit_parameter(vit):
    """Pinned: the JAX CLIP over a ViT initialises no image encoder (the raw
    image is mean-pooled into a 3-channel projection); the port runs the ViT,
    and a contrastive step's grads reach each of its parameters."""
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.utils.jax_params import torch_key

    jax_params = vit["clip_vars"]["params"]
    assert "image_encoder" not in jax_params
    assert jax_params["image_projection"]["proj"].shape == (3, EMBED)
    model = vit["model"].train()
    assert not hasattr(model.image_encoder.classifier, "weight")  # no classifier to update
    pred = model(port_samples(vit["samples"]))
    build_loss_fn(both_opts(CLIP_VIT_ARGS)[1])(None, pred, None, training=True)[
        "total_loss"].backward()
    vit_keys = {"image_encoder." + torch_key(p) for p, _ in flat_leaves(vit["encoder"])}
    named = dict(model.named_parameters())
    assert {k for k in named if k.startswith("image_encoder.")} == vit_keys
    for key in vit_keys:
        assert named[key].grad is not None and named[key].grad.abs().max() > 0, key


def test_adamw_decay_mask_and_lr_multipliers_match_jax(conv):
    from cvnets_tpu.optim import _decay_mask
    from cvnets_tpu_torch.optim import param_groups
    from cvnets_tpu_torch.utils.jax_params import torch_key

    opts_jax, opts_torch = both_opts(CLIP_CONV_ARGS + [
        "--model.multi-modal-image-text.lr-multiplier-img-encoder", "0.1",
        "--model.multi-modal-image-text.lr-multiplier-text-encoder", "2"])
    model = port_model_from(opts_torch, conv["variables"])
    mults = model.get_lr_multipliers(opts_torch)
    assert mults == conv["model"].get_lr_multipliers(opts_jax) == {
        "^image_encoder/": 0.1, "^text_encoder/": 2.0}
    groups = param_groups(model, 0.2, True, mults)
    by_id = {id(p): (g["weight_decay"], g["lr_mult"]) for g in groups for p in g["params"]}
    named = dict(model.named_parameters())
    mask = _decay_mask(conv["variables"]["params"])
    leaves = list(flat_leaves(conv["variables"]["params"]))
    assert len(leaves) == len(by_id) == len(named)
    for path, _ in leaves:
        decays = bool(_dig(mask, path))
        decay, mult = by_id[id(named[torch_key(path)])]
        assert (decay == 0.2) == decays and decay in (0.0, 0.2), path
        assert mult == {"image_encoder": 0.1, "text_encoder": 2.0}.get(path[0], 1.0), path
    assert by_id[id(named["logit_scale"])][0] == 0.0  # rank 0
    assert by_id[id(named["text_encoder.token_embedding"])][0] == 0.2


def _dig(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# clip_vit.yaml's optimizer, clip and EMA (momentum raised so that three
# steps move it), with a short warmup so that the steps' LRs differ
STEP_ARGS = [
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.2",
    "--optim.no-decay-bn-filter-bias",
    "--optim.adamw.beta1", "0.9",
    "--optim.adamw.beta2", "0.98",
    "--common.grad-clip", "1.0",
    "--ema.enable",
    "--ema.momentum", "0.1",
    "--scheduler.name", "cosine",
    "--scheduler.is-iteration-based",
    "--scheduler.max-iterations", "100",
    "--scheduler.warmup-iterations", "2",
    "--scheduler.warmup-init-lr", "1e-4",
    "--scheduler.cosine.max-lr", "0.0005",
]


def test_three_adamw_steps_match_jax(conv):
    """Three steps from one state on seeded uint8 images (JAX takes them as
    float / 255, the port normalizes on the device) and token rows: the first
    step's loss and grad norm tightly and its update to 1% of the LR but
    where a noise-level grad flips Adam's sign; then loss, norm and params
    within Adam's step-size bounds (test_torch_train_step.py explains them)."""
    from cvnets_tpu.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu.loss import build_loss_fn
    from cvnets_tpu.optim import build_optimizer
    from cvnets_tpu_torch.engine import train_state as port
    from cvnets_tpu_torch.loss import build_loss_fn as port_loss
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.optim import build_optimizer as port_optimizer
    from cvnets_tpu_torch.optim.scheduler import build_scheduler
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    opts_jax, opts_torch = both_opts(CLIP_CONV_ARGS + STEP_ARGS)
    jmodel, variables = conv["model"], conv["variables"]
    batches = [clip_inputs(10 + i, batch=8) for i in range(3)]
    pixels = [np.round(b["image"] * 255).astype(np.uint8) for b in batches]
    lrs = [build_scheduler(opts_torch).retrieve_lr(0, i) for i in range(3)]

    class LossAndNorm:
        def batch_values(self, prediction, targets, extras):
            return extras["loss"]["total_loss"], extras["grad_norm"]

    tx = build_optimizer(opts_jax, lr_multipliers=jmodel.get_lr_multipliers(opts_jax))
    state = create_train_state(jmodel, tx, jax.random.PRNGKey(0),
                               {"samples": jax_samples(clip_inputs(0, batch=1))},
                               ema_enabled=True)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    state = state.replace(params=params, batch_stats=stats, ema_params=params,
                          ema_batch_stats=stats, opt_state=tx.init(params))
    jstep = jax.jit(make_train_step(jmodel, build_loss_fn(opts_jax), tx, opts_jax,
                                    {"out": LossAndNorm()}))
    model = port_model_from(opts_torch, variables)
    tstate = port.create_train_state(
        model, port_optimizer(opts_torch, model, model.get_lr_multipliers(opts_torch)),
        ema_enabled=True)
    tstep = port.make_train_step(model, port_loss(opts_torch), opts_torch,
                                 build_metrics(opts_torch, ["loss", "grad_norm"]))
    runs = []
    for i, (b, px) in enumerate(zip(batches, pixels)):
        state, metrics = jstep(state, {"samples": {"image": jnp.asarray(px, jnp.float32) / 255.0,
                                                   "text": jnp.asarray(b["text"], jnp.int32)},
                                       "targets": jnp.arange(8)}, lrs[i], jax.random.PRNGKey(0))
        tstate, tm = tstep(tstate, {"samples": {"image": nchw(px),
                                                "text": torch.from_numpy(b["text"])},
                                    "targets": torch.arange(8)}, lrs[i])
        runs.append((float(metrics["out"][0]), float(metrics["out"][1]),
                     tm["loss"]["loss"][0].item(), tm["grad_norm"]["grad_norm"][0].item(),
                     {k: v.clone() for k, v in model.state_dict().items()}, state))
        if i == 0:
            first = [np.abs(v.numpy() - to_torch_layout(p, np.asarray(_dig(state.params, p)))
                            ).ravel()
                     for p, _ in flat_leaves(variables["params"])
                     for v in [runs[0][4][torch_key(p)]]]
    jloss, jnorm, loss, norm = runs[0][:4]
    assert loss == pytest.approx(jloss, abs=1e-4)
    assert norm == pytest.approx(jnorm, rel=5e-4)
    diffs = np.concatenate(first)
    assert diffs.max() <= 2.0001 * lrs[0]
    assert np.mean(diffs > 1e-2 * lrs[0]) < 0.01
    for i, (jloss, jnorm, loss, norm, _, _) in enumerate(runs):
        assert loss == pytest.approx(jloss, abs=5e-3), f"step {i}"
        assert norm == pytest.approx(jnorm, rel=2e-2), f"step {i}"
    sd, state = runs[-1][4], runs[-1][5]
    for tree, port_sd, bound in ((state.params, sd, 2 * sum(lrs)),
                                 (state.ema_params, tstate.ema.model.state_dict(),
                                  0.2 * 2 * sum(lrs))):
        for path, leaf in flat_leaves(_np(tree)):
            np.testing.assert_allclose(port_sd[torch_key(path)].numpy(),
                                       to_torch_layout(path, leaf), rtol=0, atol=bound,
                                       err_msg=torch_key(path))
    assert tstate.step == 3


def test_vit_image_embedding_taps_match_jax(vit):
    """``forward(x, return_image_embeddings=True)`` and ``extract_end_points_all``
    give the tokens after the CLS one as (B, E, h, w), the JAX ViT's NHWC map
    (vit.py:182-215) in NCHW."""
    from cvnets_tpu_torch.models import get_model

    jvit, variables = vit["jvit"], vit["vit_vars"]
    image = jnp.asarray(vit["samples"]["image"])
    logits, emb = jax.jit(lambda v: jvit.apply(v, image, training=False,
                                               return_image_embeddings=True))(variables)
    taps = jax.jit(lambda v: jvit.apply(v, image, training=False,
                                        method=jvit.extract_end_points_all))(variables)
    _, port_opts = both_opts(CLIP_VIT_ARGS + ["--dataset.category", "classification",
                                              "--model.classification.n-classes", "64"])
    model = port_model_from(port_opts, variables).eval()
    with torch.no_grad():
        got_logits, got_emb = model(nchw(vit["samples"]["image"]), return_image_embeddings=True)
        got_taps = model.extract_end_points_all(nchw(vit["samples"]["image"]))
        feats = model.extract_features(nchw(vit["samples"]["image"]))
    want = np.asarray(emb).transpose(0, 3, 1, 2)
    assert got_emb.shape == want.shape == (4, 64, 4, 4) and list(got_taps) == ["out_l5"]
    np.testing.assert_allclose(got_emb.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_taps["out_l5"].numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), rtol=0, atol=1e-5)
    np.testing.assert_allclose(feats.numpy(), np.asarray(logits), rtol=0, atol=1e-5)  # I, 0
    np.testing.assert_allclose(np.asarray(taps["out_l5"]), np.asarray(emb), rtol=0, atol=0)


def test_text_gradient_checkpointing_raises_and_names_its_roadmap_item():
    """The text tower's ``--model.text.transformer.gradient-checkpoint``
    (ported: it raised naming ROADMAP queue 1 item 5 before) recomputes each
    text block in the backward and changes nothing of two AdamW steps of the
    micro CLIP: losses, grads, parameters and EMA bit for bit
    (``layers/remat.py``)."""
    from torch_port_helpers import assert_checkpointing_changes_nothing, checkpointing_runs

    batches = []
    for seed in (12, 13):
        inputs = clip_inputs(seed)
        pixels = np.round(inputs["image"] * 255).astype(np.uint8)
        batches.append({"samples": {"image": nchw(pixels),
                                    "text": torch.from_numpy(inputs["text"])},
                        "targets": torch.arange(4)})
    runs = checkpointing_runs(CLIP_VIT_ARGS + ["--model.text.transformer.dropout", "0.1"],
                              batches, flag="--model.text.transformer.gradient-checkpoint")
    assert_checkpointing_changes_nothing(runs)


def test_accumulation_slices_every_leaf_of_dict_samples():
    """``--common.accum-freq 2`` on CLIP's {"image", "text"} samples: the
    step's grads are the mean of the two contiguous halves' grads (no clip,
    LR 0, so the grads stay in place)."""
    from cvnets_tpu_torch.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import build_optimizer

    _, opts = both_opts(CLIP_VIT_ARGS + ["--common.accum-freq", "2", "--optim.name", "adamw",
                                         "--model.normalization.name", "layer_norm"])
    model = get_model(opts, device="cpu")
    pixels = np.round(clip_inputs(11)["image"] * 255).astype(np.uint8)
    samples = {"image": nchw(pixels), "text": torch.from_numpy(clip_inputs(11)["text"])}
    crit = build_loss_fn(opts)
    model.train()
    for half in (slice(0, 2), slice(2, 4)):
        pred = model({"image": samples["image"][half].float() / 255.0,
                      "text": samples["text"][half]})
        (crit(None, pred, None, training=True)["total_loss"] / 2).backward()
    want = {k: p.grad.clone() for k, p in model.named_parameters()}
    step = make_train_step(model, crit, opts, build_metrics(opts, ["loss"]))
    state = create_train_state(model, build_optimizer(opts, model))
    step(state, {"samples": samples, "targets": torch.arange(4)}, 0.0)
    for k, p in model.named_parameters():
        torch.testing.assert_close(p.grad, want[k], rtol=0, atol=1e-6, msg=k)


def test_device_augmentation_takes_no_dict_samples():
    from cvnets_tpu_torch.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import build_optimizer

    _, opts = both_opts(CLIP_VIT_ARGS)
    model = get_model(opts, device="cpu")
    step = make_train_step(model, build_loss_fn(opts), opts, build_metrics(opts, ["loss"]),
                           augment_fn=lambda images, rng: images)
    with pytest.raises(ValueError, match="not a dict"):
        step(create_train_state(model, build_optimizer(opts, model)),
             {"samples": port_samples(clip_inputs(0)), "targets": torch.arange(4)}, 1e-3)


@pytest.mark.parametrize("extra,size", [
    (["--model.classification.name", "resnet", "--model.classification.resnet.depth", "18"], 64),
    (["--model.classification.name", "mobilevit_v2",
      "--model.classification.mitv2.width-multiplier", "0.5"], 64),
    (["--model.classification.name", "swin", "--model.classification.swin.mode", "micro",
      "--model.classification.swin.stochastic-depth-prob", "0"], 112)])
def test_image_tower_takes_the_classifiers_input_of_each_family(extra, size):
    """The projection head's width is the encoder classifier's input
    (``model_conf_dict``'s, else the classifier's own), and the tower is the
    encoder's ``extract_features`` (a Swin's pooled map, not the base stages)."""
    from torch_port_helpers import micro_swin_modes

    from cvnets_tpu_torch.models import MODEL_REGISTRY, get_model
    from cvnets_tpu_torch.models.multi_modal.image_projection.heads import l2_normalize

    _, opts = both_opts(CLIP_VIT_ARGS + extra)
    with micro_swin_modes():
        model = get_model(opts, device="cpu").eval()
        encoder = MODEL_REGISTRY[extra[1], "classification"].build_model(opts)
    classifier = getattr(encoder.classifier, "fc", encoder.classifier)
    assert model.image_projection.proj.shape == (classifier.in_features, EMBED)
    x = torch.rand(2, 3, size, size, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        feats = model.image_encoder.extract_features(x)
        assert feats.shape[1] == classifier.in_features
        torch.testing.assert_close(model.encode_image(x),
                                   l2_normalize(model.image_projection(feats)))
