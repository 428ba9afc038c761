"""The spatio-temporal video model in the PyTorch port against the JAX
package on the same weights: clips of 2 frames × 64² × 3, batch 2, 7
classes, float32 on the CPU, over MobileViTv2 at width 0.5 and MobileViT
xx_small (frame by frame: each MobileViT block attends to its own post-norm
patches of the previous frame) and MobileNetV2 at width 0.25 (frames folded
into the batch). Checked: eval logits, train logits and every parameter's
gradient of a label-smoothed CE; that the second frame really took the
cross path (v2: q and k from the previous frame through the projection's
slices; v1: keys from it); and the evaluation's vote over a video's clips
(sum and max) against JAX's ``eval_fn_video``.

Tolerances, measured in a script on these cases: eval logits 1e-6 of the
largest (bound 1e-4 absolute), train logits 6e-6 (bound 2e-4 of the
largest), the grads 1.1e-3 of the largest grad for MobileViTv2, whose 14
batch-statistic BNs a frame amplify float32 noise as in
test_torch_mobilevit_v2.py, 6e-6 for v1 (bound 5e-3)."""

from __future__ import annotations

import collections
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    both_opts,
    flat_leaves,
    perturbed_variables,
    port_model_from,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

LOGIT_ATOL, TRAIN_REL, GRAD_REL = 1e-4, 2e-4, 5e-3
VIDEO_ARGS = ["--dataset.category", "video_classification",
              "--model.video-classification.name", "spatio_temporal",
              "--model.video-classification.n-classes", "7",
              "--loss.category", "classification",
              "--loss.classification.cross-entropy.label-smoothing", "0.1",
              "--model.activation.name", "swish",
              "--model.layer.conv-init", "kaiming_normal",
              "--model.layer.linear-init", "trunc_normal"]
ENCODERS = {
    "mobilevit_v2": ["--model.classification.name", "mobilevit_v2",
                     "--model.classification.mitv2.width-multiplier", "0.5"],
    "mobilevit": ["--model.classification.name", "mobilevit",
                  "--model.classification.mit.mode", "xx_small"],
    "mobilenetv2": ["--model.classification.name", "mobilenetv2",
                    "--model.classification.mobilenetv2.width-multiplier", "0.25",
                    "--model.classification.classifier-dropout", "0"],
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def clips_nchw(x: np.ndarray) -> torch.Tensor:
    """(..., T, H, W, C) → (..., T, C, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


@pytest.fixture(scope="module", params=sorted(ENCODERS))
def pair(request):
    from cvnets_tpu.models import get_model

    opts_jax, opts_torch = both_opts(VIDEO_ARGS + ENCODERS[request.param])
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 2, 64, 64, 3)).astype(np.float32)
    y = np.array([3, 5])
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    return dict(name=request.param, x=x, y=y, jmodel=jmodel, variables=variables,
                opts_jax=opts_jax, opts_torch=opts_torch)


def test_logits_and_grads_match_over_two_frames(pair):
    from cvnets_tpu.loss import build_loss_fn as jax_loss
    from cvnets_tpu_torch.layers.linear_attention import LinearSelfAttention
    from cvnets_tpu_torch.layers.multi_head_attention import MultiHeadAttention
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    x, y, variables = jnp.asarray(pair["x"]), jnp.asarray(pair["y"]), pair["variables"]
    jcrit = jax_loss(pair["opts_jax"])
    want_eval = np.asarray(pair["jmodel"].apply(variables, x, training=False))

    def loss_fn(params):
        pred, _ = pair["jmodel"].apply({**variables, "params": params}, x, training=True,
                                       mutable=["batch_stats"],
                                       rngs={"dropout": jax.random.PRNGKey(0)})
        return jcrit(x, pred, y, training=True), pred

    (_, jpred), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])

    model = port_model_from(pair["opts_torch"], variables).eval()
    assert model.temporal == (pair["name"] != "mobilenetv2")
    with torch.no_grad():
        got_eval = model(clips_nchw(pair["x"]))
    np.testing.assert_allclose(got_eval.numpy(), want_eval, rtol=0, atol=LOGIT_ATOL)

    cross = []  # whether each attention call was given the previous frame
    with pytest.MonkeyPatch.context() as mp:
        for cls, arg in ((LinearSelfAttention, "x_prev"), (MultiHeadAttention, "x_kv")):
            original = cls.forward

            def spy(self, x, *args, _original=original, _arg=arg, **kwargs):
                cross.append(kwargs.get(_arg, args[0] if args else None) is not None)
                return _original(self, x, *args, **kwargs)

            mp.setattr(cls, "forward", spy)
        model.train()
        pred = model(clips_nchw(pair["x"]))
    # frame 0 attends to itself, frame 1 to frame 0's patches: half the calls
    assert sum(cross) == (len(cross) // 2 if model.temporal else 0) and (
        cross or pair["name"] == "mobilenetv2")
    want = np.asarray(jpred)
    np.testing.assert_allclose(pred.detach().numpy(), want, rtol=0,
                               atol=TRAIN_REL * np.abs(want).max())
    build_loss_fn(pair["opts_torch"], device="cpu")(
        None, pred, torch.from_numpy(pair["y"]), training=True).backward()
    named = dict(model.named_parameters())
    leaves = list(flat_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    assert len(leaves) == len(named)
    gmax = max(float(np.abs(g).max()) for _, g in leaves)
    for path, g in leaves:
        key = torch_key(path)
        np.testing.assert_allclose(named[key].grad.numpy(), to_torch_layout(path, g), rtol=0,
                                   atol=GRAD_REL * gmax, err_msg=key)


class _Capture:
    """A metric that hands the logits it is given back (both packages)."""

    def __init__(self) -> None:
        self.logits = []

    def batch_values(self, prediction, targets, extras=None):
        self.logits.append(np.asarray(prediction.detach() if hasattr(prediction, "detach")
                                      else prediction))
        return {}


@pytest.mark.parametrize("voting", ["sum", "max"])
def test_clip_voting_is_jaxs_eval_fn_video(voting):
    """Three clips a video, batch 2: the clips fold into the batch and their
    logits are summed or maxed, as JAX's ``eval_fn_video`` does."""
    from cvnets_tpu.engine.evaluation_engine import Evaluator as JaxEvaluator
    from cvnets_tpu.models import get_model
    from cvnets_tpu_torch.engine.train_state import TrainState, make_video_eval_step

    args = VIDEO_ARGS + ENCODERS["mobilevit_v2"] + [
        "--model.video-classification.clip-out-voting-fn", voting,
        "--common.inference-modality", "video"]
    opts_jax, opts_torch = both_opts(args)
    rng = np.random.default_rng(1)
    pixels = rng.integers(0, 256, (2, 3, 2, 64, 64, 3)).astype(np.uint8)
    targets = np.array([1, 6])
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, pixels[:, 0].astype(np.float32) / 255.0)

    jax_metric = _Capture()
    state = collections.namedtuple("State", "params batch_stats")  # a pytree for jax.jit
    fake = types.SimpleNamespace(
        opts=opts_jax, model=jmodel, is_master_node=False,
        state=state(variables["params"], variables["batch_stats"]),
        test_loader=[{"samples": pixels.astype(np.float32) / 255.0, "targets": targets}],
        stats=types.SimpleNamespace(metrics={"capture": jax_metric},
                                    update=lambda **kw: None,
                                    avg_statistics_all=lambda: {}))
    JaxEvaluator.eval_fn_video(fake)

    model = port_model_from(opts_torch, variables)
    metric = _Capture()
    step = make_video_eval_step(model, {"capture": metric}, opts=opts_torch)
    step(TrainState(model=model, optimizer=None),
         {"samples": clips_nchw(pixels), "targets": torch.from_numpy(targets)})
    (want,), (got,) = jax_metric.logits, metric.logits
    assert got.shape == want.shape == (2, 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=3 * LOGIT_ATOL)
