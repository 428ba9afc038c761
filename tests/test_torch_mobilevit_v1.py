"""MobileViTv1 in the PyTorch port against the JAX package, float32 on the CPU,
13 classes, the same perturbed weights on both sides (through
``utils/jax_params.py``), with the tolerances of ``torch_port_helpers``:

* ``xx_small`` at 64 px (layer 3's heads have D = 64 / 4 = 16, a head dim the
  MHA kernel takes: the wrapper's plain version runs here) and at 80 px, where
  layer 4's map is 5 × 5 and layer 5's 3 × 3: v1's resize route (up to the
  patch multiple and back down with ``jax.image.resize``'s weights); eval and
  train logits, BN statistics, the loss and the train- and eval-mode grads;
* a narrowed ``small`` (a "micro" mode put into both packages' tables by the
  ``micro`` fixture: small's four-times expansion and number-heads 4, as
  mobilevit.yaml, at about half its widths, heads of D = 18, 24 and 30, which
  take the einsum route);
* the tap points at output stride 8 and 16 (dilated layer 4 and 5), and at
  8 the logits, BN statistics and grads of the classifier on top;
* ``get_model`` on mobilevit.yaml's flags builds MobileViT-S's 5.6 M
  parameters, each with the JAX tree's shape (``jax.eval_shape``).
"""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    CONV_FAMILY_ARGS,
    assert_end_points_match,
    assert_every_leaf_loaded,
    assert_grads_match,
    assert_logits_match,
    assert_loss_matches,
    assert_stats_match,
    both_opts,
    jax_leaf_shapes,
    jax_outputs,
    nchw,
    perturbed_variables,
    port_model_from,
    port_outputs,
    port_shapes,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

MICRO_MODE = (4, [16, 32, (48, 72, 144, 2), (64, 96, 192, 2), (80, 120, 240, 1)])


def mit_args(mode: str):
    return ["--model.classification.name", "mobilevit",
            "--model.classification.mit.mode", mode,
            "--model.classification.mit.number-heads", "4",
            "--model.activation.name", "swish", *CONV_FAMILY_ARGS]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module", autouse=True)
def micro():
    from cvnets_tpu.models.classification.config import mobilevit as jax_cfg
    from cvnets_tpu_torch.models.classification.config import mobilevit as port_cfg

    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_cfg, port_cfg):
            mp.setitem(module._MODES, "micro", MICRO_MODE)
        yield


def _pair(mode: str, size: int):
    from cvnets_tpu.models import get_model

    opts_jax, opts_torch = both_opts(mit_args(mode))
    rng = np.random.default_rng(size)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    y = np.array([3, 11])
    jmodel = get_model(opts_jax)
    variables = perturbed_variables(jmodel, x)
    return dict(opts_torch=opts_torch, variables=variables,
                jax=jax_outputs(jmodel, variables, x, y, opts_jax),
                port=port_outputs(opts_torch, variables, x, y))


CASES = {"xx_small_64px": ("xx_small", 64), "xx_small_80px_resize": ("xx_small", 80),
         "micro_small_64px": ("micro", 64)}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return _pair(*CASES[request.param])


def test_logits_and_bn_stats_match(pair):
    assert_logits_match(pair["port"]["eval"], pair["jax"]["eval"])
    assert_logits_match(pair["port"]["train"], pair["jax"]["train"])
    assert_stats_match(pair["port"]["state"], pair["jax"]["stats"])


def test_loss_and_grads_match(pair):
    assert_loss_matches(pair["port"]["loss"], pair["jax"]["loss"], pair["jax"]["train"])
    assert_grads_match(pair["port"]["grads"], pair["jax"]["grads"])
    assert_grads_match(pair["port"]["eval_grads"], pair["jax"]["eval_grads"])


def test_every_leaf_is_loaded(pair):
    assert_every_leaf_loaded(port_model_from(pair["opts_torch"], pair["variables"]),
                             pair["variables"])


def test_resize_route_is_taken_where_a_map_is_odd():
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.modules import mobilevit_block

    _, opts_torch = both_opts(mit_args("xx_small"))
    model = get_model(opts_torch, device="cpu").eval()
    sizes = []
    real = mobilevit_block.resize_bilinear

    def spy(x, size):
        sizes.append((tuple(x.shape[-2:]), tuple(size)))
        return real(x, size)

    with pytest.MonkeyPatch.context() as mp, torch.no_grad():
        mp.setattr(mobilevit_block, "resize_bilinear", spy)
        model(torch.zeros(1, 3, 80, 80))
        assert sizes == [((5, 5), (6, 6)), ((6, 6), (5, 5)), ((3, 3), (4, 4)),
                         ((4, 4), (3, 3))]
        sizes.clear()
        model(torch.zeros(1, 3, 64, 64))
        assert sizes == []


@pytest.mark.parametrize("output_stride", [8, 16])
def test_end_points_at_output_stride(output_stride):
    model, got = assert_end_points_match(mit_args("xx_small"), "mobilevit", output_stride)
    assert got["out_l5"].shape[-1] == 64 // output_stride
    assert model.layer_5[1].local_conv.conv.dilation == (64 // output_stride // 2,) * 2


def test_logits_bn_stats_and_grads_at_output_stride_8():
    """The classifier on the dilated encoder (layers 4 and 5 at stride 1)."""
    from cvnets_tpu.models import get_model
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import MODEL_REGISTRY
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    opts_jax, opts_torch = both_opts(mit_args("xx_small"))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    y = np.array([5, 9])
    jmodel = get_model(opts_jax).clone(output_stride=8)
    variables = perturbed_variables(jmodel, x)
    want = jax_outputs(jmodel, variables, x, y, opts_jax)
    crit = build_loss_fn(opts_torch)
    for mode in ("eval", "train"):
        model = MODEL_REGISTRY["mobilevit", "classification"].build_model(opts_torch,
                                                                          output_stride=8)
        load_jax_params(model, variables["params"], variables["batch_stats"])
        pred = model.train(mode == "train")(nchw(x))
        crit(None, pred, torch.from_numpy(y), training=True).backward()
        assert_logits_match(pred.detach().numpy(), want[mode])
        grads = {k: p.grad for k, p in model.named_parameters()}
        assert_grads_match(grads, want["grads" if mode == "train" else "eval_grads"])
    assert_stats_match(model.state_dict(), want["stats"])


def test_mobilevit_yaml_builds_mobilevit_s_with_the_jax_shapes():
    from cvnets_tpu.models import get_model as jax_model
    from cvnets_tpu_torch.models import get_model

    args = ["--common.config-file", "config/classification/imagenet/mobilevit.yaml"]
    opts_jax, opts_torch = both_opts(args)
    model = get_model(opts_torch, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 5_578_632
    assert port_shapes(model) == jax_leaf_shapes(jax_model(opts_jax))
    heads = [blk[1].global_rep_0.mha.num_heads for blk in
             (model.layer_3, model.layer_4, model.layer_5)]
    dims = [blk[1].global_rep_0.mha.embed_dim for blk in
            (model.layer_3, model.layer_4, model.layer_5)]
    assert heads == [4, 4, 4] and dims == [144, 192, 240]  # D = 36, 48, 60
    assert model.conv_1x1_exp.conv.out_channels == 640
