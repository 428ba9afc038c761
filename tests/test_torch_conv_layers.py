"""The layers and blocks the conv families add to the PyTorch port, against the
JAX package on the same inputs and weights, float32 on the CPU:

* every activation of the JAX registry (relu, relu6, leaky_relu with the
  prefix's neg_slope, swish, silu, gelu, hard_swish, hard_sigmoid, sigmoid,
  tanh, prelu and the identities): values and input grads to 1e-6
  (float32 rounding of the same formula; F.hardswish and F.hardsigmoid
  against JAX's relu6 forms);
* every norm of the JAX registry in train and eval mode (outputs to 1e-5,
  running statistics to 1e-6), and the dtype each returns under mixed
  precision;
* the "mean", "rms" and "abs" global pools (1e-6);
* SeparableConv2d, SqueezeExcitation and InvertedResidualSE with every
  option the families use (1e-5);
* the parser: ``--model.classification.activation.*`` and
  ``--model.activation.{inplace,neg-slope}`` with the JAX dests and defaults;
  the conv, recipe, distillation, fixed / multi_step and Mask R-CNN yamls
  parse with no "Yaml entry not supported by the port" warning but for the
  named keys of unported items (Mask R-CNN's); a model whose options ask for
  the neural augmentor builds it with the JAX tree's scalars; the pascal_voc
  yaml's dataset and the audio and video categories fail naming the cause or
  the ROADMAP item.
"""

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
    both_opts,
    nchw,
    perturbed_variables,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """torch on two threads: the suite's xdist workers share the cores."""
    with torch_threads(2):
        yield


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ACTIVATIONS = ["relu", "relu6", "leaky_relu", "swish", "silu", "gelu", "hard_swish",
               "hard_sigmoid", "sigmoid", "tanh", "prelu", "none", "identity", "linear"]


def _act_input():
    """Normal draws, the kinks of relu6 and the hard functions (-3, 0, 3, 6)
    nudged off them, and large magnitudes."""
    rng = np.random.default_rng(0)
    special = np.array([-3.001, -2.999, -1e-3, 1e-3, 2.999, 3.001, 5.999, 6.001, -50, 50])
    return np.concatenate([4 * rng.standard_normal(502), special]).astype(np.float32)


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_every_activation_matches_jax(name):
    from cvnets_tpu.layers.activation import build_act_layer as jax_act
    from cvnets_tpu_torch.layers.activation import build_act_layer

    opts_jax, opts_torch = both_opts(["--model.activation.neg-slope", "0.2"])
    x = _act_input()
    jfn, fn = jax_act(opts_jax, name), build_act_layer(opts_torch, name)
    if name == "prelu":
        variables = {"params": {"alpha": np.array([0.3], np.float32)}}
        jfn = (lambda f: lambda a: f.apply(variables, a))(jfn)
        with torch.no_grad():
            fn.alpha.fill_(0.3)
        assert isinstance(fn, torch.nn.Module)
    w = np.random.default_rng(1).standard_normal(x.size).astype(np.float32)
    jgrad = jax.grad(lambda a: jnp.sum(jfn(a) * w))(jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    got = fn(t)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(jfn(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-6)


def test_leaky_relu_reads_the_prefixs_neg_slope():
    from cvnets_tpu_torch.layers.activation import build_act_layer

    _, opts = both_opts(["--model.activation.neg-slope", "0.2",
                         "--model.classification.activation.neg-slope", "0.05"])
    x = torch.tensor([-1.0, 2.0])
    assert build_act_layer(opts, "leaky_relu")(x).tolist() == pytest.approx([-0.2, 2.0])
    got = build_act_layer(opts, "leaky_relu", prefix="model.classification.activation")(x)
    assert got.tolist() == pytest.approx([-0.05, 2.0])
    assert build_act_layer(opts).__name__ == "relu"  # the prefix's name, default relu


def test_per_channel_prelu_scales_the_channel_axis():
    from cvnets_tpu.layers.activation import PReLU as JaxPReLU
    from cvnets_tpu_torch.layers.activation import PReLU

    x = np.random.default_rng(1).standard_normal((2, 5, 3, 4)).astype(np.float32)
    alpha = np.linspace(0.1, 0.9, 4).astype(np.float32)
    want = JaxPReLU(num_parameters=4).apply({"params": {"alpha": alpha}}, jnp.asarray(x))
    layer = PReLU(4)
    with torch.no_grad():
        layer.alpha.copy_(torch.from_numpy(alpha))
        got = layer(nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)


def _norms():
    from cvnets_tpu.layers.normalization import SUPPORTED_NORM_FNS

    return [n for n in SUPPORTED_NORM_FNS if n != "identity"]


def _norm_input(norm: str) -> np.ndarray:
    """Channels last, as JAX takes them: (N, C) for batch_norm_1d, (N, D, H, W,
    C) for batch_norm_3d, (N, H, W, C) for the rest."""
    rng = np.random.default_rng(len(norm))
    shape = {"batch_norm_1d": (6, 12), "batch_norm_3d": (2, 3, 4, 5, 12)}.get(norm,
                                                                           (2, 5, 6, 12))
    return (1.5 + 2 * rng.standard_normal(shape)).astype(np.float32)


def _channels_first(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


@pytest.mark.parametrize("norm", _norms())
def test_every_norm_matches_jax_in_train_and_eval(norm):
    """Each norm of the JAX registry, from the port's ``get_normalization_layer``
    with the same perturbed weights and statistics, on (N, C, ...) tensors where
    JAX takes (N, ..., C): the torch layout for every norm but the two
    LayerNorms, which the port, as JAX, applies over a trailing channel axis.
    ``model.normalization.groups`` 4 sets group_norm's groups."""
    from cvnets_tpu.layers.normalization import get_normalization_layer as jax_norm
    from cvnets_tpu_torch.layers.normalization import SUPPORTED_NORM_FNS, get_normalization_layer
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    assert norm in SUPPORTED_NORM_FNS
    opts_jax, opts_torch = both_opts(["--model.normalization.groups", "4",
                                      "--model.normalization.momentum", "0.2"])
    x = _norm_input(norm)
    jlayer = jax_norm(opts_jax, 12, norm)
    channels_last = norm.startswith("layer_norm")
    variables = perturbed_variables(
        jlayer, x, init_kwargs={"use_running_average": True} if "batch" in norm else {})
    layer = get_normalization_layer(opts_torch, 12, norm)
    load_jax_params(layer, variables["params"], variables.get("batch_stats"))
    to_port = torch.from_numpy if channels_last else _channels_first

    def back(t):
        return t.numpy() if channels_last else np.moveaxis(t.numpy(), 1, -1)

    for training in (False, True):
        kwargs = {"use_running_average": not training} if "batch" in norm else {}
        want, new = jlayer.apply(variables, jnp.asarray(x), mutable=["batch_stats"], **kwargs)
        with torch.no_grad():
            got = layer.train(training)(to_port(x))
        np.testing.assert_allclose(back(got), np.asarray(want), rtol=0, atol=1e-5)
    if "batch" in norm:  # after the train forward: torch's momentum, Bessel's variance
        for leaf, buf in (("mean", layer.running_mean), ("var", layer.running_var)):
            np.testing.assert_allclose(buf.numpy(), np.asarray(new["batch_stats"][leaf]),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("norm,want", [
    ("batch_norm", torch.bfloat16), ("sync_batch_norm_fp32", torch.float32),
    ("layer_norm_fp32", torch.float32), ("group_norm", torch.float32),
    ("instance_norm", torch.float32), ("layer_norm_2d", torch.bfloat16)])
def test_norm_dtypes_under_mixed_precision_are_the_jax_ones(norm, want):
    """A bf16 input under bf16 autocast: the JAX norm returns compute_dtype
    (bf16) or float32 (the fp32 norms and GroupNorm, which flax promotes with
    its float32 scale); so does the port's."""
    from cvnets_tpu.layers.normalization import get_normalization_layer as jax_norm
    from cvnets_tpu_torch.layers.normalization import get_normalization_layer

    mixed = ["--common.mixed-precision", "--common.mixed-precision-dtype", "bfloat16",
             "--model.normalization.groups", "4"]
    opts_jax, opts_torch = both_opts(mixed)
    x = _norm_input(norm)
    jlayer = jax_norm(opts_jax, 12, norm)
    kwargs = {"use_running_average": True} if "batch" in norm else {}
    variables = jlayer.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.bfloat16), **kwargs)
    jdtype = jlayer.apply(variables, jnp.asarray(x, jnp.bfloat16), **kwargs).dtype
    assert str(jdtype) == str(want).split(".")[-1]
    layer = get_normalization_layer(opts_torch, 12, norm).eval()
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xt = xt if norm.startswith("layer_norm") else xt.movedim(-1, 1)
    with torch.autocast("cpu", dtype=torch.bfloat16), torch.no_grad():
        assert layer(xt).dtype == want


@pytest.mark.parametrize("pool", ["mean", "rms", "abs"])
def test_global_pools_match_jax(pool):
    from cvnets_tpu.layers.pool import GlobalPool
    from cvnets_tpu_torch.layers.pool import global_pool

    x = np.random.default_rng(2).standard_normal((3, 7, 5, 6)).astype(np.float32)
    want = GlobalPool(pool_type=pool).apply({}, jnp.asarray(x))
    np.testing.assert_allclose(global_pool(nchw(x), pool).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_classifier_takes_the_global_pool_flag():
    from cvnets_tpu_torch.models import get_model

    _, opts = both_opts(["--model.classification.name", "resnet",
                         "--model.classification.resnet.depth", "18",
                         "--model.layer.global-pool", "rms",
                         "--dataset.category", "classification"])
    assert get_model(opts, device="cpu").classifier.pool_type == "rms"


def _block_pair(jax_block, port_block, x: np.ndarray, seed: int = 4):
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    variables = perturbed_variables(jax_block, x, seed=seed)
    load_jax_params(port_block, variables["params"], variables.get("batch_stats"))
    for training in (False, True):
        want = jax_block.apply(variables, jnp.asarray(x), training=training,
                               mutable=["batch_stats"])[0]
        with torch.no_grad():
            got = port_block.train(training)(nchw(x)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2)])
def test_separable_conv_matches_jax(stride, dilation):
    from cvnets_tpu.layers.conv_layer import SeparableConv2d as JaxSep
    from cvnets_tpu_torch.layers.conv_layer import SeparableConv2d

    opts_jax, opts_torch = both_opts(["--model.activation.name", "relu"])
    x = np.random.default_rng(3).standard_normal((2, 9, 9, 8)).astype(np.float32)
    _block_pair(JaxSep(opts=opts_jax, in_channels=8, out_channels=16, stride=stride,
                       dilation=dilation),
                SeparableConv2d(opts_torch, 8, 16, stride=stride, dilation=dilation), x)


class _SEOnly(torch.nn.Module):
    """SqueezeExcitation takes no training flag in either package."""

    def __init__(self, se):
        super().__init__()
        self.se = se

    def forward(self, x):
        return self.se(x)


@pytest.mark.parametrize("channels,squeeze_factor,squeeze,scale_fn,width", [
    (256, 4, None, "sigmoid", 64), (96, 4, None, "hard_sigmoid", 32),
    (48, 24, None, "sigmoid", 32), (40, 4, 10, "sigmoid", 10)])
def test_squeeze_excitation_matches_jax(channels, squeeze_factor, squeeze, scale_fn, width):
    """The squeeze width is ``max(make_divisible(C // factor, 8), 32)`` unless
    given (RegNet and SE-ResNet give theirs)."""
    import flax.linen as fnn

    from cvnets_tpu.modules.squeeze_excitation import SqueezeExcitation as JaxSE
    from cvnets_tpu_torch.modules.squeeze_excitation import SqueezeExcitation

    opts_jax, opts_torch = both_opts(["--model.activation.name", "swish"])
    kwargs = dict(squeeze_factor=squeeze_factor, squeeze_channels=squeeze,
                  scale_fn_name=scale_fn)

    class JaxSEOnly(fnn.Module):
        @fnn.compact
        def __call__(self, x, training=False):
            return JaxSE(opts=opts_jax, in_channels=channels, name="se", **kwargs)(x)

    se = SqueezeExcitation(opts_torch, channels, **kwargs)
    assert se.fc1.out_channels == width
    x = np.random.default_rng(5).standard_normal((2, 4, 5, channels)).astype(np.float32)
    _block_pair(JaxSEOnly(), _SEOnly(se), x)


@pytest.mark.parametrize("expand,use_hs,use_se,stride,kernel,dilation,act,scale_fn", [
    (1, False, True, 2, 3, 1, "relu", "hard_sigmoid"),   # MobileNetV3-small's first
    (4.5, False, False, 2, 3, 1, "relu", "hard_sigmoid"),
    (3.67, True, True, 1, 3, 1, "relu", "hard_sigmoid"),  # skip, hard-swish, SE
    (6, True, True, 1, 3, 2, "relu", "hard_sigmoid"),      # dilated (output stride)
    (6, False, True, 1, 5, 1, "swish", "sigmoid"),         # EfficientNet's 5×5
])
def test_inverted_residual_se_matches_jax(expand, use_hs, use_se, stride, kernel, dilation,
                                         act, scale_fn):
    from cvnets_tpu.modules.inverted_residual import InvertedResidualSE as JaxIRSE
    from cvnets_tpu_torch.modules.inverted_residual import InvertedResidualSE

    opts_jax, opts_torch = both_opts(["--model.activation.name", "relu"])
    kwargs = dict(expand_ratio=expand, use_hs=use_hs, use_se=use_se, stride=stride,
                  kernel_size=kernel, dilation=dilation, se_scale_fn_name=scale_fn,
                  act_fn_name=act, squeeze_factor=4 * (expand if act == "swish" else 1))
    x = np.random.default_rng(6).standard_normal((2, 9, 9, 16)).astype(np.float32)
    _block_pair(JaxIRSE(opts=opts_jax, in_channels=16, out_channels=16, **kwargs),
                InvertedResidualSE(opts_torch, 16, 16, **kwargs), x)


def test_efficientnet_stochastic_depth_schedule_is_the_jax_one():
    """b0 at the flag's default 0.2: each block's p, from the bound flax model
    (its residual blocks only apply it, as JAX's do)."""
    from cvnets_tpu.models import get_model as jax_model
    from cvnets_tpu_torch.models import get_model

    opts_jax, opts_torch = both_opts(["--model.classification.name", "efficientnet",
                                      "--dataset.category", "classification"])
    jmodel = jax_model(opts_jax).bind({})
    jmodel.setup()
    want = [b.stochastic_depth_prob for i in range(1, 6) for b in getattr(jmodel, f"layer_{i}")]
    blocks = [b for i in range(1, 6) for b in getattr(get_model(opts_torch, device="cpu"),
                                                       f"layer_{i}")]
    assert len(blocks) == len(want) == 16 and want[-1] == pytest.approx(0.2)
    for b, p in zip(blocks, want):
        assert (b.stochastic_depth.p if b.stochastic_depth is not None else 0.0) == \
            (p if b.use_res else 0.0)


def test_activation_and_learn_augmentation_flags_have_the_jax_dests_and_defaults():
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts_jax, opts_torch = both_opts([])
    for dest in ("model.classification.activation.name",
                 "model.classification.activation.inplace",
                 "model.classification.activation.neg_slope",
                 "model.activation.inplace", "model.activation.neg_slope",
                 "model.normalization.groups", "model.learn_augmentation.mode"):
        assert getattr(opts_torch, dest) == getattr(opts_jax, dest), dest
    opts = get_training_arguments(args=[
        "--model.classification.activation.name", "swish",
        "--model.classification.activation.inplace",
        "--model.classification.activation.neg-slope", "0.3"])
    assert (getattr(opts, "model.classification.activation.name"),
            getattr(opts, "model.classification.activation.inplace"),
            getattr(opts, "model.classification.activation.neg_slope")) == ("swish", True, 0.3)


def test_layers_build_with_model_activation_not_the_classification_one():
    """As in the JAX package, which never calls its
    ``set_model_specific_opts_before_model_building``: efficientnet_rangeaugment
    .yaml's ``model.classification.activation.name`` is parsed and not read."""
    from cvnets_tpu_torch.models import get_model

    _, opts = both_opts(["--model.classification.name", "resnet",
                         "--model.classification.resnet.depth", "18",
                         "--model.activation.name", "relu",
                         "--model.classification.activation.name", "swish",
                         "--dataset.category", "classification"])
    model = get_model(opts, device="cpu")
    assert model.conv_1.act.__name__ == "relu" and model.layer_2[0].act.__name__ == "relu"


# keys a yaml sets that the port's parser does not take: none since Mask
# R-CNN's loss weights and backbone LR were ported
UNPORTED_KEYS = {}
YAMLS = [f"classification/imagenet/{name}.yaml" for name in (
    "resnet", "resnet_adv", "mobilenet_v1", "mobilenet_v2", "mobilenet_v3", "mobileone",
    "mobilevit_v2", "vit", "swin", "efficientnet_rangeaugment",
    "regnet_y_16gf_rangeaugment", "mobilevit", "fastvit")] + [
    f"segmentation/{name}.yaml" for name in (
        "ade20k/deeplabv3_mobilevitv2", "ade20k/pspnet_mobilevitv2",
        "ade20k/deeplabv3_mobilenetv2", "ade20k/deeplabv3_resnet50",
        "pascal_voc/deeplabv3_mobilevitv2", "pascal_voc/pspnet_mobilevitv2",
        "pascal_voc/deeplabv3_mobilevit")] + ["detection/ssd_coco/mobilevit.yaml",
                                              "multi_modal_image_text/clip_vit.yaml"] + [
    # distillation, the fixed and multi_step schedulers, Mask R-CNN's keys
    "distillation/teacher_resnet101_student_mobilenet_v1.yaml",
    "classification/finetune_higher_res_in1k/mobilevit_v2.yaml",
    "detection/ssd_coco/resnet.yaml", "detection/mask_rcnn_coco/resnet_fpn.yaml",
    # Mask R-CNN on MobileViTv2 and on ViT-B/16 with the simple FPN and LSJ
    "detection/mask_rcnn_coco/vit_fpn.yaml", "detection/mask_rcnn_coco/vit_fpn_lsj.yaml"] + [
    # ByteFormer and audio, and one yaml of each examples/byteformer/ folder
    "classification/imagenet/byteformer.yaml",
    "audio_classification/speech_commands/byteformer_wav.yaml"] + [
    f"../examples/byteformer/{name}.yaml" for name in (
        "imagenet_file_encodings/encoding_png", "imagenet_jpeg_q100/conv_kernel_size_8",
        "imagenet_jpeg_q60/conv_kernel_size_32_w32",
        "imagenet_jpeg_shuffle_bytes/mode_window_shuffle",
        "imagenet_obfuscation/width_range_20",
        "imagenet_privacy_preserving_camera/keep_frac_0.05",
        "speech_commands_mp3/conv_kernel_size_8_w128",
        "speech_commands_wav/encoding_dtype_uint8_k4")]


@pytest.mark.parametrize("yaml", YAMLS)
def test_yamls_parse_with_no_unsupported_key_but_those_of_unported_items(yaml, monkeypatch):
    from cvnets_tpu.options.opts import get_training_arguments as jax_args
    from cvnets_tpu_torch.options import utils as option_utils
    from cvnets_tpu_torch.options.opts import get_training_arguments

    warned = []
    monkeypatch.setattr(option_utils.logger, "warning", warned.append)
    path = os.path.join(REPO, "config", yaml)
    opts = get_training_arguments(args=["--common.config-file", path])
    prefix = "Yaml entry not supported by the port: "
    assert all(w.startswith(prefix) for w in warned), warned
    assert sorted(w[len(prefix):] for w in warned) == sorted(UNPORTED_KEYS.get(yaml, []))
    jax_opts = jax_args(args=["--common.config-file", path])
    for dest, value in vars(opts).items():
        if dest != "common.config_file":
            assert getattr(jax_opts, dest) == value, dest


@pytest.mark.parametrize("name", ["efficientnet", "regnet", "resnet", "mobilevit_v2"])
def test_a_model_asking_for_the_neural_augmentor_builds_it(name):
    """RangeAugment's augmentor sits in the port's model where the JAX tree
    has it: the scalars of the enabled augmentations under
    ``neural_augmentor``, of the same shapes (``jax.eval_shape``, no weights)."""
    from cvnets_tpu.models import get_model as jax_get_model
    from cvnets_tpu_torch.models import get_model
    from torch_port_helpers import jax_leaf_shapes, port_shapes

    opts_jax, opts = both_opts(["--model.classification.name", name,
                                "--model.learn-augmentation.mode", "distribution",
                                "--model.learn-augmentation.brightness",
                                "--model.learn-augmentation.noise",
                                "--dataset.category", "classification"])
    model = get_model(opts, device="cpu")
    want = {k: v for k, v in jax_leaf_shapes(jax_get_model(opts_jax)).items()
            if k.startswith("neural_augmentor.")}
    got = {k: v for k, v in port_shapes(model).items() if k.startswith("neural_augmentor.")}
    assert got == want and sorted(got) == [
        "neural_augmentor.brightness_max", "neural_augmentor.brightness_min",
        "neural_augmentor.noise_max", "neural_augmentor.noise_min"]


def test_the_pascal_voc_yaml_fails_naming_the_registered_dataset_and_its_key():
    """ROADMAP fault 3: config/segmentation/pascal_voc/deeplabv3_mobilevit.yaml
    names ``pascal_voc``, which neither package registers; the port keeps the
    JAX failure, naming the registered ``pascal`` and the yaml key."""
    from cvnets_tpu_torch.data.datasets import build_dataset_from_registry
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=["--common.config-file", os.path.join(
        REPO, "config/segmentation/pascal_voc/deeplabv3_mobilevit.yaml")])
    with pytest.raises(SystemExit) as err:
        build_dataset_from_registry(opts)
    assert "'pascal_voc'" in str(err.value) and "dataset.name" in str(err.value)
    assert "'pascal'" in str(err.value) and "__base__" not in str(err.value)


@pytest.mark.parametrize("yaml,item", [
    ("config/classification/imagenet/vit_moe.yaml", "item 5"),
    ("config/video_classification/kinetics/mobilevit_st_small.yaml", "item 11"),
    ("examples/vit/segmentation/ade20k/deeplabv3_vit_base_clip_os_16.yaml", "item 5")])
def test_an_unported_category_fails_naming_its_roadmap_item(yaml, item):
    """ROADMAP faults 4 and 5, closed: the three yamls that raised naming
    their ROADMAP item (ViT MoE blocks and a ViT segmentation encoder, item
    5; the video category, item 11) now build through ``get_model`` on the
    ``meta`` device, with the parts each waited for."""
    import torch

    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.modules.moe import MoETransformerEncoder
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=["--common.config-file", os.path.join(REPO, yaml)])
    setattr(opts, "common.finetune", None)  # a /mnt checkpoint, data not a part
    with torch.device("meta"):
        model = get_model(opts, device="meta")
    if "moe" in yaml:
        blocks = [getattr(model, f"transformer_{i}") for i in range(model.n_layers)]
        assert [isinstance(b, MoETransformerEncoder) for b in blocks] == [i % 2 == 1
                                                                        for i in range(12)]
    elif "video" in yaml:
        assert model.temporal and model.classifier.out_features == 400
    else:
        assert model.encoder.patch_emb_0.conv.stride == (4, 4) and item == "item 5"
