"""Int8 inference in the PyTorch port against the JAX package's
cvnets_tpu/quantization on the same weights and inputs (numpy, seeded), float32
on the CPU: ``quantize_symmetric``'s codes and scales, ``Int8Conv`` and
``Int8Dense`` in both modes, the choice of int8 layers in micro ViT,
MobileViTv2, Swin and FastViT (by path, against the ``qscales`` of JAX's
``prequantize_variables``) and their int8 logits, ``load_jax_params`` of a
prequantized JAX tree, a float checkpoint into an int8 model, ``main_eval``
under the flag, and ``main_train``'s refusal of it.

Tolerances: weight-only layers are float layers on the dequantized weight, so
they are held as the float tests hold them (1e-5 of the output's largest value
for one layer, the models' 1e-4 of max(1, the largest logit)). A dynamic layer
sums int8 codes exactly in int32 on both sides; its output differs only where
an activation code lands on the other side of a rounding tie (the quotient
x / scale is one float32 division on both sides), so one layer is held to 1e-5
of its largest value with at least 99.9% of the codes identical, and a whole
model, whose float32 noise can move a code in a later layer, to 2e-3 of
max(1, the largest logit). A dynamic model is held in two ways: every int8
layer on its own input in the JAX model's jitted eval forward (captured with
``flax.linen.intercept_methods``) against its output there, at the one
layer's tolerance; and the logits, where float32 noise upstream moves a code in
a later layer now and then and its step travels on, to 1e-2 of max(1, the
largest logit) (1.6e-3 to 2.3e-3 measured on the micro Swin and ViT)."""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    CONV_FAMILY_ARGS,
    SMALL_MODEL_ARGS,
    SWIN_MICRO_ARGS,
    VIT_MICRO_ARGS,
    both_opts,
    micro_swin_modes,
    nchw,
    perturbed_variables,
    port_model_from,
    torch_threads,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

MODES = ("weight-only", "dynamic")
MODEL_ATOL = {"weight-only": 1e-4, "dynamic": 1e-2}
FASTVIT_SA12_ARGS = ["--model.classification.name", "fastvit",
                     "--model.classification.fastvit.variant", "SA12",
                     "--model.activation.name", "gelu", *CONV_FAMILY_ARGS]
MODELS = {"vit": VIT_MICRO_ARGS, "mobilevit_v2": SMALL_MODEL_ARGS, "swin": SWIN_MICRO_ARGS,
          "fastvit": FASTVIT_SA12_ARGS}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(autouse=True, scope="module")
def _micro_swin():
    with micro_swin_modes():
        yield


def int8_args(args, mode: str) -> list:
    return list(args) + ["--common.int8-inference", "--common.int8-mode", mode]


@pytest.mark.parametrize("shape, axes, dims", [
    ((3, 3, 8, 16), (0, 1, 2), (1, 2, 3)),  # a conv kernel HWIO / weight OIHW
    ((24, 40), (0,), (1,)),                 # a Dense kernel (in, out) / Linear (out, in)
], ids=["conv", "dense"])
def test_quantize_symmetric_gives_the_jax_codes_and_scales(shape, axes, dims):
    """Codes and scales equal bit for bit to the jitted JAX function's (how
    every JAX path runs it; see the port's module docstring), on weights that
    include an all-zero output channel and values near the .5 rounding ties."""
    from cvnets_tpu.quantization import quantize_symmetric as jax_quantize
    from cvnets_tpu_torch.quantization import quantize_symmetric
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout

    rng = np.random.default_rng(0)
    kernel = rng.standard_normal(shape).astype(np.float32)
    kernel[..., 0] = 0.0
    # a channel of whole multiples of absmax / 254: every code a .5 tie
    kernel[..., 1] = (rng.integers(-254, 255, shape[:-1]) / 254.0).astype(np.float32)
    kernel.reshape(-1, shape[-1])[0, 1] = 1.0
    jq, js = (np.asarray(a) for a in jax.jit(lambda k: jax_quantize(k, axes))(
        jnp.asarray(kernel)))
    q, s = quantize_symmetric(torch.from_numpy(to_torch_layout(("kernel",), kernel).copy()),
                              dims)
    path = ("kernel",)
    np.testing.assert_array_equal(q.numpy(), to_torch_layout(path, jq))
    np.testing.assert_array_equal(s.numpy(), to_torch_layout(path, js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert (q.numpy()[0] == 0).all()


def _jax_codes(x_nhwc, per_row: bool):
    from cvnets_tpu.quantization import _quantize_activation_per_sample, _quantize_activation_rows

    fn = _quantize_activation_rows if per_row else _quantize_activation_per_sample
    return np.asarray(jax.jit(fn)(jnp.asarray(x_nhwc))[0])


def _assert_dynamic_close(got, want, codes_got, codes_want):
    same = float(np.mean(codes_got == codes_want))
    assert same >= 0.999, same
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("kernel, stride, dilation, bias", [
    (1, 1, 1, True), (3, 2, 1, False), (3, 1, 2, True)], ids=["1x1", "3x3_s2", "3x3_d2"])
def test_int8_conv_matches_jax(kernel, stride, dilation, bias, mode):
    from cvnets_tpu.quantization import Int8Conv as JaxConv
    from cvnets_tpu_torch.quantization import Int8Conv, _codes
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    rng = np.random.default_rng(kernel * 10 + stride + dilation)
    x = rng.standard_normal((3, 13, 13, 12)).astype(np.float32)
    pad = (kernel - 1) // 2 * dilation
    jconv = JaxConv(features=24, kernel_size=(kernel, kernel), strides=(stride, stride),
                    padding=((pad, pad), (pad, pad)), kernel_dilation=(dilation, dilation),
                    use_bias=bias, mode=mode)
    variables = perturbed_variables(jconv, x, init_kwargs={})
    want = np.asarray(jconv.apply(variables, jnp.asarray(x))).transpose(0, 3, 1, 2)
    conv = Int8Conv(12, 24, kernel, stride=stride, padding=pad, dilation=dilation, bias=bias,
                    mode=mode).eval()
    load_jax_params(conv, variables["params"])
    with torch.no_grad():
        got = conv(nchw(x)).numpy()
    assert got.shape == want.shape
    if mode == "weight-only":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
        assert conv.int_mm_calls == 0
    else:
        codes = _codes(nchw(x), (1, 2, 3))[0].numpy().transpose(0, 2, 3, 1)
        _assert_dynamic_close(got, want, codes, _jax_codes(x, per_row=False))
        assert conv.int_mm_calls == 1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("bias", [True, False])
def test_int8_dense_matches_jax(bias, mode):
    """On (B, S, in) tokens; the out width 20 is no multiple of 8 and the depth
    36 neither (the CUDA product pads them; here the CPU's takes them)."""
    from cvnets_tpu.quantization import Int8Dense as JaxDense
    from cvnets_tpu_torch.quantization import Int8Dense, _codes
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    rng = np.random.default_rng(int(bias))
    x = rng.standard_normal((2, 5, 36)).astype(np.float32)
    jdense = JaxDense(features=20, use_bias=bias, mode=mode)
    variables = perturbed_variables(jdense, x, init_kwargs={})
    want = np.asarray(jdense.apply(variables, jnp.asarray(x)))
    dense = Int8Dense(36, 20, bias=bias, mode=mode).eval()
    load_jax_params(dense, variables["params"])
    with torch.no_grad():
        got = dense(torch.from_numpy(x)).numpy()
    if mode == "weight-only":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * float(np.abs(want).max()))
    else:
        codes = _codes(torch.from_numpy(x), (-1,))[0].numpy()
        _assert_dynamic_close(got, want, codes, _jax_codes(x, per_row=True))


def test_int8_matmul_pads_to_the_cuda_product_shapes_exactly(monkeypatch):
    """The padding the CUDA product needs (rows past 16, depth and width to
    multiples of 8) changes no sum: checked on the CPU by padding there too."""
    from cvnets_tpu_torch import quantization

    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-127, 128, (5, 27), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (13, 27), dtype=np.int8))
    want = a.int() @ w.int().t()
    shapes = []
    real = torch._int_mm

    def spy(x, y):
        shapes.append((tuple(x.shape), tuple(y.shape)))
        return real(x, y)

    monkeypatch.setattr(torch, "_int_mm", spy)
    assert torch.equal(quantization.int8_matmul(a, w), want)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    assert torch.equal(quantization.int8_matmul(a, w), want)
    assert shapes == [((5, 27), (27, 13)), ((17, 32), (32, 16))]


def test_a_depthwise_conv_stays_float():
    """ConvLayer2d swaps only groups == 1 convs (conv_layer.py:73-76 in JAX)."""
    from cvnets_tpu_torch.layers.conv_layer import ConvLayer2d
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.quantization import Int8Conv

    opts = get_training_arguments(args=int8_args(SMALL_MODEL_ARGS, "dynamic"))
    dw = ConvLayer2d(opts, 16, 16, 3, groups=16)
    dense = ConvLayer2d(opts, 16, 32, 3)
    assert type(dw.conv) is torch.nn.Conv2d and isinstance(dense.conv, Int8Conv)
    assert dense.conv.mode == "dynamic"


_VARIABLES: dict = {}


def _model_pair(name: str, mode: str, size: int = 64):
    """The JAX model of ``name`` in ``mode``, its perturbed variables (made once
    a model: they do not depend on the mode), the port's options and the input."""
    from cvnets_tpu.models import get_model as jax_get_model

    opts_jax, opts_torch = both_opts(int8_args(MODELS[name], mode))
    x = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    jmodel = jax_get_model(opts_jax)
    if name not in _VARIABLES:
        _VARIABLES[name] = perturbed_variables(jmodel, x)
    return jmodel, _VARIABLES[name], opts_torch, x


def _jax_prequantized(jmodel, variables, x):
    from cvnets_tpu.quantization import prequantize_variables

    pq = prequantize_variables(jmodel, variables, jnp.asarray(x))
    return jax.tree_util.tree_map(np.asarray, pq)


@pytest.mark.parametrize("name", list(MODELS))
def test_the_int8_layers_are_the_jax_qscales_paths(name):
    """The port's Int8Conv and Int8Dense layers by path are the layers JAX's
    prequantize_variables gives a scale, mapped through ``torch_key``."""
    from cvnets_tpu_torch.quantization import int8_layers
    from cvnets_tpu_torch.utils.jax_params import torch_key

    from torch_port_helpers import flat_leaves

    jmodel, variables, opts_torch, x = _model_pair(name, "weight-only",
                                                    size=224 if name == "swin" else 64)
    pq = _jax_prequantized(jmodel, variables, x)
    want = {torch_key(path)[:-len(".weight")] for path, _ in flat_leaves(pq["qscales"])}
    got = set(int8_layers(port_model_from(opts_torch, variables)))
    assert got == want, (sorted(got - want), sorted(want - got))
    assert len(got) > 4


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(MODELS))
def test_int8_logits_match_jax(name, mode):
    """The eval logits of the int8 model (weights quantized at each call)
    against JAX's int8 ``apply``; then both prequantized (JAX's tree loaded
    into the port's prequantized model by ``load_jax_params``) give the same
    logits again, and the same as before prequantizing."""
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.quantization import int8_layers, prequantize
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    size = 224 if name == "swin" else 64
    jmodel, variables, opts_torch, x = _model_pair(name, mode, size=size)
    want = np.asarray(jax.jit(lambda v: jmodel.apply(v, jnp.asarray(x), training=False))(
        variables))
    atol = MODEL_ATOL[mode] * max(1.0, float(np.abs(want).max()))
    model = port_model_from(opts_torch, variables).eval()
    with torch.no_grad():
        got = model(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if mode == "dynamic":
        assert all(m.int_mm_calls > 0 for m in int8_layers(model).values())

    pq = _jax_prequantized(jmodel, variables, x)
    fresh = prequantize(get_model(opts_torch, device="cpu")).eval()
    load_jax_params(fresh, pq["params"], pq.get("batch_stats"), pq["qscales"])
    prequantize(model)
    with torch.no_grad():  # stored codes and scales: the same bits as quantized per call
        np.testing.assert_array_equal(model(nchw(x)).numpy(), got)
    for key, value in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    with torch.no_grad():
        again = fresh(nchw(x)).numpy()
    want_pq = np.asarray(jax.jit(lambda v: jmodel.apply(v, jnp.asarray(x), training=False))(pq))
    np.testing.assert_allclose(again, want_pq, rtol=0, atol=atol)


@pytest.mark.parametrize("name", list(MODELS))
def test_dynamic_layers_match_jax_on_the_models_activations(name):
    """Every int8 layer of the dynamic model, on the input it gets in the JAX
    model's jitted eval forward, against its output there: at least 99.9% of
    the activation codes identical and the output within 1e-5 of its largest
    value."""
    import flax.linen as fnn

    from cvnets_tpu.quantization import Int8Conv as JaxConv
    from cvnets_tpu.quantization import Int8Dense as JaxDense
    from cvnets_tpu_torch.quantization import _codes, int8_layers
    from cvnets_tpu_torch.utils.jax_params import torch_key

    jmodel, variables, opts_torch, x = _model_pair(name, "dynamic",
                                                    size=224 if name == "swin" else 64)
    paths = []

    def forward(v):
        calls = []

        def capture(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, (JaxConv, JaxDense)) and \
                    context.method_name == "__call__":
                paths.append((context.module.path, isinstance(context.module, JaxConv)))
                calls.append((args[0], out))
            return out

        with fnn.intercept_methods(capture):
            jmodel.apply(v, jnp.asarray(x), training=False)
        return calls

    calls = jax.tree_util.tree_map(np.asarray, jax.jit(forward)(variables))
    layers = int8_layers(port_model_from(opts_torch, variables).eval())
    seen = set()
    for (path, conv), (xin, want) in zip(paths, calls):
        key = torch_key(tuple(path) + ("kernel",))[:-len(".weight")]
        xt = nchw(xin) if conv else torch.from_numpy(xin)
        with torch.no_grad():
            got = layers[key](xt).numpy()
        codes = _codes(xt, (1, 2, 3) if conv else (-1,))[0].numpy()
        if conv:
            got, codes = got.transpose(0, 2, 3, 1), codes.transpose(0, 2, 3, 1)
        _assert_dynamic_close(got, want, codes, _jax_codes(xin, per_row=not conv))
        seen.add(key)
    assert seen == set(layers)


def test_prequantize_stores_int8_weights_and_frees_the_float_ones():
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.quantization import int8_layers, prequantize

    model = get_model(get_training_arguments(args=int8_args(VIT_MICRO_ARGS, "weight-only")),
                      device="cpu")
    layers = int8_layers(model)
    float_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    int8_weights = sum(m.weight.numel() for m in layers.values())
    prequantize(model)
    params_after = sum(p.numel() * p.element_size() for p in model.parameters())
    assert float_bytes - params_after == 4 * int8_weights
    for name, layer in layers.items():
        assert layer.weight.dtype == torch.int8 and "weight" not in layer._parameters, name
        assert layer.weight_scale.shape[0] == layer.weight.shape[0]
    sd = model.state_dict()
    assert all(f"{name}.weight_scale" in sd for name in layers)
    with pytest.raises(RuntimeError, match="prequantized"):
        model.train()(torch.zeros(1, 3, 64, 64))


@pytest.mark.parametrize("mode", MODES)
def test_a_float_checkpoint_loads_into_an_int8_model(mode, tmp_path):
    """The int8 model's parameters are named and shaped as the float model's
    (JAX pins the same in tests/test_quantization.py), so a float checkpoint
    loads with strict=True; in training mode the int8 model is the float one."""
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments

    float_model = get_model(get_training_arguments(args=SMALL_MODEL_ARGS), device="cpu")
    path = tmp_path / "float.pt"
    torch.save(float_model.state_dict(), path)
    int8_model = get_model(get_training_arguments(args=int8_args(SMALL_MODEL_ARGS, mode)),
                           device="cpu")
    int8_model.load_state_dict(torch.load(path, weights_only=True))
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    torch.manual_seed(0)
    want = float_model.train()(x)
    torch.manual_seed(0)
    assert torch.equal(int8_model.train()(x), want)


@pytest.mark.parametrize("mode", MODES)
def test_main_eval_prequantizes_and_runs_the_int8_forward(mode, tmp_path, monkeypatch):
    """``main_eval`` under the flag on a float checkpoint: the model it
    evaluates is prequantized (int8 weights, no float copy), a dynamic one
    ran ``torch._int_mm`` in every int8 layer, and its statistics are finite
    and differ from the float model's only by the int8 rounding."""
    from cvnets_tpu_torch import main_eval
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.quantization import int8_layers

    from torch_port_helpers import register_port_dummy_dataset

    register_port_dummy_dataset()
    args = SMALL_MODEL_ARGS + [
        "--dataset.name", "dummy_classification", "--dataset.eval-batch-size0", "4",
        "--dataset.workers", "0", "--sampler.bs.crop-size-width", "32",
        "--sampler.bs.crop-size-height", "32", "--stats.val", "loss", "top1",
        "--image-augmentation.resize.enable", "--image-augmentation.resize.size", "36",
        "--image-augmentation.center-crop.enable", "--image-augmentation.center-crop.size", "32"]
    path = str(tmp_path / "float.pt")
    torch.save(get_model(get_training_arguments(args=args), device="cpu").state_dict(), path)
    built = []
    real = main_eval.prequantize
    monkeypatch.setattr(main_eval, "prequantize", lambda m: built.append(m) or real(m))
    common = ["--model.classification.pretrained", path]
    want = main_eval.main_worker(args=args + common, device="cpu")
    assert not built
    got = main_eval.main_worker(args=args + common + [
        "--common.int8-inference", "--common.int8-mode", mode], device="cpu")
    layers = int8_layers(built[0])
    assert layers and all(m.weight.dtype == torch.int8 for m in layers.values())
    assert all(m.int_mm_calls == (2 if mode == "dynamic" else 0) for m in layers.values())
    assert set(got) == set(want) and all(np.isfinite(v) for v in got.values())
    assert got != want and abs(got["loss"] - want["loss"]) <= 0.05 * abs(want["loss"])


def test_main_train_refuses_int8_inference():
    """Root main_train.py:22-26: the flag is for inference; the JAX logger's
    error raises, and so does the port's."""
    from cvnets_tpu_torch.main_train import main_worker
    from cvnets_tpu_torch.utils.logger import LoggerError

    with pytest.raises(LoggerError, match="int8-inference is an inference-only flag"):
        main_worker(args=SMALL_MODEL_ARGS + ["--common.int8-inference"], device="cpu")
