"""Shared set-up for the tests that hold the PyTorch port against the JAX package:
one flag list parsed by both parsers, a flax model (MobileViTv2, ViT, DeepLabv3
or Swin) initialised and perturbed from a numpy seed, and its weights copied
into the port's model."""

from __future__ import annotations

import contextlib

import numpy as np

# MobileViTv2 at width 0.5 with the flagship's layer settings, 13 classes
SMALL_MODEL_ARGS = [
    "--model.classification.name", "mobilevit_v2",
    "--model.classification.n-classes", "13",
    "--model.classification.mitv2.width-multiplier", "0.5",
    "--model.activation.name", "swish",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--dataset.category", "classification",
]

# the micro ViT (E = 64, 2 blocks, 4 heads of 16) with vit.yaml's layer settings,
# 13 classes; at 64×64 the stem gives 16 tokens, so the 196-entry positional
# table is resampled
VIT_MICRO_ARGS = [
    "--model.classification.name", "vit",
    "--model.classification.n-classes", "13",
    "--model.classification.vit.mode", "micro",
    "--model.activation.name", "gelu",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--dataset.category", "classification",
]


# the micro Swin: embed 48, one pair of blocks a stage, heads 3/6/12/24 (D = 16,
# a head dim the window kernels take, so its blocks reach the fused route),
# window 7, with swin.yaml's layer settings, 13 classes and stochastic depth 0
# (the two packages draw their drop masks from different generators); the
# "micro" mode exists only inside ``micro_swin_modes``
SWIN_MICRO_ARGS = [
    "--model.classification.name", "swin",
    "--model.classification.n-classes", "13",
    "--model.classification.swin.mode", "micro",
    "--model.classification.swin.stochastic-depth-prob", "0",
    "--model.activation.name", "gelu",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "trunc_normal",
    "--model.layer.linear-init-std-dev", "0.02",
    "--dataset.category", "classification",
]
SWIN_MICRO_MODE = (48, [2, 2, 2, 2], [3, 6, 12, 24])


@contextlib.contextmanager
def micro_swin_modes():
    """Both packages' Swin ``_MODES`` with a "micro" entry (no file edited)."""
    import pytest

    from cvnets_tpu.models.classification import swin_transformer as jax_swin
    from cvnets_tpu_torch.models.classification import swin_transformer as port_swin

    with pytest.MonkeyPatch.context() as mp:
        for module in (jax_swin, port_swin):
            mp.setitem(module._MODES, "micro", SWIN_MICRO_MODE)
        yield


# DeepLabv3 on MobileViTv2 at width 0.5 with deeplabv3_mobilevitv2.yaml's head and
# loss settings, cut to 13 classes and a 32-channel ASPP, dropouts 0; append
# "--model.segmentation.output-stride" and 8 or 16
DEEPLAB_MICRO_ARGS = [
    "--dataset.category", "segmentation",
    "--model.segmentation.name", "encoder_decoder",
    "--model.segmentation.n-classes", "13",
    "--model.segmentation.seg-head", "deeplabv3",
    "--model.segmentation.use-aux-head",
    "--model.segmentation.deeplabv3.aspp-out-channels", "32",
    "--model.segmentation.deeplabv3.aspp-dropout", "0",
    "--model.segmentation.classifier-dropout", "0",
    "--model.segmentation.aux-dropout", "0",
    "--model.classification.name", "mobilevit_v2",
    "--model.classification.mitv2.width-multiplier", "0.5",
    "--model.activation.name", "relu",
    "--model.layer.conv-init", "kaiming_normal",
    "--loss.category", "segmentation",
    "--loss.segmentation.name", "cross_entropy",
    "--loss.segmentation.cross-entropy.aux-weight", "0.4",
    "--loss.segmentation.cross-entropy.ignore-index", "255",
]


def seg_targets(rng: np.random.Generator, batch: int, size: int, n_classes: int = 13
                ) -> np.ndarray:
    """Random labels with 5% of the pixels ignored (255), as bench_tasks.py makes
    them."""
    y = rng.integers(0, n_classes, (batch, size, size))
    return np.where(rng.random((batch, size, size)) < 0.05, 255, y)


def both_opts(args):
    from cvnets_tpu.options.opts import get_training_arguments as jax_args
    from cvnets_tpu_torch.options.opts import get_training_arguments as torch_args

    return jax_args(args=list(args)), torch_args(args=list(args))


def perturbed_variables(model, x_nhwc: np.ndarray, seed: int = 0,
                        init_kwargs=None) -> dict:
    """flax variables as numpy, moved off their init values (zero biases, unit
    scales, (0, 1) BN stats) so that a leaf landing in the wrong place shows.
    ``init_kwargs`` (default ``training=False``) go to ``model.init``;
    ``x_nhwc`` may be a dict of arrays (CLIP's image and text)."""
    import jax
    import jax.numpy as jnp

    kwargs = {"training": False} if init_kwargs is None else init_kwargs
    variables = jax.jit(lambda x: model.init(
        {"params": jax.random.PRNGKey(seed), "dropout": jax.random.PRNGKey(seed)},
        x, **kwargs))(jax.tree_util.tree_map(jnp.asarray, x_nhwc))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name == "var":
            return leaf * (1.0 + 0.1 * rng.random(leaf.shape, dtype=np.float32))
        if name in ("mean", "bias", "scale"):
            return leaf + 0.05 * rng.standard_normal(leaf.shape).astype(np.float32)
        return leaf

    # "moe_loss" holds what MoE layers sowed during init, not variables
    return {col: jax.tree_util.tree_map_with_path(perturb, tree)
            for col, tree in variables.items() if col != "moe_loss"}


def port_model_from(opts_torch, variables: dict):
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    model = get_model(opts_torch, device="cpu")
    load_jax_params(model, variables["params"], variables.get("batch_stats"))
    return model


def reference_names(state_dict: dict) -> dict:
    """The same tensors in the same order under another naming scheme, as a
    published CVNets checkpoint names its modules otherwise: one
    ``module.blocks.<i>`` a module, the leaf name kept."""
    modules, out = {}, {}
    for key, value in state_dict.items():
        prefix, leaf = key.rsplit(".", 1)
        out[f"module.blocks.{modules.setdefault(prefix, len(modules))}.{leaf}"] = value.clone()
    return out


def nchw(x_nhwc: np.ndarray):
    import torch

    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


# a micro MobileViTv2 Trainer run: the flagship's AdamW, EMA and stats
# (val loss/top-1/top-5, checkpoints ranked by top-1, highest best) on 64×64
TRAINER_MICRO_ARGS = SMALL_MODEL_ARGS + [
    "--optim.name", "adamw",
    "--optim.weight-decay", "0.05",
    "--optim.no-decay-bn-filter-bias",
    "--common.grad-clip", "10",
    "--ema.enable",
    "--ema.momentum", "0.1",
    "--scheduler.name", "cosine",
    "--scheduler.max-epochs", "3",
    "--scheduler.warmup-iterations", "2",
    "--scheduler.warmup-init-lr", "1e-4",
    "--scheduler.cosine.max-lr", "0.002",
    "--scheduler.cosine.min-lr", "0.0002",
    "--stats.val", "loss", "top1", "top5",
    "--stats.checkpoint-metric", "top1",
    "--stats.checkpoint-metric-max",
]


def uint8_batches(seed: int, n: int, batch: int = 4, size: int = 64, n_classes: int = 13):
    """``n`` loader batches of NCHW uint8 pixels and labels from a numpy seed."""
    import torch

    rng = np.random.default_rng(seed)
    return [{"samples": nchw(rng.integers(0, 256, (batch, size, size, 3)).astype(np.uint8)),
             "targets": torch.from_numpy(rng.integers(0, n_classes, (batch,)))}
            for _ in range(n)]


@contextlib.contextmanager
def torch_threads(n: int = 2):
    """torch's CPU ops on ``n`` threads inside (restored after): the suite's
    xdist workers share the machine's cores, and a whole Trainer or
    ``main_train`` run on every core of each spins the others' threads
    (measured: past 300 s against 16 s for one run beside five others)."""
    import torch

    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def register_port_dummy_dataset() -> None:
    """Register ``dummy_classification`` in the port's dataset registry (once): the
    port's copy of tests/dummy_datasets/classification.py. It reads no files:
    sample i is a seeded uint8 HWC image of one of a few sizes around 64 px, so
    the port's transforms (random resized crop, flip, resize, center crop) run on
    it; labels cycle through the classes. 16 training samples, 8 validation ones."""
    from cvnets_tpu_torch.data.datasets import DATASET_REGISTRY
    from cvnets_tpu_torch.data.datasets.classification.base_image_classification_dataset \
        import BaseImageClassificationDataset

    if ("dummy_classification", "classification") in DATASET_REGISTRY:
        return

    @DATASET_REGISTRY.register(name="dummy_classification", type="classification")
    class PortDummyClassificationDataset(BaseImageClassificationDataset):
        def _find_samples(self):
            n_classes = getattr(self.opts, "model.classification.n_classes", None) or 10
            self.classes = [str(c) for c in range(n_classes)]
            return [(None, i % n_classes) for i in range(16 if self.is_training else 8)]

        def image_size(self, idx):
            return 48 + 9 * (idx % 4), 60 + 7 * (idx % 3)

        def read_image(self, idx):
            rng = np.random.default_rng(idx)
            return rng.integers(0, 256, (*self.image_size(idx), 3), dtype=np.uint8)


def blob_mask(rng: np.random.Generator, h: int, w: int, n_labels: int,
              grid: tuple = (4, 5)) -> np.ndarray:
    """A uint8 (h, w) mask of a coarse grid of random labels scaled up by
    nearest neighbour: regions, so that resizing and crop retries act as on
    real masks (per-pixel noise would leave them nothing to keep)."""
    coarse = rng.integers(0, n_labels, grid).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    return coarse[yy * grid[0] // h, xx * grid[1] // w]


def register_port_dummy_segmentation_dataset() -> None:
    """Register ``dummy_segmentation`` in the port's dataset registry (once): the
    port's counterpart of tests/dummy_datasets/segmentation.py. It reads no
    files: sample i is a seeded uint8 HWC image of one of a few sizes around
    64 px and a blob mask of raw labels 0..n_classes (0 the ADE20k-style
    "other", read as the ignore label, the rest shifted down by one), so the
    real segmentation transforms run on it. 8 training samples, 4 validation
    ones; the number of classes is the options' (5 without one)."""
    from cvnets_tpu_torch.data.datasets import DATASET_REGISTRY
    from cvnets_tpu_torch.data.datasets.segmentation.ade20k import ADE20KDataset

    if ("dummy_segmentation", "segmentation") in DATASET_REGISTRY:
        return

    @DATASET_REGISTRY.register(name="dummy_segmentation", type="segmentation")
    class PortDummySegmentationDataset(ADE20KDataset):
        def __init__(self, opts, *args, **kwargs) -> None:
            super().__init__(opts, *args, **kwargs)
            self.n_seg_classes = getattr(opts, "model.segmentation.n_classes", None) or 5
            n = 8 if self.is_training else 4
            self.images, self.masks = [None] * n, [None] * n

        def image_size(self, idx):
            return 56 + 13 * (idx % 3), 70 + 9 * (idx % 2)

        def read_image(self, idx):
            rng = np.random.default_rng([idx, int(self.is_training)])
            return rng.integers(0, 256, (*self.image_size(idx), 3), dtype=np.uint8)

        def read_mask(self, idx):
            rng = np.random.default_rng([idx, int(self.is_training), 1])
            return blob_mask(rng, *self.image_size(idx), self.n_seg_classes + 1)


# the flagship yaml on the port's dummy dataset at a CPU test's scale: 64 px crops
# (72 then 64 for validation), batch 4, 2 epochs, 2 loader threads
FLAGSHIP_DUMMY_OVERRIDES = [
    "dataset.name=dummy_classification",
    "dataset.train_batch_size0=4",
    "dataset.val_batch_size0=4",
    "dataset.eval_batch_size0=4",
    "dataset.workers=2",
    "sampler.bs.crop_size_width=64",
    "sampler.bs.crop_size_height=64",
    "image_augmentation.resize.size=72",
    "image_augmentation.center_crop.size=64",
    "scheduler.max_epochs=2",
]


# the conv families' tests: float32 on the CPU, the same perturbed weights and
# inputs in both packages, 13 classes. Tolerances, as the existing model tests
# state them: logits to LOGIT_ATOL of max(1, the largest logit), BN running
# statistics to 2e-4 of each leaf's largest value, grads to 5e-4 of the largest
# grad (batch-statistic BN amplifies the f32 noise floor layer by layer; see
# tests/test_torch_mobilevit_v2.py)
LOGIT_ATOL = 1e-4
CONV_FAMILY_ARGS = [
    "--model.classification.n-classes", "13",
    "--model.layer.conv-init", "kaiming_normal",
    "--model.layer.linear-init", "normal",
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--dataset.category", "classification",
]


def jax_outputs(jmodel, variables: dict, x: np.ndarray, y: np.ndarray, opts_jax) -> dict:
    """The JAX model's eval logits, and in one train forward its logits, new BN
    statistics, label-smoothed CE loss and parameter grads (numpy leaves)."""
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.loss import build_loss_fn

    crit = build_loss_fn(opts_jax)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    eval_logits = jax.jit(lambda v: jmodel.apply(v, xj, training=False))(variables)

    def loss_fn(params):
        pred, new = jmodel.apply({**variables, "params": params}, xj, training=True,
                                 mutable=["batch_stats"],
                                 rngs={"dropout": jax.random.PRNGKey(0)})
        return crit(xj, pred, yj, training=True), (pred, new)

    def eval_loss_fn(params):
        pred = jmodel.apply({**variables, "params": params}, xj, training=False)
        return crit(xj, pred, yj, training=True)

    (loss, (pred, new)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"eval": np.asarray(eval_logits), "train": np.asarray(pred),
            "stats": as_np(new.get("batch_stats", {})), "loss": float(loss),
            "grads": as_np(grads),
            "eval_grads": as_np(jax.jit(jax.grad(eval_loss_fn))(variables["params"]))}


def port_outputs(opts_torch, variables: dict, x: np.ndarray, y: np.ndarray,
                 prepare=None) -> dict:
    """The same outputs of the port's model filled from ``variables``;
    ``prepare(model)`` runs on each model after loading."""
    import torch

    from cvnets_tpu_torch.loss import build_loss_fn

    crit = build_loss_fn(opts_torch)
    out = {}
    for mode in ("eval", "train"):
        model = port_model_from(opts_torch, variables)
        if prepare is not None:
            prepare(model)
        pred = model.train(mode == "train")(nchw(x))
        loss = crit(None, pred, torch.from_numpy(y), training=True)
        loss.backward()
        grads = {k: p.grad for k, p in model.named_parameters()}
        out.update({mode: pred.detach().numpy(),
                    "eval_grads" if mode == "eval" else "grads": grads})
    return {**out, "state": model.state_dict(), "loss": loss.item()}


@contextlib.contextmanager
def jax_in_float64(opts_jax):
    """The JAX package's models compute in float64 while the block runs: its
    layers take their dtype from ``compute_dtype(opts)``, float32 unless mixed
    precision names another, so ``opts_jax`` names float64 (a name its table
    gains for the block) and jax runs with 64-bit types."""
    import jax
    import jax.numpy as jnp

    from cvnets_tpu.layers import dtype_utils

    setattr(opts_jax, "common.mixed_precision", True)
    setattr(opts_jax, "common.mixed_precision_dtype", "float64")
    dtype_utils._DTYPES["float64"] = jnp.float64
    try:
        with jax.enable_x64(True):
            yield
    finally:
        del dtype_utils._DTYPES["float64"]


def float64_outputs(opts_jax, opts_torch, variables: dict, x: np.ndarray, y: np.ndarray,
                    prepare=None) -> tuple[dict, dict]:
    """``jax_outputs`` and ``port_outputs`` with every weight, input and
    operation in float64 on both sides (``opts_jax`` is changed)."""
    import jax

    from cvnets_tpu.models import get_model

    x64 = x.astype(np.float64)
    with jax_in_float64(opts_jax):
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        want = jax_outputs(get_model(opts_jax), v64, x64, y, opts_jax)

    def to_float64(model):
        if prepare is not None:
            prepare(model)
        model.double()

    return want, port_outputs(opts_torch, variables, x64, y, prepare=to_float64)


def flat_leaves(tree: dict):
    """(flax path, numpy leaf) of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            for path, leaf in flat_leaves(v):
                yield (k,) + path, leaf
        else:
            yield (k,), np.asarray(v)


def assert_logits_match(got: np.ndarray, want: np.ndarray) -> None:
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_ATOL * max(1.0, float(np.abs(want).max())))


def assert_stats_match(state: dict, stats: dict) -> None:
    from cvnets_tpu_torch.utils.jax_params import torch_key

    leaves = list(flat_leaves(stats))
    assert leaves
    for path, leaf in leaves:
        key = torch_key(path)
        np.testing.assert_allclose(state[key].numpy(), leaf, rtol=0,
                                   atol=2e-4 * float(np.abs(leaf).max()), err_msg=key)


def assert_loss_matches(got: float, want: float, logits: np.ndarray) -> None:
    """A CE loss moves by at most twice the largest change of a logit (its
    gradient p - t sums to at most 2 in magnitude), so the logits' bound sets
    the loss's."""
    assert abs(got - want) <= 2 * LOGIT_ATOL * max(1.0, float(np.abs(logits).max()))


def assert_grads_match(grads: dict, jgrads: dict, rel: float = 5e-4) -> None:
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    leaves = list(flat_leaves(jgrads))
    assert len(leaves) == len(grads)
    gmax = max(float(np.abs(g).max()) for _, g in leaves)
    for path, g in leaves:
        key = torch_key(path)
        np.testing.assert_allclose(grads[key].numpy(), to_torch_layout(path, g), rtol=0,
                                   atol=rel * gmax, err_msg=key)


def assert_every_leaf_loaded(model, variables: dict) -> None:
    """Each flax leaf sits, in torch's layout, in the tensor of its name, and
    the model has no parameter or buffer beyond them but BN's counters."""
    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    state = model.state_dict()
    seen = set()
    for col in ("params", "batch_stats"):
        for path, leaf in flat_leaves(variables.get(col, {})):
            key = torch_key(path)
            np.testing.assert_array_equal(state[key].numpy(), to_torch_layout(path, leaf),
                                          err_msg=key)
            seen.add(key)
    assert sorted(k for k in state if not k.endswith("num_batches_tracked")) == sorted(seen)


def jax_leaf_shapes(jmodel) -> dict:
    """{torch key: torch-layout shape} of every param and batch-stat leaf of a
    JAX model, from ``jax.eval_shape`` (no weights drawn; the conv families'
    shapes do not depend on the input's size)."""
    import jax
    import jax.numpy as jnp

    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                                jnp.zeros((1, 64, 64, 3))))
    out = {}
    for col in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_flatten_with_path(shapes.get(col, {}))[0]:
            path = tuple(p.key for p in path)
            out[torch_key(path)] = to_torch_layout(path, np.empty(leaf.shape)).shape
    return out


def port_shapes(model) -> dict:
    """{key: shape} of every parameter and buffer but BN's counters."""
    return {k: tuple(v.shape) for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked")}


def assert_end_points_match(args, model_name: str, output_stride: int, size: int = 64):
    """The tap points out_l1 .. out_l5 of the JAX encoder and the port's at
    ``output_stride``, in train mode (batch statistics through every dilated
    conv), to 1e-4 of max(1, each tap's largest value); returns the port's."""
    import jax
    import jax.numpy as jnp
    import torch

    from cvnets_tpu.models import get_model as jax_model
    from cvnets_tpu_torch.models import MODEL_REGISTRY
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    opts_jax, opts_torch = both_opts(args)
    x = np.random.default_rng(1).standard_normal((2, size, size, 3)).astype(np.float32)
    jmodel = jax_model(opts_jax).clone(output_stride=output_stride)
    variables = perturbed_variables(jmodel, x, seed=1)
    want = jax.jit(lambda v: jmodel.apply(
        v, jnp.asarray(x), training=True, mutable=["batch_stats"],
        method=lambda m, a, training: m.extract_end_points_all(a, training=training))[0]
    )(variables)
    model = MODEL_REGISTRY[model_name, "classification"].build_model(
        opts_torch, output_stride=output_stride)
    load_jax_params(model, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        got = model.train().extract_end_points_all(nchw(x))
    assert sorted(got) == sorted(want)
    for name, ref in want.items():
        ref = np.asarray(ref).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got[name].numpy(), ref, rtol=0,
                                   atol=1e-4 * max(1.0, float(np.abs(ref).max())),
                                   err_msg=name)
    return model, got


def checkpointing_runs(args, batches, flag: str = "--model.classification.gradient-checkpointing",
                       extra_on=()):
    """Two train steps of the port's model (AdamW, clip 10, EMA) on
    ``batches`` (a list of {"samples", "targets"}) with ``flag`` off and on,
    from one seed: {"off"|"on": (losses, the last step's grads, the state
    dict, the EMA's state dict)}."""
    import torch

    from cvnets_tpu_torch.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.options.opts import get_training_arguments

    step_args = ["--optim.name", "adamw", "--optim.weight-decay", "0.05",
                 "--optim.no-decay-bn-filter-bias", "--common.grad-clip", "10",
                 "--ema.enable", "--ema.momentum", "0.1"]
    out = {}
    for mode, more in (("off", []), ("on", [flag, *extra_on])):
        opts = get_training_arguments(args=list(args) + step_args + more)
        torch.manual_seed(0)  # dropout and stochastic depth draw from torch's generator
        model = get_model(opts, device="cpu")
        state = create_train_state(model, build_optimizer(opts, model), ema_enabled=True)
        step = make_train_step(model, build_loss_fn(opts, device="cpu"), opts,
                               build_metrics(opts, ["loss"]))
        losses = []
        for batch in batches:
            state, metrics = step(state, batch, 1e-3)
            losses.append(metrics["loss"]["loss"][0].item())
        out[mode] = (losses, {k: p.grad.clone() for k, p in model.named_parameters()},
                     {k: v.clone() for k, v in model.state_dict().items()},
                     {k: v.clone() for k, v in state.ema.model.state_dict().items()})
    return out


def assert_checkpointing_changes_nothing(runs) -> None:
    """The losses, the grads, the parameters, the BN statistics (and their
    step counters) and the EMA of the run with checkpointing are those of
    the run without it, bit for bit."""
    import torch

    (losses, grads, state, ema), (losses_on, grads_on, state_on, ema_on) = (
        runs["off"], runs["on"])
    assert losses == losses_on
    for want, got in ((grads, grads_on), (state, state_on), (ema, ema_on)):
        assert sorted(want) == sorted(got)
        for key in want:
            assert torch.equal(want[key], got[key]), key


def flags_differ_from_yaml(flag_opts, yaml_path: str) -> list:
    """The option dests where ``flag_opts`` (chip_smoke.py's flags for a yaml;
    the card machine has no PyYAML) and the yaml, parsed by the port, differ
    (a one-entry list from a ``nargs="+"`` flag counts as the yaml's scalar)."""
    from cvnets_tpu_torch.options.opts import get_training_arguments

    def scalar(v):
        return v[0] if isinstance(v, list) and len(v) == 1 else v

    flags = vars(flag_opts)
    yaml = vars(get_training_arguments(args=["--common.config-file", yaml_path]))
    return sorted(k for k in yaml if scalar(yaml[k]) != scalar(flags[k]))


# ---- model parallelism: train steps on a (data, model) grid of gloo ranks ----
# micro ViT steps: SGD without momentum (the JAX model-parallel tests' bound of
# 5e-4 on the parameters after one step, 1e-4 relative on the loss), and AdamW
# with EMA and accumulation (test_torch_distributed's bounds)
MP_SGD_ARGS = [
    "--loss.classification.cross-entropy.label-smoothing", "0.1",
    "--optim.name", "sgd", "--optim.sgd.momentum", "0", "--optim.weight-decay", "0",
]
MP_SGD_LR = 0.05
MP_SPAWN_TIMEOUT_S = 240


def mp_rows(batch: int, accum: int, data: int, index: int) -> np.ndarray:
    """Data rank ``index``'s rows of a global batch: its share of each of JAX's
    contiguous micro-batches."""
    micro = batch // accum
    per = micro // data
    return np.concatenate([np.arange(i * micro + index * per, i * micro + (index + 1) * per)
                           for i in range(accum)])


def mp_grid_opts(args, shape, extra=()):
    """The port's options with ``--dev.mesh-shape``, and the grid formed on them."""
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.parallel import mesh

    opts = get_training_arguments(args=list(args) + ["--dev.mesh-shape", *map(str, shape),
                                                     *extra])
    mesh.form_grid(opts)
    return opts


def mp_steps(opts, state_dict: dict, xs, ys, lrs, accum: int = 1, shard: bool = True,
             seed=None) -> dict:
    """The port's train steps from ``state_dict`` on this rank's rows of each
    global batch (all of them outside a group): whole parameters and EMA after
    each step (gathered from the shards), the rank's loss and the global grad
    norm, and the shards' sizes and state bytes. ``seed``: torch's default
    generator seeded before the first step (a model with dropout)."""
    import torch

    from cvnets_tpu_torch.engine import train_state as port
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.parallel import mesh
    from cvnets_tpu_torch.parallel.fsdp import shard_train_state

    model = get_model(opts, device="cpu")
    model.load_state_dict(state_dict)
    state = port.create_train_state(model, build_optimizer(opts, model),
                                    ema_enabled=getattr(opts, "ema.enable", False))
    if shard:
        shard_train_state(opts, state)
    step = port.make_train_step(model, build_loss_fn(opts), opts,
                                build_metrics(opts, ["loss", "grad_norm"]))
    g = mesh.grid()
    rows = mp_rows(len(ys[0]), accum, g.data, g.data_index)
    if seed is not None:
        torch.manual_seed(seed)
    out = {"steps": []}
    for x, y, lr in zip(xs, ys, lrs):
        batch = {"samples": nchw(x[rows]), "targets": torch.from_numpy(y[rows])}
        state, metrics = step(state, batch, lr)
        if shard:
            sd, ema = state.shards.full_state_dict(), (
                state.shards.full_state_dict(use_ema=True) if state.ema is not None else {})
        else:
            sd = model.state_dict()
            ema = state.ema.model.state_dict() if state.ema is not None else {}
        out["steps"].append(({k: v.clone() for k, v in sd.items()},
                             {k: v.clone() for k, v in ema.items()},
                             float(metrics["loss"]["loss"][0]),
                             float(metrics["grad_norm"]["grad_norm"][0])))
    if shard:
        out["shapes"] = {leaf.name: tuple(leaf.storage.shape) for leaf in state.shards.leaves}
        out["bytes"] = state.shards.state_bytes(state.optimizer)
        out["moments"] = {leaf.name: tuple(state.optimizer.state[leaf.storage]["exp_avg"].shape)
                          for leaf in state.shards.leaves
                          if "exp_avg" in state.optimizer.state.get(leaf.storage, {})}
    return out


def mp_global_loss(ranks: list, step: int, data: int, model: int) -> float:
    """The global batch's loss of a step: the mean of the data ranks' (each
    model rank of a data index holds the same)."""
    return sum(ranks[d * model]["steps"][step][2] for d in range(data)) / data


def mp_spawn(fn, world: int, args: tuple):
    """``fn(index, *args)`` in ``world`` gloo ranks (not joined)."""
    from cvnets_tpu_torch import parallel

    return parallel.spawn(fn, world, args, timeout_s=MP_SPAWN_TIMEOUT_S, join=False)


def mp_init(index: int, world: int, store: str) -> None:
    import torch

    from cvnets_tpu_torch.parallel import mesh

    torch.set_num_threads(1)
    mesh.init_group("gloo", index, world, f"file://{store}", timeout_s=MP_SPAWN_TIMEOUT_S)


def assert_sgd_step_matches(got_sd: dict, jax_state, loss: float, jloss: float) -> None:
    """One SGD step against JAX's: the loss to 1e-4 relative, every parameter
    to 5e-4 (tests/test_tensor_parallel.py's and test_fsdp.py's bounds)."""
    import pytest

    assert loss == pytest.approx(jloss, rel=1e-4)
    worst = max(float(np.abs(got - want).max())
                for _, want, got in mp_pairs(jax_state.params, got_sd))
    assert worst < 5e-4, worst


def mp_pairs(tree, state_dict):
    """(torch key, flax leaf in torch layout, port tensor) for every leaf."""
    import jax

    from cvnets_tpu_torch.utils.jax_params import to_torch_layout, torch_key

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = tuple(p.key for p in path)
        key = torch_key(path)
        yield key, to_torch_layout(path, np.asarray(leaf)), state_dict[key].numpy()
