"""The PyTorch port stands without JAX, and keeps the JAX package's flags.

* ``cvnets_tpu_torch`` imports and runs CPU train steps of MobileViTv2, ViT and
  DeepLabv3 with ``jax``, ``flax``, ``optax``, ``yaml``, ``PIL`` and the JAX
  package ``cvnets_tpu`` blocked (a subprocess: tests/conftest.py has imported
  jax into this one).
* No module of the port, and not ``chip_smoke.py``, imports ``cvnets_tpu``, not
  even a module of it that imports no JAX (checked on the source's syntax tree).
* Every flag of the port's parser exists in the JAX parser with the same dest and
  default, and the flagship yaml parses to the same values in both.
* The scheduler copy gives the JAX scheduler's LRs.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_YAML = os.path.join(REPO, "config/classification/imagenet/mobilevit_v2.yaml")

_BLOCKED_RUN = textwrap.dedent("""
    import sys
    for name in ("jax", "flax", "optax", "yaml", "PIL", "cvnets_tpu"):
        sys.modules[name] = None  # any import of them now raises ImportError
    import torch
    from cvnets_tpu_torch.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.optim.scheduler import build_scheduler
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=[
        "--model.classification.name", "mobilevit_v2",
        "--model.classification.mitv2.width-multiplier", "0.5",
        "--model.classification.n-classes", "10",
        "--optim.name", "adamw", "--ema.enable"])
    model = get_model(opts).eval()
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits = model(x)
    assert logits.shape == (2, 10) and bool(torch.isfinite(logits).all())
    state = create_train_state(model, build_optimizer(opts, model), ema_enabled=True)
    step = make_train_step(model, build_loss_fn(opts), opts)
    state, metrics = step(state, {"samples": x, "targets": torch.tensor([1, 2])},
                          build_scheduler(opts).retrieve_lr(0, 0))
    assert bool(torch.isfinite(metrics["loss"]))
    vit_opts = get_training_arguments(args=[
        "--model.classification.name", "vit", "--model.classification.vit.mode", "micro",
        "--model.classification.n-classes", "10", "--model.activation.name", "gelu",
        "--optim.name", "adamw"])
    vit = get_model(vit_opts)
    state = create_train_state(vit, build_optimizer(vit_opts, vit))
    state, metrics = make_train_step(vit, build_loss_fn(vit_opts), vit_opts)(
        state, {"samples": x, "targets": torch.tensor([1, 2])}, 1e-3)
    assert bool(torch.isfinite(metrics["loss"]))
    seg_opts = get_training_arguments(args=[
        "--dataset.category", "segmentation", "--model.segmentation.name", "encoder_decoder",
        "--model.segmentation.n-classes", "5", "--model.segmentation.output-stride", "16",
        "--model.segmentation.use-aux-head", "--model.segmentation.lr-multiplier", "10",
        "--model.segmentation.deeplabv3.aspp-out-channels", "16",
        "--model.classification.name", "mobilevit_v2",
        "--model.classification.mitv2.width-multiplier", "0.5",
        "--loss.category", "segmentation", "--optim.name", "sgd", "--ema.enable"])
    seg = get_model(seg_opts)
    state = create_train_state(
        seg, build_optimizer(seg_opts, seg, seg.get_lr_multipliers(seg_opts)),
        ema_enabled=True)
    y = torch.randint(0, 5, (2, 64, 64), generator=torch.Generator().manual_seed(1))
    y[0, :8] = 255
    state, metrics = make_train_step(seg, build_loss_fn(seg_opts), seg_opts)(
        state, {"samples": x, "targets": y}, 1e-3)
    assert {"seg_loss", "aux_loss", "total_loss"} <= set(metrics)
    assert bool(torch.isfinite(metrics["loss"]))
    leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                    and m.split(".")[0] in ("jax", "flax", "optax", "yaml", "PIL",
                                            "cvnets_tpu"))
    assert not leaked, leaked
    print("ok")
""")


def test_port_imports_and_runs_without_jax_yaml_or_pil():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def _port_sources():
    yield os.path.join(REPO, "chip_smoke.py")
    for root, _, files in os.walk(os.path.join(REPO, "cvnets_tpu_torch")):
        yield from (os.path.join(root, f) for f in sorted(files) if f.endswith(".py"))


def test_no_port_module_imports_the_jax_package():
    """``import cvnets_tpu…`` or ``from cvnets_tpu… import`` anywhere in a module
    of the port or in chip_smoke.py, at any depth (inside functions too)."""
    import ast

    found, checked = [], 0
    for path in _port_sources():
        tree = ast.parse(open(path).read(), filename=path)
        checked += 1
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            found += [f"{os.path.relpath(path, REPO)}:{node.lineno} {n}" for n in names
                      if n.split(".")[0] == "cvnets_tpu"]
    assert checked > 40
    assert not found, found


def _parsers():
    from cvnets_tpu.options.opts import get_training_arguments as jax_args
    from cvnets_tpu_torch.options.opts import get_training_arguments as torch_args

    return jax_args(parse_args=False), torch_args(parse_args=False)


def test_port_flags_have_the_jax_dests_and_defaults():
    jax_parser, torch_parser = _parsers()
    jax_actions = {s: a for a in jax_parser._actions for s in a.option_strings}
    checked = 0
    for action in torch_parser._actions:
        for flag in action.option_strings:
            if flag in ("-h", "--help"):
                continue
            assert flag in jax_actions, f"{flag} is not a flag of the JAX parser"
            ref = jax_actions[flag]
            assert (action.dest, action.default) == (ref.dest, ref.default), flag
            assert action.type == ref.type and action.nargs == ref.nargs, flag
            checked += 1
    assert checked >= 40


def test_flagship_yaml_parses_to_the_same_values():
    from cvnets_tpu.options.opts import get_training_arguments as jax_args
    from cvnets_tpu_torch.options.opts import get_training_arguments as torch_args

    args = ["--common.config-file", FLAGSHIP_YAML]
    jax_opts, torch_opts = jax_args(args=args), torch_args(args=args)
    for dest, value in vars(torch_opts).items():
        assert getattr(jax_opts, dest) == value, dest
    assert getattr(torch_opts, "model.classification.mitv2.width_multiplier") == 1.0
    assert getattr(torch_opts, "ema.momentum") == 0.0005


@pytest.mark.parametrize("extra", [
    [],  # the flagship's epoch-based cosine with 20k warmup iterations
    ["--scheduler.is-iteration-based", "--scheduler.max-iterations", "50",
     "--scheduler.warmup-iterations", "5"],
    ["--scheduler.adjust-period-for-epochs", "--scheduler.max-epochs", "7",
     "--scheduler.warmup-iterations", "5"],
])
def test_scheduler_copy_matches_jax(extra):
    from cvnets_tpu.optim.scheduler import build_scheduler as jax_scheduler
    from cvnets_tpu.options.opts import get_training_arguments as jax_args
    from cvnets_tpu_torch.optim.scheduler import build_scheduler
    from cvnets_tpu_torch.options.opts import get_training_arguments as torch_args

    args = ["--common.config-file", FLAGSHIP_YAML] + extra
    ref, port = jax_scheduler(jax_args(args=args)), build_scheduler(torch_args(args=args))
    for epoch, it in [(0, 0), (0, 3), (1, 4), (1, 5), (2, 9), (3, 30), (5, 50),
                      (7, 60), (150, 19999), (150, 20000), (299, 400000)]:
        assert port.retrieve_lr(epoch, it) == ref.retrieve_lr(epoch, it), (epoch, it)
