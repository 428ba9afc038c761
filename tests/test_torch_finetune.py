"""``--common.finetune`` and ``--common.finetune-ema`` of the port's Trainer,
from checkpoints the port wrote, with the JAX package's scope surgery
(cvnets_tpu/utils/checkpoint_utils.py:226-307): a micro MobileViTv2 trains an
epoch on 10 classes, then a 5-class run starts from its ``checkpoint_last.pt``
with ``--model.resume-exclude-scopes classifier`` (as
config/classification/finetune_in21k_to_1k/mobilevit_v2.yaml:59 sets it):

* every tensor but the classifier's comes from the file, the classifier keeps
  its fresh values, and the EMA copy starts from the finetuned model, or from
  ``--common.finetune-ema``'s file;
* a classifier of another shape, not excluded, keeps its fresh values too;
  ``--model.rename-scopes-map`` rewrites the file's keys;
  ``--model.ignore-missing-scopes`` silences a missing tensor;
* the model part of a ``training_checkpoint_last.pt`` is read as well;
* a file whose tensors name none of the model's (a reference CVNets
  checkpoint names its modules otherwise), bare or under
  ``model_state_dict``, goes through the structural converter and gives
  the source's tensors;
* ``finetune_weights`` lays a file over a model as the JAX package's
  ``_merge_with_scopes`` lays a flat dict over a tree, key for key, on the
  same names.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

ARGS = ["--model.classification.name", "mobilevit_v2",
        "--model.classification.mitv2.width-multiplier", "0.5",
        "--optim.name", "adamw", "--ema.enable", "--scheduler.max-epochs", "1",
        "--common.k-best-checkpoints", "0"]


def _opts(results, extra=()):
    from cvnets_tpu_torch.options.opts import get_training_arguments

    return get_training_arguments(args=ARGS + ["--common.results-loc", str(results), *extra])


def _batches(n_classes):
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (2, 3, 32, 32), generator=g, dtype=torch.uint8)
    return [{"samples": x, "targets": torch.tensor([1, n_classes - 1])}]


def _trainer(opts, n_classes):
    from cvnets_tpu_torch.engine import Trainer
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import get_model

    setattr(opts, "model.classification.n_classes", n_classes)
    torch.manual_seed(1)
    return Trainer(opts, get_model(opts, device="cpu"), build_loss_fn(opts),
                   _batches(n_classes), None, device="cpu")


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    """A 10-class run of one epoch: its directory and final model and EMA."""
    results = tmp_path_factory.mktemp("source")
    trainer = _trainer(_opts(results), 10)
    trainer.run()
    return (trainer.save_dir, {k: v.clone() for k, v in trainer.model.state_dict().items()},
            {k: v.clone() for k, v in trainer.state.ema.model.state_dict().items()})


def test_finetune_excludes_the_classifier_and_starts_the_ema_from_the_model(source,
                                                                           tmp_path):
    save_dir, model_sd, _ = source
    ckpt = os.path.join(save_dir, "checkpoint_last.pt")
    fresh = _trainer(_opts(tmp_path / "fresh"), 5).model.state_dict()
    trainer = _trainer(_opts(tmp_path / "ft", ["--common.finetune", ckpt,
                                               "--model.resume-exclude-scopes", "classifier"]),
                       5)
    got = trainer.model.state_dict()
    assert any(k.startswith("classifier") for k in got)
    for key, value in got.items():
        want = fresh[key] if key.startswith("classifier") else model_sd[key]
        assert torch.equal(value, want), key
    for key, value in trainer.state.ema.model.state_dict().items():
        assert torch.equal(value, got[key]), key
    trainer.run()  # and it trains
    assert trainer.train_iterations == 1


def test_finetune_ema_loads_its_own_file(source, tmp_path):
    save_dir, model_sd, ema_sd = source
    trainer = _trainer(_opts(tmp_path, [
        "--common.finetune", os.path.join(save_dir, "training_checkpoint_last.pt"),
        "--common.finetune-ema", os.path.join(save_dir, "checkpoint_ema_last.pt")]), 10)
    for key, value in trainer.model.state_dict().items():
        assert torch.equal(value, model_sd[key]), key
    for key, value in trainer.state.ema.model.state_dict().items():
        assert torch.equal(value, ema_sd[key]), key
    assert not all(torch.equal(model_sd[k], ema_sd[k]) for k in model_sd)


def test_a_classifier_of_another_shape_keeps_its_fresh_values(source, tmp_path):
    from cvnets_tpu_torch.utils.checkpoint_utils import finetune_weights

    save_dir, model_sd, _ = source
    opts = _opts(tmp_path)
    current = _trainer(_opts(tmp_path / "fresh"), 5).model.state_dict()
    got = finetune_weights(opts, os.path.join(save_dir, "checkpoint_last.pt"), current)
    assert torch.equal(got["classifier.fc.weight"], current["classifier.fc.weight"])
    assert torch.equal(got["conv_1.conv.weight"], model_sd["conv_1.conv.weight"])


def test_renames_and_ignored_missing_scopes(source, tmp_path):
    from cvnets_tpu_torch.utils.checkpoint_utils import finetune_weights, save_file

    save_dir, model_sd, _ = source
    renamed = {("old_" + k if k.startswith("conv_1.") else k): v for k, v in model_sd.items()
               if not k.startswith("layer_5.")}
    path = str(tmp_path / "renamed.pt")
    save_file(renamed, path)
    current = _trainer(_opts(tmp_path / "fresh"), 10).model.state_dict()
    opts = _opts(tmp_path, ["--model.rename-scopes-map", "^old_conv_1:conv_1",
                            "--model.ignore-missing-scopes", "layer_5"])
    got = finetune_weights(opts, path, current)
    for key in got:
        want = current[key] if key.startswith("layer_5.") else model_sd[key]
        assert torch.equal(got[key], want), key


def test_a_foreign_checkpoint_raises_and_names_its_roadmap_item(source, tmp_path):
    """(Named for the refusal it checked before the converter was ported.) A
    file in the reference's names, in the source's order, bare or under
    ``model_state_dict``, now loads through the converter: every tensor is
    the source's (BN's step counters, which the JAX package has no leaf for,
    keep the model's)."""
    from cvnets_tpu_torch.utils.checkpoint_utils import finetune_weights, save_file

    _, model_sd, _ = source
    current = _trainer(_opts(tmp_path / "fresh"), 10).model.state_dict()
    reference = {k.replace("conv_1.conv.", "conv_1.block.conv.")
                 .replace(".norm.", ".block.norm.").replace("layer_", "layer."): v
                 for k, v in model_sd.items()}
    for blob in (reference, {"model_state_dict": model_sd}):
        path = str(tmp_path / "reference.pt")
        save_file(blob, path)
        got = finetune_weights(_opts(tmp_path), path, current)
        for key, value in model_sd.items():
            want = current[key] if key.endswith("num_batches_tracked") else value
            assert torch.equal(got[key], want), key


def test_scope_surgery_matches_the_jax_merge(tmp_path):
    """The same keys, values, exclusions, renames and shape rule as
    ``_merge_with_scopes`` on a tree of the same names."""
    from cvnets_tpu.utils.checkpoint_utils import _merge_with_scopes
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.utils.checkpoint_utils import finetune_weights, save_file

    rng = np.random.default_rng(0)
    current = {"stem.conv.weight": rng.standard_normal((4, 3)),
               "blocks.0.fc.weight": rng.standard_normal((4, 4)),
               "blocks.1.fc.weight": rng.standard_normal((4, 4)),
               "head.fc.weight": rng.standard_normal((5, 4)),
               "head.fc.bias": rng.standard_normal(5)}
    src = {"old.conv.weight": rng.standard_normal((4, 3)),
           "blocks.0.fc.weight": rng.standard_normal((4, 4)),
           "head.fc.weight": rng.standard_normal((10, 4)),
           "head.fc.bias": rng.standard_normal(10),
           "blocks.1.fc.weight": rng.standard_normal((4, 4))}
    flags = ["--model.rename-scopes-map", "^old:stem", "--model.resume-exclude-scopes",
             "blocks\\.1", "--model.ignore-missing-scopes", "nothing"]
    opts = get_training_arguments(args=flags)
    tree: dict = {}
    for key, value in current.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    want, _ = _merge_with_scopes(tree, src, opts)

    path = str(tmp_path / "src.pt")
    save_file({k: torch.from_numpy(v) for k, v in src.items()}, path)
    got = finetune_weights(opts, path, {k: torch.from_numpy(v) for k, v in current.items()})
    for key, value in got.items():
        node = want
        for p in key.split("."):
            node = node[p]
        assert np.array_equal(value.numpy(), node), key
