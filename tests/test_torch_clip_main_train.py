"""CLIP through the port's entry points on the CPU: ``main_train`` reads
config/multi_modal_image_text/clip_vit.yaml from the file, cut to the micro
ViT and text tower at 64 px, and trains it on a flickr folder written into
the test's directory (13 images, one of them unreadable) for 2 epochs (8 steps) with
``image_text_retrieval`` in its validation; then ``main_eval`` scores the
run's checkpoint zero-shot on an ImageFolder of 3 classes with a class-names
file, and its top-1 / top-5 equal those computed from the model's own
embeddings of the same images and captions; a run under
``--dataset.multi-modal-img-text.zero-shot-eval`` validates zero-shot. The
yaml parses to the JAX parser's values, and chip_smoke.py's ``CLIP_ARGS``
(the yaml as flags) to the yaml's.

The contrastive loss is 0 outside training, so a run whose checkpoints are
ranked by the validation loss (clip_vit.yaml's ``stats.checkpoint_metric``)
sees a tie every epoch; the checkpoint manager keeps the JAX package's tie
rule (``<=``: the later epoch is the best), so ``checkpoint_best.pt`` is the
last epoch's.
"""

from __future__ import annotations

import math
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, "tests")

from torch_port_helpers import torch_threads  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIP_YAML = os.path.join(REPO, "config/multi_modal_image_text/clip_vit.yaml")
MICRO = ["model.classification.vit.mode=micro", "model.text.vocab_size=100",
         "model.text.context_length=16", "model.text.transformer.model_dim=64",
         "model.text.transformer.n_transformer_layers=2",
         "model.text.transformer.n_heads_per_layer=4",
         "model.multi_modal_image_text.clip.projection_dim=32",
         "sampler.bs.crop_size_width=64", "sampler.bs.crop_size_height=64",
         "image_augmentation.resize.size=64", "common.mixed_precision=false"]
CLASSES = ["cat", "dog", "bird"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from cvnets_tpu_torch.main_train import main_worker

    root = tmp_path_factory.mktemp("flickr")
    rng = np.random.default_rng(0)
    (root / "images").mkdir()
    lines = []
    for i in range(12):
        Image.fromarray(rng.integers(0, 256, (50 + 3 * i, 70, 3), dtype=np.uint8)).save(
            root / "images" / f"{i}.jpg")
        lines.append(f"images/{i}.jpg\ta photo of a {CLASSES[i % 3]} number {i}")
    (root / "images" / "12.jpg").write_bytes(b"cut")
    lines.append("images/12.jpg\ta broken file")
    (root / "captions.tsv").write_text("\n".join(lines) + "\n")
    zs = tmp_path_factory.mktemp("zero_shot")
    for c in CLASSES:
        (zs / f"class_{c}").mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 256, (60, 55, 3), dtype=np.uint8)).save(
                zs / f"class_{c}" / f"{i}.png")
    (zs / "names.txt").write_text("\n".join(CLASSES) + "\n")
    results = tmp_path_factory.mktemp("results")
    args = ["--common.config-file", CLIP_YAML, "--common.override-kwargs",
            f"dataset.root_train={root}", f"dataset.root_val={root}",
            "dataset.train_batch_size0=4", "dataset.val_batch_size0=4", "dataset.workers=2",
            "scheduler.max_iterations=8", "scheduler.warmup_iterations=2",
            "stats.val=loss,image_text_retrieval", "common.log_freq=2",
            f"common.results_loc={results}", *MICRO]
    with torch_threads(2):
        trainer = main_worker(args=args, device="cpu")
    return {"trainer": trainer, "zs": zs, "args": args}


def test_main_train_trains_clip_from_the_yaml(run):
    trainer = run["trainer"]
    assert trainer.train_iterations == 8  # 2 epochs of 4 batches of 4 (13 samples, padded)
    assert trainer.model.__class__.__name__ == "CLIP"
    assert getattr(trainer.opts, "model.classification.vit.norm_layer") == "layer_norm_fp32"
    assert getattr(trainer.opts, "optim.adamw.beta2") == 0.98
    stats = trainer.val_epoch(1)
    assert stats["loss"] == 0.0
    assert all(0.0 <= stats[f"image_text_retrieval.{d}_r{k}"] <= 100.0
               for d in ("i2t", "t2i") for k in (1, 5, 10))
    weights = trainer.model.state_dict()
    assert all(bool(torch.isfinite(v).all()) for v in weights.values())
    assert weights["logit_scale"].item() != pytest.approx(math.log(1 / 0.07), abs=1e-7)
    for name in ("checkpoint_last.pt", "checkpoint_best.pt", "checkpoint_ema_last.pt",
                 "training_checkpoint_last.pt"):
        assert os.path.isfile(os.path.join(trainer.save_dir, name)), name


def test_checkpoint_ranking_on_the_zero_val_loss_keeps_the_jax_tie_rule(run):
    from cvnets_tpu.utils.checkpoint_utils import CheckpointManager as JaxManager
    from cvnets_tpu_torch.utils.checkpoint_utils import CheckpointManager, load_file

    trainer = run["trainer"]
    save_dir = trainer.save_dir
    best, last = (load_file(os.path.join(save_dir, f"checkpoint_{r}.pt"))
                  for r in ("best", "last"))
    assert best.keys() == last.keys()
    assert all(torch.equal(best[k], last[k]) for k in best)  # the tie went to epoch 1
    for manager in (JaxManager(trainer.opts, str(run["zs"])),
                    CheckpointManager(trainer.opts, save_dir)):
        manager.best_metric = 0.0
        assert manager.is_best(0.0) and not manager.is_best(1e-9)


def test_main_eval_scores_zero_shot_from_the_checkpoint(run):
    from cvnets_tpu_torch.data.data_loaders import create_test_loader
    from cvnets_tpu_torch.main_eval import main_worker
    from cvnets_tpu_torch.metrics.topk_accuracy import top_k_correct
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_eval_arguments
    from cvnets_tpu_torch.utils.checkpoint_utils import load_model_weights

    ckpt = os.path.join(run["trainer"].save_dir, "checkpoint_last.pt")
    args = ["--common.config-file", CLIP_YAML, "--common.override-kwargs",
            f"dataset.root_val={run['zs']}", "dataset.name=imagenet_zero_shot",
            "dataset.eval_batch_size0=3", f"dataset.zero_shot.class_names_file="
            f"{run['zs']}/names.txt", f"model.multi_modal_image_text.pretrained={ckpt}", *MICRO]
    with torch_threads(2):
        out = main_worker(args=args, device="cpu")
        opts = get_eval_arguments(args=args)
        loader = create_test_loader(opts)
        assert loader.dataset.class_names == CLASSES
        model = get_model(opts, device="cpu").eval()
        model.load_state_dict(load_model_weights(ckpt))
        correct, n = np.zeros(2), 0
        with torch.no_grad():
            classes = model.encode_text(loader.dataset.class_caption_tokens())
            for batch in loader:
                images = model.encode_image(batch["samples"].float() / 255.0)
                logits = 100.0 * images @ classes.t()
                correct += [top_k_correct(logits, batch["targets"], k).item() for k in (1, 5)]
                n += batch["targets"].shape[0]
    assert n == 9 and set(out) == {"top1", "top5"}
    assert out["top1"] == pytest.approx(100.0 * correct[0] / n)
    assert out["top5"] == 100.0  # three classes


def test_chip_smoke_clip_flags_are_the_yaml():
    """chip_smoke.py passes clip_vit.yaml as flags (the card machine has no
    PyYAML): they parse to the yaml's values but for its data roots (a
    one-entry list from a ``nargs="+"`` flag is the yaml's scalar)."""
    sys.path.insert(0, REPO)
    from chip_smoke import CLIP_ARGS
    from cvnets_tpu_torch.options.opts import get_training_arguments

    def scalar(v):
        return v[0] if isinstance(v, list) and len(v) == 1 else v

    flags = vars(get_training_arguments(args=CLIP_ARGS))
    yaml = vars(get_training_arguments(args=["--common.config-file", CLIP_YAML]))
    assert sorted(k for k in yaml if scalar(yaml[k]) != scalar(flags[k])) == [
        "common.config_file", "dataset.root_train", "dataset.root_val", "taskname"]


def test_clip_yaml_parses_to_the_jax_values():
    from cvnets_tpu.options.opts import get_training_arguments as jax_args
    from cvnets_tpu_torch.options.opts import get_training_arguments

    args = ["--common.config-file", CLIP_YAML]
    jax_opts, port_opts = jax_args(args=args), get_training_arguments(args=args)
    for dest, value in vars(port_opts).items():
        assert getattr(jax_opts, dest) == value, dest
    assert getattr(port_opts, "model.text.transformer.causal_masking") is True


def test_zero_shot_eval_validates_on_the_zero_shot_set(run, tmp_path):
    """``--dataset.multi-modal-img-text.zero-shot-eval`` puts the zero-shot set
    (``zero-shot.root-val``) in the val split's place, as the JAX package
    does, and the Trainer scores it zero-shot."""
    from cvnets_tpu_torch.main_train import main_worker

    with torch_threads(2):
        trainer = main_worker(args=run["args"] + [
            "dataset.multi_modal_img_text.zero_shot_eval=true",
            f"dataset.multi_modal_img_text.zero_shot.root_val={run['zs']}",
            f"dataset.zero_shot.class_names_file={run['zs']}/names.txt",
            "scheduler.max_iterations=4", f"common.results_loc={tmp_path}"], device="cpu")
        stats = trainer.val_epoch(0)
    assert trainer.val_loader.dataset.class_names == CLASSES
    assert set(stats) == {"top1", "top5"} and stats["top5"] == 100.0
    assert 0.0 <= stats["top1"] <= 100.0
