"""The model-parallel flags through the port's entry points on the CPU (gloo
ranks spawned by the entry points themselves, over a ``file://`` store):

* ``main_train`` of the micro ViT without its CLS token at ``--dev.mesh-shape
  2 2 --dev.fsdp --dev.sequence-parallel`` (four ranks: FSDP, tensor
  parallelism and the ring) on a temporary ImageFolder: rank 0 writes whole
  tensors, so ``checkpoint_last.pt`` loads into a one-process model and
  ``training_checkpoint_last.pt`` holds whole AdamW moments; a second run
  with ``--common.auto-resume`` cuts them back to each rank's shards and
  trains the next epoch;
* ``main_eval`` accepts each of ``--dev.fsdp``, ``--dev.sequence-parallel``
  and ``--dev.mesh-shape 1 2``;
* ``main_eval``'s evaluation (``main_eval.main`` through ``parallel.launch``)
  of the micro ViT-MoE at ``--dev.mesh-shape 2 1`` on 7 images, one a rank:
  the ranks split them 4 and 3, so rank 1's last batch is all padding, and
  it still runs the model, whose router all-gathers the data group's rows.
  Its loss and top-1 equal those of the model in one process on the global
  batches (the loader's at a batch of 2: the two ranks' rows, the same
  padding row last), each run whole as JAX routes the padded global batch,
  over the valid rows (each sample's loss counts once, as each one-row batch
  of a rank does): the loss to 1e-5 relative (float32 sums of the same
  products split over two processes), the top-1 exactly.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_distributed_main import folder  # noqa: E402,F401  (the fixture)
from torch_port_helpers import VIT_MICRO_ARGS  # noqa: E402

MOE_ARGS = ["--model.classification.vit.moe-num-experts", "4",
            "--model.classification.vit.moe-top-k", "2",
            "--model.classification.vit.moe-capacity-factor", "1.25",
            "--model.classification.vit.moe-layer-period", "2"]

GRID = ["--dev.mesh-shape", "2", "2", "--dev.fsdp", "--dev.sequence-parallel"]


def _args(folder, results, extra=()):
    return [*VIT_MICRO_ARGS, "--model.classification.vit.no-cls-token",
            "--model.classification.n-classes", "3",
            "--dataset.name", "imagenet", "--dataset.root-train", str(folder / "train"),
            "--dataset.root-val", str(folder / "val"), "--dataset.decoder", "pil",
            "--dataset.workers", "0", "--dataset.train-batch-size0", "3",
            "--dataset.val-batch-size0", "3", "--dataset.eval-batch-size0", "3",
            "--image-augmentation.random-resized-crop.enable",
            "--image-augmentation.resize.enable", "--image-augmentation.resize.size", "40",
            "--image-augmentation.center-crop.enable",
            "--image-augmentation.center-crop.size", "32",
            "--sampler.bs.crop-size-width", "32", "--sampler.bs.crop-size-height", "32",
            "--optim.name", "adamw", "--ema.enable", "--stats.val", "loss", "top1",
            "--common.results-loc", str(results), "--common.seed", "3", *extra]


@pytest.fixture(autouse=True)
def _one_thread_a_rank(monkeypatch):
    """The spawned ranks (they inherit the environment) on one thread each:
    the suite's workers share the machine's cores."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_main_train_on_a_2x2_grid_writes_whole_tensors_and_auto_resumes(folder, tmp_path,
                                                                        capfd):
    from cvnets_tpu_torch import main_train
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments

    def run(epochs, store):
        args = _args(folder, tmp_path / "grid", [
            *GRID, "--scheduler.max-epochs", str(epochs), "--common.auto-resume",
            "--ddp.dist-url", f"file://{tmp_path / store}"])
        assert main_train.main_worker(args=args, device="cpu") is None  # ran in the ranks
        return capfd.readouterr().out

    out = run(2, "store1")
    assert out.count("*** Training summary for epoch 1") == 1  # the master alone logs
    ckpt_dir = tmp_path / "grid" / "run_1"
    first = torch.load(ckpt_dir / "training_checkpoint_last.pt", weights_only=True)
    one = get_model(get_training_arguments(args=_args(folder, tmp_path / "one")), device="cpu")
    one.load_state_dict(torch.load(ckpt_dir / "checkpoint_last.pt", weights_only=True))
    one.load_state_dict(first["ema"])
    sizes = {n: tuple(p.shape) for n, p in one.named_parameters()}
    state = first["optimizer"]["state"]
    assert len(state) == len(sizes)
    assert sorted(tuple(s["exp_avg"].shape) for s in state.values()) == sorted(sizes.values())
    assert first["epoch"] == 1

    out = run(3, "store2")
    assert "Resumed from" in out and out.count("*** Training summary for epoch 2") == 1
    second = torch.load(ckpt_dir / "training_checkpoint_last.pt", weights_only=True)
    assert second["epoch"] == 2 and second["iterations"] > first["iterations"]
    assert any(not torch.equal(second["model"][k], first["model"][k]) for k in sizes)


@pytest.mark.parametrize("flags", [["--dev.fsdp"], ["--dev.sequence-parallel"],
                                   ["--dev.mesh-shape", "1", "2"]],
                         ids=["fsdp", "sequence_parallel", "model_axis"])
def test_main_eval_runs_under_each_model_parallel_flag(folder, tmp_path, flags):
    from cvnets_tpu_torch import main_eval

    args = _args(folder, tmp_path, [*flags, "--ddp.dist-url", f"file://{tmp_path / 'store'}"])
    stats = main_eval.main_worker(args=args, device="cpu")
    if flags[0] == "--dev.mesh-shape":
        assert stats is None  # it ran in two spawned ranks
    else:
        assert set(stats) == {"loss", "top1"}


def _eval_to_file(opts, device=None):
    """``main_eval.main`` in each rank; the master writes the metrics to the
    file named by ``opts.stats_out``."""
    from cvnets_tpu_torch import main_eval, parallel

    stats = main_eval.main(opts, device=device)
    if parallel.is_master():
        with open(opts.stats_out, "w") as f:
            json.dump(stats, f)
    return stats


def test_main_eval_of_vit_moe_routes_the_padded_global_batch_at_grid_2_1(folder, tmp_path):
    from cvnets_tpu_torch.options.opts import get_eval_arguments
    from cvnets_tpu_torch.parallel import launch

    for name in sorted(os.listdir(folder / "val")):  # 7 of the 8 images
        files = sorted(os.listdir(folder / "val" / name))
        (tmp_path / "val" / name).mkdir(parents=True)
        for f in files[:len(files) - (name == "n01")]:
            shutil.copy(folder / "val" / name / f, tmp_path / "val" / name / f)

    def stats(batch, extra):
        opts = get_eval_arguments(args=_args(folder, tmp_path / f"run{batch}", [
            *MOE_ARGS, "--dataset.root-val", str(tmp_path / "val"),
            "--dataset.eval-batch-size0", str(batch), *extra]))
        opts.stats_out = str(tmp_path / f"stats{batch}.json")
        launch(_eval_to_file, opts, "cpu")
        with open(opts.stats_out) as f:
            return json.load(f)

    got = stats(1, ["--dev.mesh-shape", "2", "1",
                    "--ddp.dist-url", f"file://{tmp_path / 'store'}"])
    want = _padded_global_batches(get_eval_arguments(args=_args(folder, tmp_path / "one", [
        *MOE_ARGS, "--dataset.root-val", str(tmp_path / "val"),
        "--dataset.eval-batch-size0", "2"])))
    assert got["top1"] == want["top1"]
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)


@torch.no_grad()
def _padded_global_batches(opts) -> dict:
    """The model's loss (a mean over the samples) and top-1 over the test
    loader, each padded batch through the model whole, its valid rows counted."""
    from cvnets_tpu_torch.data.data_loaders import create_test_loader
    from cvnets_tpu_torch.engine.train_state import UnitNormalizer
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.models import get_model

    model = get_model(opts, device="cpu").eval()
    criteria, to_unit = build_loss_fn(opts, device="cpu"), UnitNormalizer(opts)
    losses, hits = [], []
    for batch in create_test_loader(opts):
        logits, targets = model(to_unit(batch["samples"])), batch["targets"]
        for i in range(batch.get("n_valid", len(targets))):
            losses.append(float(criteria(None, logits[i:i + 1], targets[i:i + 1],
                                         training=False)))
            hits.append(float(logits[i].argmax() == targets[i]))
    assert len(losses) == 7 and len(hits) == 7
    return {"loss": sum(losses) / len(losses), "top1": 100.0 * sum(hits) / len(hits)}
