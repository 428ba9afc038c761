"""The port's data parallelism through its entry points, and the pieces of it
that need no process group.

* ``main_train`` at ``--dev.num-devices 2`` on the CPU (two spawned gloo
  processes over a ``file://`` store): an epoch of a micro MobileViTv2 from a
  yaml with the chain sampler and sample-efficient training, on a temporary
  ImageFolder; rank 0 alone logs and writes the checkpoints, which load into
  a one-process model and ``main_eval``.
* A rank that raises ends every rank, and the launch raises (the program
  exits nonzero), within the spawn's timeout.
* The samplers: the union of the two ranks' i-th batches is the JAX
  sampler's i-th batch at one replica with twice the batch (its
  ``n_device_mult`` set to 2, two devices of one process), for
  ``batch_sampler``, ``variable_batch_sampler`` and ``chain_sampler``; the
  rows past a rank's samples are marked as padding.
* Two ranks building the kernels never share nvcc's temporary output.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_helpers import SMALL_MODEL_ARGS  # noqa: E402

WORLD = 2
SPAWN_TIMEOUT_S = 240
CLASSES = ["n01", "n02", "n03"]
CHAIN = [{"task_name": "small", "sampler_name": "batch_sampler",
          "bs": {"crop_size_width": 32, "crop_size_height": 32}},
         {"task_name": "scales", "sampler_name": "variable_batch_sampler_ddp",
          "vbs": {"crop_size_width": 32, "crop_size_height": 32, "min_crop_size_width": 32,
                  "max_crop_size_width": 64, "min_crop_size_height": 32,
                  "max_crop_size_height": 64, "max_n_scales": 2, "check_scale": 32}}]


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("imagefolder")
    rng = np.random.default_rng(0)
    for split, per_class in (("train", 8), ("val", 3)):
        for name in CLASSES:
            (root / split / name).mkdir(parents=True)
            for i in range(per_class - (split == "val" and name == "n03")):  # 8 val files
                hw = (int(rng.integers(36, 60)), int(rng.integers(36, 60)))
                Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
                    root / split / name / f"img_{i}.JPEG", quality=90)
    return root


def _yaml(path, folder) -> str:
    import yaml

    config = {"sampler": {"name": "chain_sampler", "chain_sampler_mode": "interleave",
                          "chain_sampler": CHAIN},
              "dataset": {"sample_efficient_training": {
                  "enable": True, "sample_confidence": 0.0,
                  "find_easy_samples_every_k_epochs": 1, "min_sample_frequency": 0}}}
    path.write_text(yaml.safe_dump(config))
    return str(path)


def _train_args(folder, results, extra=()):
    return [*SMALL_MODEL_ARGS, "--model.classification.n-classes", "3",
            "--dataset.name", "imagenet", "--dataset.root-train", str(folder / "train"),
            "--dataset.root-val", str(folder / "val"), "--dataset.decoder", "pil",
            "--dataset.workers", "0", "--dataset.train-batch-size0", "3",
            "--dataset.val-batch-size0", "3", "--dataset.eval-batch-size0", "3",
            "--image-augmentation.random-resized-crop.enable",
            "--image-augmentation.resize.enable", "--image-augmentation.resize.size", "40",
            "--image-augmentation.center-crop.enable",
            "--image-augmentation.center-crop.size", "32",
            "--sampler.bs.crop-size-width", "32", "--sampler.bs.crop-size-height", "32",
            "--optim.name", "adamw", "--ema.enable", "--scheduler.max-epochs", "2",
            "--stats.val", "loss", "top1", "--common.results-loc", str(results),
            "--common.seed", "3", *extra]


def test_main_train_at_world_two_checkpoints_once_and_loads_into_one_process(
        folder, tmp_path, capfd):
    """The entry point spawns the two ranks itself."""
    from cvnets_tpu_torch import main_eval, main_train
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments

    args = _train_args(folder, tmp_path / "spawned", [
        "--common.config-file", _yaml(tmp_path / "chain.yaml", folder),
        "--dev.num-devices", str(WORLD), "--ddp.dist-url", f"file://{tmp_path / 'store'}"])
    assert main_train.main_worker(args=args, device="cpu") is None  # ran in the ranks
    out = capfd.readouterr().out
    # the master alone logs: one summary an epoch, and sample-efficient
    # training's search after each epoch (at confidence 0 every correctly
    # classified sample is easy)
    assert out.count("*** Training summary for epoch 1") == 1
    assert out.count("Sample-efficient training: ") >= 2
    assert "easy samples at epoch 1" in out
    run = tmp_path / "spawned" / "run_1"
    names = sorted(os.listdir(run))
    assert "training_checkpoint_last.pt" in names and "checkpoint_ema_last.pt" in names
    assert not [n for n in names if n.endswith(".tmp")]
    state = torch.load(run / "checkpoint_last.pt", weights_only=True)
    assert not [k for k in state if k.startswith("module.")]
    opts = get_training_arguments(args=_train_args(folder, tmp_path / "one"))
    get_model(opts, device="cpu").load_state_dict(state)  # a one-process model takes it
    stats = main_eval.main_worker(args=_train_args(folder, tmp_path / "eval", [
        "--model.classification.pretrained", str(run / "checkpoint_last.pt")]),
        device="cpu")
    assert set(stats) == {"loss", "top1"}


def _fails_on_rank_1(index: int, store: str) -> None:
    from cvnets_tpu_torch import parallel
    from cvnets_tpu_torch.parallel import mesh

    mesh.init_group("gloo", index, WORLD, f"file://{store}", SPAWN_TIMEOUT_S)
    if index == 1:
        raise RuntimeError("rank 1 fails")
    parallel.barrier()  # rank 0 would wait here for ever: the launch ends it


def test_a_rank_that_raises_ends_every_rank_and_the_launch_raises(tmp_path):
    from cvnets_tpu_torch import parallel

    with pytest.raises(Exception, match="rank 1 fails"):
        parallel.spawn(_fails_on_rank_1, WORLD, (str(tmp_path / "store"),),
                       timeout_s=SPAWN_TIMEOUT_S)


def _jax_sampler(name, n, args, is_training):
    from cvnets_tpu.data.sampler import build_sampler
    from cvnets_tpu.options.opts import get_training_arguments

    opts = get_training_arguments(args=["--sampler.name", name] + list(args))
    if name == "chain_sampler":
        setattr(opts, "sampler.chain_sampler", CHAIN)
    ref = build_sampler(opts, n_data_samples=n, is_training=is_training, rank=0,
                        num_replicas=1)
    for s in [ref, *getattr(ref, "child_samplers", {}).values()]:
        s.n_device_mult = WORLD  # the batch of two devices of one process
    return ref


def _port_samplers(name, n, args, is_training):
    from cvnets_tpu_torch.data.sampler import build_sampler
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=["--sampler.name", name] + list(args))
    if name == "chain_sampler":
        setattr(opts, "sampler.chain_sampler", CHAIN)
    return [build_sampler(opts, n_data_samples=n, is_training=is_training, rank=r,
                          num_replicas=WORLD) for r in range(WORLD)]


@pytest.mark.parametrize("is_training", [True, False])
@pytest.mark.parametrize("name, mode", [("batch_sampler", "sequential"),
                                        ("variable_batch_sampler", "sequential"),
                                        ("chain_sampler", "sequential"),
                                        ("chain_sampler", "interleave")])
def test_the_ranks_batches_are_the_jax_global_batches(name, mode, is_training):
    n = 61  # an odd set: the ranks are evened out by one pad, the last batches by more
    args = ["--dataset.train-batch-size0", "4", "--dataset.val-batch-size0", "3",
            "--sampler.vbs.crop-size-width", "64", "--sampler.vbs.crop-size-height", "64",
            "--sampler.vbs.max-n-scales", "3", "--sampler.vbs.min-crop-size-width", "32",
            "--sampler.vbs.max-crop-size-width", "96", "--sampler.vbs.min-crop-size-height",
            "32", "--sampler.vbs.max-crop-size-height", "96",
            "--sampler.chain-sampler-mode", mode, "--common.seed", "5"]
    ref, ports = _jax_sampler(name, n, args, is_training), _port_samplers(name, n, args,
                                                                          is_training)
    for epoch in (0, 1):
        for s in [ref, *ports]:
            s.set_epoch(epoch)
        want = list(ref)
        got = [list(p) for p in ports]
        assert len(got[0]) == len(got[1]) == len(want)
        for i, (jb, b0, b1) in enumerate(zip(want, *got)):
            assert {t[:2] for t in jb} == {t[:2] for t in b0} == {t[:2] for t in b1}, i
            assert len(b0) == len(b1) and 2 * len(b0) == len(jb), i
            union = sorted(t[2] for t in b0[:b0.n_valid] + b1[:b1.n_valid])
            assert union == sorted(t[2] for t in jb[:len(union)]), i
            assert len(union) <= len(jb)
        # every sample once in the valid rows of an epoch's batches
        valid = sorted(t[2] for b in got[0] + got[1] for t in b[:b.n_valid])
        if name == "batch_sampler":
            assert valid == list(range(n))
            assert sum(b.n_valid for b in got[0]) == 31 and sum(b.n_valid for b in got[1]) == 30


def test_two_ranks_never_share_nvccs_temporary_output(tmp_path, monkeypatch):
    """Each process compiles into a temporary name of its own and renames it
    into place: two ranks' first launches cannot write one file together."""
    from cvnets_tpu_torch.ops import cuda_build

    outputs = []

    def fake_nvcc(cmd, **kwargs):
        out = cmd[cmd.index("-o") + 1]
        outputs.append(out)
        open(out, "wb").close()
        return type("Done", (), {"returncode": 0, "stdout": "", "stderr": ""})()

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    monkeypatch.setattr(cuda_build.subprocess, "run", fake_nvcc)
    for pid in (1001, 1002):  # two ranks, before either has a library
        monkeypatch.setattr(cuda_build.os, "getpid", lambda pid=pid: pid)
        lib = cuda_build.build_library("seg_ce.cu")
        os.remove(lib)
    assert len(set(outputs)) == 2 and all(o.endswith(".tmp") for o in outputs)
