"""The port's samplers (``cvnets_tpu_torch/data/sampler``) against the JAX
package's: the same (crop_h, crop_w, idx) lists over seeds and epochs, the
trailing batch padded, ``len`` and ``update_scales``. The JAX sampler scales
every batch size by its process's local device count (8 on the tests' CPU
mesh); the port runs one process a card, so the JAX samplers here are built
with that factor set to 1."""

from __future__ import annotations

import pytest

from cvnets_tpu.options.opts import get_training_arguments as jax_args
from cvnets_tpu_torch.options.opts import get_training_arguments as torch_args


def _both(name, n, is_training, args, **kwargs):
    from cvnets_tpu.data.sampler import build_sampler as jax_build
    from cvnets_tpu_torch.data.sampler import build_sampler as port_build

    args = ["--sampler.name", name] + list(args)
    ref = jax_build(jax_args(args=args), n_data_samples=n, is_training=is_training,
                    rank=kwargs.get("rank", 0), num_replicas=kwargs.get("num_replicas", 1))
    ref.n_device_mult = 1
    port = port_build(torch_args(args=args), n_data_samples=n, is_training=is_training,
                      **kwargs)
    return ref, port


def _epochs(ref, port, epochs):
    for epoch in epochs:
        ref.set_epoch(epoch)
        port.set_epoch(epoch)
        ref.update_scales(epoch)
        port.update_scales(epoch)
        assert list(port) == list(ref), epoch
        assert len(port) == len(ref), epoch
        yield list(port)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("is_training", [True, False])
@pytest.mark.parametrize("name", ["batch_sampler", "batch_sampler_ddp"])
def test_batch_sampler_gives_the_jax_lists(name, is_training, seed):
    args = ["--common.seed", str(seed), "--dataset.train-batch-size0", "8",
            "--dataset.val-batch-size0", "6", "--sampler.bs.crop-size-width", "96",
            "--sampler.bs.crop-size-height", "80"]
    ref, port = _both(name, 45, is_training, args)
    lists = list(_epochs(ref, port, range(3)))
    bsz = 8 if is_training else 6
    for batches in lists:
        assert len(batches) == -(-45 // bsz)
        assert all(len(b) == bsz and all(t[:2] == (80, 96) for t in b) for b in batches)
        flat = [t[2] for b in batches for t in b]
        assert sorted(set(flat)) == list(range(45))  # the trailing batch padded with repeats
    assert (lists[0] != lists[1]) == is_training  # shuffled a new way each epoch


@pytest.mark.parametrize("replicas", [(0, 3), (2, 3)])
def test_batch_sampler_shards_over_replicas_as_jax(replicas):
    rank, n = replicas
    for shards in ([], ["--sampler.use-shards"]):
        ref, port = _both("batch_sampler", 50, True, ["--dataset.train-batch-size0", "4"]
                          + shards, rank=rank, num_replicas=n)
        list(_epochs(ref, port, [0, 1]))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("is_training", [True, False])
def test_variable_batch_sampler_gives_the_jax_lists(is_training, seed):
    args = ["--common.seed", str(seed), "--dataset.train-batch-size0", "16",
            "--dataset.val-batch-size0", "10", "--sampler.vbs.crop-size-width", "224",
            "--sampler.vbs.crop-size-height", "224", "--sampler.vbs.max-n-scales", "4"]
    ref, port = _both("variable_batch_sampler", 200, is_training, args)
    assert port.img_batch_tuples == ref.img_batch_tuples
    lists = list(_epochs(ref, port, range(3)))
    if is_training:
        assert len({(t[0], t[1]) for b in lists[0] for t in b}) > 1  # several scales drawn
    for batches in lists:
        assert all(len({t[:2] for t in b}) == 1 for b in batches)


def test_variable_batch_sampler_update_scales_as_jax():
    args = ["--dataset.train-batch-size0", "32", "--sampler.vbs.scale-inc",
            "--sampler.vbs.ep-intervals", "2", "4",
            "--sampler.vbs.min-scale-inc-factor", "0.25",
            "--sampler.vbs.max-scale-inc-factor", "0.5"]
    ref, port = _both("variable_batch_sampler_ddp", 300, True, args)
    before = list(port.img_batch_tuples)
    list(_epochs(ref, port, range(6)))
    assert port.img_batch_tuples == ref.img_batch_tuples != before
    assert (port.min_crop_size_h, port.max_crop_size_w) == (ref.min_crop_size_h,
                                                             ref.max_crop_size_w)


def test_multi_scale_sampler_gives_the_jax_lists():
    args = ["--dataset.train-batch-size0", "12", "--sampler.msc.crop-size-width", "192",
            "--sampler.msc.crop-size-height", "192"]
    ref, port = _both("multi_scale_sampler", 100, True, args)
    assert port.img_batch_tuples == ref.img_batch_tuples
    list(_epochs(ref, port, range(2)))


def test_image_batch_pairs_match_jax():
    from cvnets_tpu.data.sampler.utils import image_batch_pairs as ref
    from cvnets_tpu_torch.data.sampler.utils import image_batch_pairs as port

    for args in [(256, 256, 128), (224, 160, 64, 5, 32, 128, 384, 96, 256), (320, 320, 7, 3)]:
        assert port(*args) == ref(*args), args


CHAIN = [{"task_name": "fixed", "sampler_name": "batch_sampler_ddp",
          "bs": {"crop_size_width": 96, "crop_size_height": 80}},
         {"task_name": "scales", "sampler_name": "variable_batch_sampler",
          "vbs": {"crop_size_width": 128, "crop_size_height": 128, "max_n_scales": 3}}]


@pytest.mark.parametrize("is_training", [True, False])
@pytest.mark.parametrize("mode", ["sequential", "interleave"])
def test_chain_sampler_gives_the_jax_lists(mode, is_training):
    """The chain of a fixed-size and a variable-batch child, a ``_ddp`` name
    among them, in both modes: the JAX chain's batches over epochs (its
    children's device factor set to 1)."""
    args = ["--dataset.train-batch-size0", "8", "--dataset.val-batch-size0", "6",
            "--sampler.chain-sampler-mode", mode, "--common.seed", "2"]
    opts_jax = jax_args(args=["--sampler.name", "chain_sampler"] + args)
    opts_port = torch_args(args=["--sampler.name", "chain_sampler"] + args)
    for opts in (opts_jax, opts_port):
        setattr(opts, "sampler.chain_sampler", CHAIN)
    from cvnets_tpu.data.sampler import build_sampler as jax_build
    from cvnets_tpu_torch.data.sampler import build_sampler as port_build

    ref = jax_build(opts_jax, n_data_samples=70, is_training=is_training, rank=0,
                    num_replicas=1)
    for child in ref.child_samplers.values():
        child.n_device_mult = 1
    port = port_build(opts_port, n_data_samples=70, is_training=is_training)
    assert [type(c).__name__ for c in port.child_samplers.values()] == [
        "BatchSampler", "VariableBatchSampler"]
    lists = list(_epochs(ref, port, range(2)))
    shapes = [{t[:2] for t in b} for b in lists[0]]
    assert {(80, 96)} in shapes and len({s for shape in shapes for s in shape}) > 1
    if mode == "interleave":  # the children take turns while both have batches
        assert shapes[0] == {(80, 96)} and shapes[1] != {(80, 96)}
