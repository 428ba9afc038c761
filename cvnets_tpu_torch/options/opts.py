"""Argument aggregation over the port's registries (counterpart of
cvnets_tpu/options/opts.py:158-169, which imports the flax registries).

Flag names, dests and defaults are those of the JAX parser; only the flags of the
ported slice are registered, so a yaml key the port cannot honour yet is reported
by ``load_config_file`` instead of being silently accepted.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from cvnets_tpu_torch.options.parse_args import ParseKwargs
from cvnets_tpu_torch.options.utils import load_config_file


def arguments_common(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="Common arguments")
    group.add_argument("--taskname", type=str, default="", help="Task name (free-form)")
    group.add_argument("--common.seed", type=int, default=0, help="Random seed")
    group.add_argument("--common.config-file", type=str, default=None)
    group.add_argument("--common.results-loc", type=str, default="results")
    group.add_argument("--common.run-label", type=str, default="run_1")
    group.add_argument("--common.resume", type=str, default=None)
    group.add_argument("--common.finetune", type=str, default=None)
    group.add_argument("--common.finetune-ema", type=str, default=None)
    group.add_argument("--common.mixed-precision", action="store_true")
    group.add_argument(
        "--common.int8-inference", action="store_true",
        help="Int8 conv/linear forward of an eval model (quantization/); float "
             "checkpoints load unchanged, and prequantize() stores the weights in int8",
    )
    group.add_argument(
        "--common.int8-mode", type=str, default="weight-only",
        choices=("dynamic", "weight-only"),
        help="'weight-only': int8 weights dequantized into the compute dtype's "
             "products; 'dynamic': s8 x s8 -> s32 products with per-row (linear) "
             "and per-sample (conv) activation scales",
    )
    group.add_argument(
        "--common.mixed-precision-dtype", type=str, default="bfloat16",
        choices=["float16", "bfloat16", "float32"],
        help="Autocast dtype under mixed precision; parameters stay float32",
    )
    group.add_argument("--common.accum-freq", type=int, default=1)
    group.add_argument("--common.accum-after-epoch", type=int, default=0)
    group.add_argument("--common.log-freq", type=int, default=100)
    group.add_argument("--common.profile-trace-dir", type=str, default=None)
    group.add_argument("--common.auto-resume", action="store_true")
    group.add_argument("--common.grad-clip", type=float, default=None)
    group.add_argument("--common.k-best-checkpoints", type=int, default=5)
    group.add_argument("--common.save-all-checkpoints", action="store_true", default=False)
    group.add_argument("--common.save-interval-freq", type=int, default=0)
    group.add_argument("--common.tensorboard-logging", action="store_true",
                       help="Write the epoch summaries through TensorBoard's writer "
                            "(engine/utils.py; JSONL where tensorboard is missing)")
    group.add_argument("--common.inference-modality", type=str, default="image",
                       choices=["image", "video"],
                       help="video: the evaluation votes over each video's clips")
    group.add_argument(
        "--common.override-kwargs", nargs="*", action=ParseKwargs,
        help="Override config entries, e.g. sampler.bs.crop_size_width=512",
    )
    return parser


def arguments_dev(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The device flags (cvnets_tpu/options/opts.py:89-131): the port runs one
    process a card over ``--dev.num-devices`` cards (parallel/mesh.py), laid
    out as the (data, model) grid of ``--dev.mesh-shape``; ``--dev.fsdp``
    shards the state over the data axis (parallel/fsdp.py) and
    ``--dev.sequence-parallel`` runs attention as a ring over the model axis
    (parallel/ring_attention.py)."""
    group = parser.add_argument_group(title="Device arguments")
    group.add_argument("--dev.device", type=str, default=None,
                       help="Parsed and not read: the entry points take their device")
    group.add_argument("--dev.num-devices", type=int, default=-1,
                       help="Cards to train on, one process a card; -1 = every visible card")
    group.add_argument("--dev.mesh-shape", type=int, nargs="*", default=None,
                       help="The process grid, e.g. 8 (data parallel) or 4 2 (data x "
                            "model: tensor and expert parallelism over the model axis)")
    group.add_argument("--dev.mesh-axis-names", type=str, nargs="*", default=None,
                       help="Names of the mesh axes; default data, or data model")
    group.add_argument("--dev.fsdp", action="store_true", default=False,
                       help="Shard the parameters, optimizer moments and EMA over the "
                            "data axis (leaves of 8192 elements or more)")
    group.add_argument("--dev.sequence-parallel", action="store_true", default=False,
                       help="Ring attention over the model axis where it divides the "
                            "token count")
    return parser


def arguments_ddp(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """The process-group flags (cvnets_tpu/options/opts.py:134-145, inert
    there). The ``--dev.num-devices`` processes join ``--ddp.dist-url``
    (default ``tcp://localhost:<--ddp.dist-port>``) over ``--ddp.backend``;
    its default keeps the JAX package's value, ``xla``, which here means the
    device's own backend, NCCL on a card and gloo on the CPU (``gloo`` is
    taken on a card as well). Under ``torchrun`` its environment gives the
    ranks. ``--ddp.rank``, ``--ddp.world-size``, ``--ddp.device-id``,
    ``--ddp.find-unused-params`` and ``--ddp.use-deprecated-data-parallel``
    parse and are not read: ``torchrun`` ranks the hosts, ``--dev.num-devices``
    sets the process count, a rank's card is its local rank, and the
    gradients' all-reduce (``parallel.sync_gradients``) skips parameters
    without a gradient on every rank alike."""
    group = parser.add_argument_group(title="DDP arguments")
    group.add_argument("--ddp.rank", type=int, default=0)
    group.add_argument("--ddp.world-size", type=int, default=-1)
    group.add_argument("--ddp.dist-url", type=str, default=None)
    group.add_argument("--ddp.dist-port", type=int, default=30786)
    group.add_argument("--ddp.device-id", type=int, default=None)
    group.add_argument("--ddp.backend", type=str, default="xla",
                       help="nccl or gloo; xla (the default): nccl on a card, gloo on "
                            "the CPU")
    group.add_argument("--ddp.find-unused-params", action="store_true", default=False)
    group.add_argument("--ddp.use-deprecated-data-parallel", action="store_true",
                       default=False)
    return parser


def get_training_arguments(parse_args: bool = True, args: Optional[List[str]] = None):
    from cvnets_tpu_torch.data.datasets import arguments_dataset
    from cvnets_tpu_torch.data.sampler import add_sampler_arguments
    from cvnets_tpu_torch.data.text_tokenizer import arguments_tokenizer
    from cvnets_tpu_torch.data.transforms import arguments_augmentation
    from cvnets_tpu_torch.data.video_reader import arguments_video_reader
    from cvnets_tpu_torch.loss import add_loss_fn_arguments
    from cvnets_tpu_torch.metrics import arguments_stats
    from cvnets_tpu_torch.models import modeling_arguments
    from cvnets_tpu_torch.modules.moe import arguments_moe
    from cvnets_tpu_torch.optim import arguments_optimizer
    from cvnets_tpu_torch.optim.scheduler import arguments_scheduler
    from cvnets_tpu_torch.options.utils import extend_selected_args_with_prefix

    parser = argparse.ArgumentParser(description="Training arguments (PyTorch port)")
    parser = arguments_dataset(parser)
    parser = add_sampler_arguments(parser)
    parser = arguments_tokenizer(parser)
    parser = arguments_augmentation(parser)
    # every --image-augmentation.* flag again as --frame-augmentation.*, the video
    # readers' per-frame augmentations (cvnets_tpu/options/opts.py:176-185)
    parser = extend_selected_args_with_prefix(parser, "--image-augmentation.",
                                              "--frame-augmentation.")
    parser = arguments_video_reader(parser)
    parser = modeling_arguments(parser)
    # outside the --model.* flags the teacher clones, as cvnets_tpu/options/opts.py:125
    parser = arguments_moe(parser)
    parser = add_loss_fn_arguments(parser)
    parser = arguments_optimizer(parser)
    parser = arguments_scheduler(parser)
    parser = arguments_common(parser)
    parser = arguments_dev(parser)
    parser = arguments_ddp(parser)
    parser = arguments_stats(parser)
    if parse_args:
        return load_config_file(parser.parse_args(args))
    return parser


def get_eval_arguments(parse_args: bool = True, args: Optional[List[str]] = None):
    """The evaluation flags are the training flags, as in the JAX package."""
    return get_training_arguments(parse_args=parse_args, args=args)


def _with_group(title: str, flags, args: Optional[List[str]]):
    parser = get_training_arguments(parse_args=False)
    group = parser.add_argument_group(title)
    for flag, kwargs in flags:
        group.add_argument(flag, **kwargs)
    return load_config_file(parser.parse_args(args))


def get_conversion_arguments(args: Optional[List[str]] = None):
    """``main_conversion``'s flags (cvnets_tpu/options/opts.py:208-224; the
    coreml, bucket and viewer flags are kept for the configs' sake)."""
    return _with_group("Conversion arguments", [
        ("--conversion.coreml-extn", dict(type=str, default="mlmodel")),
        ("--conversion.input-image-path", dict(type=str, default=None)),
        ("--conversion.bucket-name", dict(type=str)),
        ("--conversion.task-id", dict(type=str)),
        ("--conversion.viewers", dict(type=str, nargs="+", default=None)),
        ("--conversion.reparameterize", dict(
            action="store_true", default=False,
            help="Fold re-parameterizable branches (MobileOne, FastViT) into deploy "
                 "form before export")),
    ], args)


def get_benchmarking_arguments(args: Optional[List[str]] = None):
    """``main_benchmark``'s flags (cvnets_tpu/options/opts.py:226-240)."""
    return _with_group("Benchmarking arguments", [
        ("--benchmark.batch-size", dict(type=int, default=1)),
        ("--benchmark.warmup-iter", dict(type=int, default=10)),
        ("--benchmark.n-iter", dict(type=int, default=100)),
        ("--benchmark.use-jit-model", dict(action="store_true")),
        ("--benchmark.data-pipeline", dict(
            action="store_true", default=False,
            help="Time the host's JPEG decode, train transforms and collate instead "
                 "of the model's inference")),
        ("--benchmark.data-pipeline-samples", dict(type=int, default=512)),
    ], args)


def get_loss_landscape_args(args: Optional[List[str]] = None):
    """``main_loss_landscape``'s flags (cvnets_tpu/options/opts.py:242-)."""
    return _with_group("Loss landscape related arguments", [
        ("--loss-landscape.n-points", dict(type=int, default=11)),
        ("--loss-landscape.min-x", dict(type=float, default=-1.0)),
        ("--loss-landscape.max-x", dict(type=float, default=1.0)),
        ("--loss-landscape.min-y", dict(type=float, default=-1.0)),
        ("--loss-landscape.max-y", dict(type=float, default=1.0)),
    ], args)
