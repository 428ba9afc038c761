"""resnet.yaml through the port's entry points on the CPU:
``cvnets_tpu_torch.main_train`` reads the yaml from its file and trains 2
epochs of ResNet-18 (the yaml's depth 50 cut to 18 by an override) at 64 px on
the port's dummy dataset, with the yaml's SGD, cosine schedule, label
smoothing and no EMA; ``main_eval`` reads its last checkpoint and gives its
last validation. Also: chip_smoke.py's ResNet-50 flag lists are the yaml's
settings, and its profile sorts the card's kernels (names as torch.profiler
gives them on an H100) into the right families."""

from __future__ import annotations

import math
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESNET_YAML = os.path.join(REPO, "config/classification/imagenet/resnet.yaml")
sys.path.insert(0, os.path.join(REPO, "tests"))

from torch_port_helpers import (  # noqa: E402
    FLAGSHIP_DUMMY_OVERRIDES,
    register_port_dummy_dataset,
    torch_threads,
)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


def _args(results, extra=()):
    return ["--common.config-file", RESNET_YAML, "--common.override-kwargs",
            *FLAGSHIP_DUMMY_OVERRIDES, "model.classification.resnet.depth=18",
            "model.classification.n_classes=10", f"common.results_loc={results}", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    import cvnets_tpu_torch.main_train as main_train
    from cvnets_tpu_torch.engine import Trainer

    register_port_dummy_dataset()
    built, stats = [], []

    class Recorded(Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            built.append(self)

        def val_epoch(self, epoch, use_ema=False):
            out = super().val_epoch(epoch, use_ema=use_ema)
            stats.append((use_ema, out))
            return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(main_train, "Trainer", Recorded)
        trainer = main_train.main_worker(args=_args(tmp_path_factory.mktemp("resnet")),
                                         device="cpu")
    assert trainer is built[-1]
    return trainer, stats


def test_resnet_yaml_trains_two_epochs_through_main_train(trained):
    from cvnets_tpu_torch.models.classification.resnet import ResNet

    trainer, stats = trained
    opts = trainer.opts
    assert isinstance(trainer.model, ResNet)
    assert getattr(opts, "model.classification.resnet.depth") == 18
    assert getattr(opts, "optim.name") == "sgd" and not getattr(opts, "ema.enable")
    assert not getattr(opts, "optim.no_decay_bn_filter_bias")
    assert [g["weight_decay"] for g in trainer.state.optimizer.param_groups] == [1e-4]
    assert isinstance(trainer.state.optimizer, torch.optim.SGD)
    assert trainer.state.ema is None
    assert trainer.train_iterations == trainer.state.step == 8  # 2 epochs of 16 / 4
    assert [ema for ema, _ in stats] == [False, False]
    assert all(math.isfinite(v) for _, s in stats for v in s.values())
    files = set(os.listdir(trainer.save_dir))
    assert {"checkpoint_last.pt", "training_checkpoint_last.pt", "config.yaml"} <= files


def test_main_eval_reads_the_checkpoint_and_gives_the_last_validation(trained):
    from cvnets_tpu_torch.main_eval import main_worker

    trainer, stats = trained
    ckpt = os.path.join(trainer.save_dir, "checkpoint_last.pt")
    got = main_worker(args=_args(os.path.dirname(trainer.save_dir),
                                 [f"model.classification.pretrained={ckpt}"]), device="cpu")
    assert got == stats[-1][1]


def test_chip_smoke_resnet_flags_are_the_yaml_settings():
    """Every value chip_smoke.py's RESNET_ARGS (with IMAGENET_RUN_ARGS and
    RESNET_DATA_ARGS, its main_train list) sets is the one resnet.yaml gives,
    but the dataset's name and the epoch count, and nothing the yaml sets is
    left out but the dataset's roots and name."""
    sys.path.insert(0, REPO)
    from chip_smoke import RESNET_MAIN_TRAIN_ARGS
    from cvnets_tpu_torch.options.opts import get_training_arguments

    default = vars(get_training_arguments(args=[]))
    flags = vars(get_training_arguments(args=RESNET_MAIN_TRAIN_ARGS))
    yaml = vars(get_training_arguments(args=["--common.config-file", RESNET_YAML]))
    set_by_flags = {k for k, v in flags.items() if v != default[k]}
    assert {"model.classification.name", "scheduler.warmup_init_lr",
            "image_augmentation.resize.size", "dataset.workers"} <= set_by_flags

    def same(flag, value):  # a one-entry list of an ``nargs="+"`` flag is its entry
        return flag == value or (isinstance(flag, list) and flag == [value])

    for dest in sorted(set_by_flags - {"dataset.name", "scheduler.max_epochs"}):
        assert same(flags[dest], yaml[dest]), dest
    for dest, value in yaml.items():
        if value != default[dest] and dest not in (
                "common.config_file", "taskname", "dataset.root_train", "dataset.root_val",
                "dataset.name", "scheduler.max_epochs"):
            assert same(flags[dest], value), dest


FAMILY_YAMLS = {"MobileNetV1-1.0": "mobilenet_v1", "MobileNetV2-1.0": "mobilenet_v2",
                "MobileNetV3-large-1.0": "mobilenet_v3", "MobileOne-s1": "mobileone",
                "EfficientNet-b0": "efficientnet_rangeaugment",
                "RegNetY-16GF": "regnet_y_16gf_rangeaugment"}
# what chip_smoke.py's family phases take from the yamls: the model, its
# norms, init and pool, the loss, the optimizer, the schedule, the EMA, the
# mixed precision and clip; its batch is the yamls' 128 at a fixed 224²
FAMILY_DESTS = ("model.", "loss.classification.", "optim.", "scheduler.", "ema.",
                "common.mixed_precision", "common.grad_clip", "dataset.train_batch_size0")


@pytest.mark.parametrize("label", sorted(FAMILY_YAMLS))
def test_chip_smoke_conv_family_flags_are_the_yaml_settings(label):
    """Each family phase of chip_smoke.py sets the yaml's value of every model,
    loss, optimizer, schedule and EMA setting, and nothing else there, but the
    RangeAugment yamls' augmentor flags (``model.learn_augmentation.*``),
    which these phases leave out (RangeAugment has a phase of its own); their
    composite loss is the classification CE these phases hold."""
    sys.path.insert(0, REPO)
    from chip_smoke import CONV_FAMILY_ARGS
    from cvnets_tpu_torch.options.opts import get_training_arguments

    yaml_path = os.path.join(REPO, "config/classification/imagenet",
                             FAMILY_YAMLS[label] + ".yaml")
    flags = vars(get_training_arguments(args=CONV_FAMILY_ARGS[label]))
    yaml = vars(get_training_arguments(args=["--common.config-file", yaml_path]))
    skipped = ("model.learn_augmentation.",)
    if "rangeaugment" in yaml_path:
        import yaml as pyyaml

        assert yaml["model.learn_augmentation.mode"] == "distribution"
        assert yaml["loss.category"] == "composite_loss"
        with open(yaml_path) as f:
            composite = pyyaml.safe_load(f)["loss"]["composite_loss"]
        ce = [c for c in composite if c["loss_category"] == "classification"][0]
        assert (flags["loss.category"], flags["loss.classification.name"]) == (
            "classification", ce["classification"]["name"])
        assert flags["loss.classification.cross_entropy.label_smoothing"] == \
            ce["classification"]["cross_entropy"]["label_smoothing"]
        skipped += ("loss.",)
    for dest in sorted(yaml):
        if dest.startswith(FAMILY_DESTS) and not dest.startswith(skipped):
            assert flags[dest] == yaml[dest], dest


# kernel names from a ResNet-50 train step's profile on the card
KERNEL_NAMES = {
    "void at::native::(anonymous namespace)::conv_depthwise2d_backward_kernel<3, 2, "
    "c10::BFloat16, int>(": "conv dgrad",
    "void at::native::(anonymous namespace)::conv_depthwise2d_grad_weight_kernel<"
    "c10::BFloat16, unsigned int>(": "conv wgrad",
    "void at::native::(anonymous namespace)::conv_depthwise2d_forward_kernel<3, "
    "c10::BFloat16, int>(": "conv fprop",
    "sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize"
    "128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_on_kernel__5x_cudnn": "conv wgrad",
    "sm90_xmma_dgrad_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize"
    "256x128x64_warpgroupsize2x1x1_g1_strided_execute_kernel__5x_cudnn": "conv dgrad",
    "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize"
    "128x128x64_warpgroupsize1x1x1_g1_execute_segment_k_off_kernel__5x_cudnn": "conv fprop",
    "void cudnn::cnn::reduce_wgrad_nchw_helper<float, __nv_bfloat16>(": "conv wgrad",
    "nvjet_tst_448x64_64x2_1x1_v_bz_coopB_NTN": "gemm",
    "nvjet_tss_64x128_64x8_1x2_h_bz_TNN": "gemm",
    "void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_256x128_64x3_nn_"
    "align2>(": "gemm",
    "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, "
    "float, false, true, (cudnnKernelDataType_t)0>(": "layout transform",
    "void at::native::batch_norm_backward_kernel<c10::BFloat16, float, float, int>(":
        "batch norm",
    "void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<"
    "c10::BFloat16>, std::array<char*, 3ul> >(": "elementwise",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<at::native::"
    "(anonymous namespace)::TensorListMetadata<2>, ": "optimizer",
    "Memset (Device)": "memcpy / memset",
}


@pytest.mark.parametrize("name", sorted(KERNEL_NAMES))
def test_chip_smoke_kernel_family(name):
    sys.path.insert(0, REPO)
    from chip_smoke import kernel_family

    assert kernel_family(name) == KERNEL_NAMES[name]
