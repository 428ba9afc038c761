"""The PyTorch port stands without JAX, and keeps the JAX package's flags.

* ``cvnets_tpu_torch`` (its process-group, model-parallel, log-writer,
  chain-sampler and extra-metric modules and its rehearsal tools too)
  imports and runs CPU train steps of MobileViTv2, ViT,
  DeepLabv3, PSPNet with frozen BN, Swin, SE-ResNet-18 and MobileOne-s0 (then
  folded), one epoch of a micro MobileViTv2 ``Trainer`` (its ``config.yaml``
  dump and checkpoints), ``main_train`` for 2 epochs on chip_smoke.py's
  flagship flags at 64 px on the port's dummy dataset with every augmentation,
  then ``main_eval``, and ``main_train`` for an epoch on its DeepLabv3 flags
  (the segmentation transforms, masks, iou) at 64 px on the port's dummy
  segmentation dataset, then ``main_worker_segmentation``, MobileViT v1 and
  FastViT forwards, an SSDLite loss, backward and ``predict``, the detection
  transforms and the COCO mAP, a CLIP train step (the micro ViT under a
  causal text tower), and a Mask R-CNN train step, ``predict`` with masks
  and the segm mAP, with ``jax``,
  ``flax``, ``optax``, ``orbax``, ``yaml``, ``PIL`` and the JAX package
  ``cvnets_tpu`` blocked (a subprocess: tests/conftest.py has imported jax
  into this one). A second subprocess, with ``jax``, ``flax``, ``optax``,
  ``orbax`` and ``cvnets_tpu`` blocked, writes a flickr folder through Pillow
  and trains CLIP on it through ``main_train`` from clip_vit.yaml.
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
    for name in ("jax", "flax", "optax", "orbax", "yaml", "PIL", "cvnets_tpu"):
        sys.modules[name] = None  # any import of them now raises ImportError
    import os
    import tempfile
    import torch
    torch.set_num_threads(2)  # the suite's other workers share the cores
    from cvnets_tpu_torch.engine import Evaluator, Trainer
    from cvnets_tpu_torch.engine import utils as log_writers  # noqa: F401
    from cvnets_tpu_torch.data.sampler import chain_sampler  # noqa: F401
    from cvnets_tpu_torch.metrics import extra_metrics  # noqa: F401
    from cvnets_tpu_torch import parallel  # noqa: F401
    from cvnets_tpu_torch.parallel import fsdp, ring_attention, sharding_rules  # noqa: F401
    from cvnets_tpu_torch.parallel import tensor_parallel  # noqa: F401
    from cvnets_tpu_torch.utils import common_utils  # noqa: F401
    from cvnets_tpu_torch.engine.train_state import create_train_state, make_train_step
    from cvnets_tpu_torch.loss import build_loss_fn
    from cvnets_tpu_torch.metrics import build_metrics
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.optim import build_optimizer
    from cvnets_tpu_torch.optim.scheduler import build_scheduler
    from cvnets_tpu_torch.options.opts import get_training_arguments

    opts = get_training_arguments(args=[
        "--model.classification.name", "mobilevit_v2",
        "--model.classification.mitv2.width-multiplier", "0.5",
        "--model.classification.n-classes", "10",
        "--optim.name", "adamw", "--ema.enable"])
    model = get_model(opts, device="cpu").eval()
    x = torch.rand(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits = model(x)
    assert logits.shape == (2, 10) and bool(torch.isfinite(logits).all())
    state = create_train_state(model, build_optimizer(opts, model), ema_enabled=True)
    metric_objs = build_metrics(opts, ["loss", "grad_norm"])
    step = make_train_step(model, build_loss_fn(opts), opts, metric_objs)
    state, metrics = step(state, {"samples": x, "targets": torch.tensor([1, 2])},
                          build_scheduler(opts).retrieve_lr(0, 0))
    assert bool(torch.isfinite(metrics["loss"]["loss"][0]))
    with tempfile.TemporaryDirectory() as results:
        trainer_opts = get_training_arguments(args=[
            "--model.classification.name", "mobilevit_v2",
            "--model.classification.mitv2.width-multiplier", "0.5",
            "--model.classification.n-classes", "10", "--optim.name", "adamw",
            "--ema.enable", "--stats.val", "loss", "top1", "top5",
            "--common.k-best-checkpoints", "2", "--common.save-interval-freq", "1",
            "--scheduler.max-epochs", "1", "--common.results-loc", results])
        batches = [{"samples": (x * 255).to(torch.uint8), "targets": torch.tensor([1, 2])}]
        trainer = Trainer(trainer_opts, get_model(trainer_opts, device="cpu"),
                          build_loss_fn(trainer_opts), batches, batches, device="cpu")
        trainer.run()
        for name in ("config.yaml", "training_checkpoint_last.pt", "checkpoint_ema_best.pt",
                     "checkpoint_iter_1.pt"):
            assert os.path.isfile(os.path.join(trainer.save_dir, name)), name
        stats = Evaluator(trainer_opts, get_model(trainer_opts, device="cpu"), batches,
                          checkpoint=os.path.join(trainer.save_dir, "checkpoint_last.pt"),
                          device="cpu").eval_fn_image()
        assert set(stats) == {"loss", "top1", "top5"}
    sys.path[:0] = ["tests", "."]
    from cvnets_tpu_torch.tools import rehearse_ddp_checks  # noqa: F401
    from cvnets_tpu_torch.tools import rehearse_model_parallel_checks  # noqa: F401
    from chip_smoke import MAIN_TRAIN_ARGS
    from torch_port_helpers import register_port_dummy_dataset
    from cvnets_tpu_torch.main_eval import main_worker as main_eval
    from cvnets_tpu_torch.main_train import main_worker as main_train
    register_port_dummy_dataset()
    with tempfile.TemporaryDirectory() as results:  # the flagship's flags at 64 px
        small = MAIN_TRAIN_ARGS + [
            "--dataset.name", "dummy_classification", "--dataset.workers", "2",
            "--dataset.train-batch-size0", "4", "--dataset.val-batch-size0", "4",
            "--dataset.eval-batch-size0", "4", "--sampler.bs.crop-size-width", "64",
            "--sampler.bs.crop-size-height", "64", "--image-augmentation.resize.size", "72",
            "--image-augmentation.center-crop.size", "64", "--common.results-loc", results]
        trainer = main_train(args=small, device="cpu")
        assert trainer.train_iterations == 8
        stats = main_eval(args=small + ["--model.classification.pretrained", os.path.join(
            trainer.save_dir, "checkpoint_ema_last.pt")], device="cpu")
        assert set(stats) == {"loss", "top1", "top5"}
    from chip_smoke import SEG_MAIN_TRAIN_ARGS
    from torch_port_helpers import register_port_dummy_segmentation_dataset
    from cvnets_tpu_torch.main_eval import main_worker_segmentation
    register_port_dummy_segmentation_dataset()
    with tempfile.TemporaryDirectory() as results:  # the DeepLabv3 flags at 64 px
        small = SEG_MAIN_TRAIN_ARGS + [
            "--dataset.name", "dummy_segmentation", "--dataset.workers", "2",
            "--dataset.train-batch-size0", "2", "--dataset.val-batch-size0", "2",
            "--dataset.eval-batch-size0", "2", "--sampler.bs.crop-size-width", "64",
            "--sampler.bs.crop-size-height", "64",
            "--image-augmentation.random-short-size-resize.short-side-min", "48",
            "--image-augmentation.random-short-size-resize.short-side-max", "96",
            "--image-augmentation.random-short-size-resize.max-img-dim", "128",
            "--model.classification.mitv2.width-multiplier", "0.5",
            "--model.segmentation.deeplabv3.aspp-out-channels", "32",
            "--scheduler.max-epochs", "1", "--common.results-loc", results]
        trainer = main_train(args=small, device="cpu")
        assert trainer.train_iterations == 4
        miou = main_worker_segmentation(args=small + [
            "--model.segmentation.pretrained",
            os.path.join(trainer.save_dir, "checkpoint_ema_last.pt"),
            "--evaluation.segmentation.resize-input-images-fixed-size", "64", "64"],
            device="cpu")
        assert 0.0 <= miou <= 100.0
    vit_opts = get_training_arguments(args=[
        "--model.classification.name", "vit", "--model.classification.vit.mode", "micro",
        "--model.classification.n-classes", "10", "--model.activation.name", "gelu",
        "--optim.name", "adamw"])
    vit = get_model(vit_opts, device="cpu")
    state = create_train_state(vit, build_optimizer(vit_opts, vit))
    state, metrics = make_train_step(vit, build_loss_fn(vit_opts), vit_opts, metric_objs)(
        state, {"samples": x, "targets": torch.tensor([1, 2])}, 1e-3)
    assert bool(torch.isfinite(metrics["loss"]["loss"][0]))
    seg_opts = get_training_arguments(args=[
        "--dataset.category", "segmentation", "--model.segmentation.name", "encoder_decoder",
        "--model.segmentation.n-classes", "5", "--model.segmentation.output-stride", "16",
        "--model.segmentation.use-aux-head", "--model.segmentation.lr-multiplier", "10",
        "--model.segmentation.deeplabv3.aspp-out-channels", "16",
        "--model.classification.name", "mobilevit_v2",
        "--model.classification.mitv2.width-multiplier", "0.5",
        "--loss.category", "segmentation", "--optim.name", "sgd", "--ema.enable"])
    seg = get_model(seg_opts, device="cpu")
    state = create_train_state(
        seg, build_optimizer(seg_opts, seg, seg.get_lr_multipliers(seg_opts)),
        ema_enabled=True)
    y = torch.randint(0, 5, (2, 64, 64), generator=torch.Generator().manual_seed(1))
    y[0, :8] = 255
    state, metrics = make_train_step(seg, build_loss_fn(seg_opts), seg_opts, metric_objs)(
        state, {"samples": x, "targets": y}, 1e-3)
    assert {"loss.seg_loss", "loss.aux_loss", "loss"} <= set(metrics["loss"])
    assert bool(torch.isfinite(metrics["loss"]["loss"][0]))
    psp_opts = get_training_arguments(args=[
        "--dataset.category", "segmentation", "--model.segmentation.name", "encoder_decoder",
        "--model.segmentation.n-classes", "5", "--model.segmentation.output-stride", "8",
        "--model.segmentation.seg-head", "pspnet", "--model.segmentation.freeze-batch-norm",
        "--model.segmentation.pspnet.psp-out-channels", "16",
        "--model.classification.name", "mobilevit_v2",
        "--model.classification.mitv2.width-multiplier", "0.5",
        "--loss.category", "segmentation", "--optim.name", "sgd"])
    psp = get_model(psp_opts, device="cpu")
    state = create_train_state(psp, build_optimizer(psp_opts, psp))
    state, metrics = make_train_step(psp, build_loss_fn(psp_opts), psp_opts, metric_objs)(
        state, {"samples": x, "targets": y.to(torch.uint8)}, 1e-3)
    assert bool(torch.isfinite(metrics["loss"]["loss"][0]))
    from cvnets_tpu_torch.models.classification import swin_transformer
    swin_transformer._MODES["micro"] = (48, [2, 2, 2, 2], [3, 6, 12, 24])  # D = 16: fused route
    swin_opts = get_training_arguments(args=[
        "--model.classification.name", "swin", "--model.classification.swin.mode", "micro",
        "--model.classification.n-classes", "10", "--model.activation.name", "gelu",
        "--optim.name", "adamw", "--optim.no-decay-bn-filter-bias",
        "--common.grad-clip", "5", "--ema.enable"])
    swin = get_model(swin_opts, device="cpu")
    state = create_train_state(swin, build_optimizer(swin_opts, swin), ema_enabled=True)
    state, metrics = make_train_step(swin, build_loss_fn(swin_opts), swin_opts, metric_objs)(
        state, {"samples": x, "targets": torch.tensor([1, 2])}, 1e-3)
    assert bool(torch.isfinite(metrics["loss"]["loss"][0]))
    from cvnets_tpu_torch.utils.reparam_utils import reparameterize_model
    for name, extra in (("resnet", ["--model.classification.resnet.depth", "18",
                                    "--model.classification.resnet.se-resnet"]),
                        ("mobileone", ["--model.classification.mobileone.variant", "s0"])):
        conv_opts = get_training_arguments(args=[
            "--model.classification.name", name, "--model.classification.n-classes", "10",
            "--optim.name", "sgd", *extra])
        conv = get_model(conv_opts, device="cpu")
        state = create_train_state(conv, build_optimizer(conv_opts, conv))
        state, metrics = make_train_step(conv, build_loss_fn(conv_opts), conv_opts,
                                         metric_objs)(
            state, {"samples": x, "targets": torch.tensor([1, 2])}, 1e-3)
        assert bool(torch.isfinite(metrics["loss"]["loss"][0]))
    with torch.no_grad():  # the trained MobileOne-s0, folded
        before = conv.eval()(x)
        assert torch.allclose(reparameterize_model(conv)(x), before, atol=1e-4)
    from cvnets_tpu_torch import native
    from cvnets_tpu_torch.native.plain import crop_resize_flip
    raster = torch.randint(0, 256, (75, 100, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    out = crop_resize_flip(raster, (5, 4, 60, 50), True, (24, 32))
    assert out.shape == (3, 24, 32) and out.dtype == torch.uint8
    assert native.crop_resize_flip_kernel.launches == 0
    # MobileViT v1 (the resize route at 80 px), FastViT, and SSDLite: a train
    # step's loss and grads, predict, the detection transforms and the COCO mAP
    import random
    import numpy as np
    from cvnets_tpu_torch.data.transforms.image import PhotometricDistort, SSDCroping
    from cvnets_tpu_torch.metrics.coco_map import compute_coco_map
    for extra in (["--model.classification.name", "mobilevit",
                   "--model.classification.mit.mode", "xx_small"],
                  ["--model.classification.name", "fastvit",
                   "--model.classification.fastvit.variant", "T8"]):
        opts = get_training_arguments(args=extra + ["--model.classification.n-classes", "7"])
        logits = get_model(opts, device="cpu").eval()(torch.rand(1, 3, 80, 80))
        assert logits.shape == (1, 7) and bool(torch.isfinite(logits).all())
    strides = ["--anchor-generator.ssd.output-strides", "16", "32", "64", "-1"]
    opts = get_training_arguments(args=strides + [
        "--dataset.category", "detection", "--model.detection.name", "ssd",
        "--model.detection.n-classes", "4", "--model.classification.name", "mobilevit",
        "--model.classification.mit.mode", "xx_small", "--loss.category", "detection",
        "--loss.detection.name", "ssd_multibox_loss"])
    model = get_model(opts, device="cpu")
    pred = model(torch.rand(2, 3, 96, 96))
    n = pred["anchors"].shape[0]
    labels = torch.zeros(2, n, dtype=torch.long)
    labels[:, :5] = 2
    loss = build_loss_fn(opts)(None, pred, {"box_labels": labels,
                                            "box_coordinates": torch.zeros(2, n, 4)})
    loss.backward()
    assert bool(torch.isfinite(loss))
    out = model.predict(torch.rand(2, 3, 96, 96))
    assert out.boxes.shape == (2, 200, 4)
    img = torch.randint(0, 256, (3, 40, 50), dtype=torch.uint8)
    distort = PhotometricDistort(opts)
    img = distort.apply({"image": img}, distort.draw(random.Random(0), (40, 50))[0])["image"]
    boxes = np.array([[5, 5, 30, 25]], np.float32)
    crop = SSDCroping(opts).draw_crop(random.Random(1), (40, 50), boxes)
    SSDCroping.apply_crop({"image": img, "box_coordinates": boxes,
                           "box_labels": np.array([1])}, crop)
    res = compute_coco_map([{"boxes": boxes, "scores": np.ones(1), "labels": [1]}],
                           [{"boxes": boxes, "labels": [1]}])
    assert res["bbox"] == 1.0
    clip_opts = get_training_arguments(args=[
        "--dataset.category", "multi_modal_image_text", "--loss.category",
        "multi_modal_image_text", "--model.multi-modal-image-text.name", "clip",
        "--model.classification.name", "vit", "--model.classification.vit.mode", "micro",
        "--model.text.vocab-size", "100", "--model.text.context-length", "16",
        "--model.text.transformer.model-dim", "64",
        "--model.text.transformer.n-transformer-layers", "2",
        "--model.text.transformer.n-heads-per-layer", "4",
        "--model.text.transformer.causal-masking", "--optim.name", "adamw",
        "--optim.no-decay-bn-filter-bias", "--common.grad-clip", "1", "--ema.enable"])
    clip = get_model(clip_opts, device="cpu")
    state = create_train_state(clip, build_optimizer(clip_opts, clip), ema_enabled=True)
    text = torch.randint(1, 98, (2, 16), generator=torch.Generator().manual_seed(3))
    text[:, 9], text[:, 10:] = 99, 0
    state, metrics = make_train_step(clip, build_loss_fn(clip_opts), clip_opts, metric_objs)(
        state, {"samples": {"image": (x * 255).to(torch.uint8), "text": text},
                "targets": torch.arange(2)}, 1e-3)
    assert {"loss", "loss.image_loss", "loss.text_loss"} <= set(metrics["loss"])
    assert bool(torch.isfinite(metrics["loss"]["loss"][0]))
    # Mask R-CNN on MobileViTv2: a train step (its five losses, the backbone's
    # LR multiplier), predict with the masks pasted, and the segm mAP
    mr_opts = get_training_arguments(args=[
        "--dataset.category", "detection", "--model.detection.name", "mask_rcnn",
        "--model.detection.n-classes", "4", "--model.classification.name", "mobilevit_v2",
        "--model.classification.mitv2.width-multiplier", "0.5",
        "--model.detection.mask-rcnn.fpn-out-channels", "16",
        "--model.detection.mask-rcnn.pre-nms-top-n", "32",
        "--model.detection.mask-rcnn.post-nms-top-n", "8",
        "--model.detection.mask-rcnn.box-batch-per-image", "8",
        "--model.detection.mask-rcnn.mask-positives", "2",
        "--model.detection.mask-rcnn.detections-per-image", "4",
        "--model.detection.mask-rcnn.backbone-lr-multiplier", "0.5",
        "--loss.category", "detection", "--loss.detection.name", "mask_rcnn_loss",
        "--optim.name", "adamw"])
    mrcnn = get_model(mr_opts, device="cpu")
    state = create_train_state(mrcnn, build_optimizer(mr_opts, mrcnn,
                                                      mrcnn.get_lr_multipliers(mr_opts)))
    gt_boxes = torch.zeros(2, 100, 4)
    gt_boxes[:, 0] = torch.tensor([8.0, 8.0, 40.0, 48.0])
    gt_labels = torch.zeros(2, 100, dtype=torch.long)
    gt_labels[:, 0] = 2
    gt_masks = torch.zeros(2, 100, 16, 16, dtype=torch.bool)
    gt_masks[:, 0, 2:12, 2:10] = True
    targets = {"box_coordinates": gt_boxes, "box_labels": gt_labels, "masks": gt_masks}
    state, metrics = make_train_step(mrcnn, build_loss_fn(mr_opts), mr_opts, metric_objs)(
        state, {"samples": {"image": (x * 255).to(torch.uint8), "targets": targets},
                "targets": {}}, 1e-3)
    assert {"loss", "loss.loss_mask", "loss.loss_objectness"} <= set(metrics["loss"])
    assert bool(torch.isfinite(metrics["loss"]["loss"][0]))
    out = mrcnn.predict(x)
    assert out.masks.shape == (2, 4, 64, 64) and bool(torch.isfinite(out.masks).all())
    one = {"boxes": gt_boxes[0, :1].numpy(), "labels": [2], "masks": [gt_masks[0, 0].numpy()]}
    res = compute_coco_map([{**one, "scores": np.ones(1)}], [one], iou_type="segm")
    assert res["segm"] == 1.0
    leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                    and m.split(".")[0] in ("jax", "flax", "optax", "orbax", "yaml",
                                            "PIL", "cvnets_tpu"))
    assert not leaked, leaked
    print("ok")
""")

_CLIP_MAIN_TRAIN = textwrap.dedent("""
    import sys
    for name in ("jax", "flax", "optax", "orbax", "cvnets_tpu"):
        sys.modules[name] = None  # any import of them now raises ImportError
    import os
    import tempfile
    import numpy as np
    import torch
    from PIL import Image
    torch.set_num_threads(2)  # the suite's other workers share the cores
    from cvnets_tpu_torch.main_train import main_worker
    with tempfile.TemporaryDirectory() as root:
        os.mkdir(os.path.join(root, "images"))
        rng = np.random.default_rng(0)
        with open(os.path.join(root, "captions.tsv"), "w") as f:
            for i in range(8):
                Image.fromarray(rng.integers(0, 256, (40 + i, 50, 3), dtype=np.uint8)).save(
                    os.path.join(root, "images", f"{i}.jpg"))
                f.write(f"images/{i}.jpg\\ta photo of thing {i}\\n")
        trainer = main_worker(args=[
            "--common.config-file", "config/multi_modal_image_text/clip_vit.yaml",
            "--common.override-kwargs", f"dataset.root_train={root}",
            f"dataset.root_val={root}", "dataset.train_batch_size0=4",
            "dataset.val_batch_size0=4", "dataset.workers=2",
            "sampler.bs.crop_size_width=32", "sampler.bs.crop_size_height=32",
            "image_augmentation.resize.size=32", "scheduler.max_iterations=2",
            "model.classification.vit.mode=micro", "model.text.vocab_size=100",
            "model.text.context_length=16", "model.text.transformer.model_dim=64",
            "model.text.transformer.n_transformer_layers=2",
            "model.text.transformer.n_heads_per_layer=4",
            "model.multi_modal_image_text.clip.projection_dim=32",
            f"common.results_loc={os.path.join(root, 'results')}"], device="cpu")
        assert trainer.train_iterations == 2
        assert os.path.isfile(os.path.join(trainer.save_dir, "checkpoint_last.pt"))
    leaked = sorted(m for m in sys.modules if sys.modules[m] is not None
                    and m.split(".")[0] in ("jax", "flax", "optax", "orbax", "cvnets_tpu"))
    assert not leaked, leaked
    print("ok")
""")


def test_port_imports_and_runs_without_jax_yaml_or_pil():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": REPO})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")


def test_clip_main_train_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", _CLIP_MAIN_TRAIN], cwd=REPO,
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


@pytest.mark.parametrize("getter, prefix", [
    ("get_conversion_arguments", "conversion."),
    ("get_benchmarking_arguments", "benchmark."),
    ("get_loss_landscape_args", "loss_landscape."),
])
def test_serving_entry_point_flags_have_the_jax_dests_and_defaults(getter, prefix):
    """The flags main_conversion, main_benchmark and main_loss_landscape add
    to the training flags: the same dests, and the same values when parsed
    from nothing and from explicit values."""
    from cvnets_tpu.options import opts as jax_opts
    from cvnets_tpu_torch.options import opts as port_opts

    parse_jax, parse_port = getattr(jax_opts, getter), getattr(port_opts, getter)
    jax_ns, port_ns = vars(parse_jax(args=[])), vars(parse_port(args=[]))
    jax_own = {k: v for k, v in jax_ns.items() if k.startswith(prefix)}
    assert jax_own and jax_own == {k: v for k, v in port_ns.items() if k.startswith(prefix)}
    flags = {"conversion.": ["--conversion.reparameterize", "--conversion.input-image-path",
                             "x.jpg", "--conversion.viewers", "a", "b"],
             "benchmark.": ["--benchmark.batch-size", "128", "--benchmark.n-iter", "7",
                            "--benchmark.data-pipeline"],
             "loss_landscape.": ["--loss-landscape.n-points", "5",
                                 "--loss-landscape.min-x", "-0.5"]}[prefix]
    args = flags + ["--common.int8-inference", "--common.int8-mode", "dynamic"]
    jax_ns, port_ns = vars(parse_jax(args=args)), vars(parse_port(args=args))
    for dest in [*jax_own, "common.int8_inference", "common.int8_mode"]:
        assert port_ns[dest] == jax_ns[dest], dest


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
