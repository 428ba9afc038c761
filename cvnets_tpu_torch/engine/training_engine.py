"""Trainer (counterpart of cvnets_tpu/engine/training_engine.py:45-467).

The loop of the JAX Trainer on one device: the LR from the scheduler each
iteration, the annealed BN momentum, the step without accumulation for the
epochs before ``--common.accum-after-epoch``, each step's (sum, count) pairs
added on the device and read back only every ``--common.log-freq`` iterations
and at the end of the epoch, interval checkpoints, a validation epoch (and an
EMA one), ``--ema.copy-at-epoch``, the checkpoint metric with its fallbacks,
the epoch-end checkpoints, and auto-resume when the Trainer is built.

Batches are dicts of tensors (``samples``, ``targets``; samples may be a
dict themselves, CLIP's image and text), moved to the Trainer's device by
``parallel.device_prefetch`` ahead of their step: from a loader that pins its
host memory the copy overlaps the step. A batch counts its first leaf's
rows. A validation dataset with ``class_caption_tokens`` (the zero-shot set
that ``--dataset.multi-modal-img-text.zero-shot-eval`` puts in the val
split's place) is scored by ``evaluation_engine.zero_shot_eval``. Each
epoch starts with the train sampler's ``set_epoch`` and ``update_scales``.
The train step runs the device-tier augmentation and mixup / cutmix the
options enable. The resolved options go to ``save_dir/config.yaml`` as
JSON, which YAML reads.

``--common.finetune`` (and ``--common.finetune-ema``) load a checkpoint of
the port into the fresh model with the JAX package's scope surgery
(``utils/checkpoint_utils.load_finetune``), before any resume.

Sample-efficient training (``--dataset.sample-efficient-training.*``,
training_engine.py:79-94, 375-421): every ``find-easy-samples-every-k-epochs``
epochs from ``min-sample-frequency`` on, an eval-mode pass over the train
loader finds the samples whose class the model predicts with a true-class
probability of at least ``sample-confidence``; a sample found so twice leaves
the sampler's list, unless that would leave fewer than max(16, a tenth).

In a process group (``parallel``) each data rank trains on its shard of
every batch; the Trainer's summaries, log writers and checkpoints are the
master's (rank 0) alone, every rank keeps the same best metric, the others
wait at a barrier before a resume reads, and after the resume every rank
takes rank 0's model and EMA. Under ``--dev.fsdp`` or a model axis larger
than 1 the state is placed as JAX's ``_place_state`` places it
(training_engine.py:121-123, 250-262): every rank takes rank 0's model and
EMA, then keeps its shards (``parallel.fsdp.shard_train_state``); a
checkpoint holds whole tensors and a resume cuts them to each rank's
shards. The metrics' pairs are added over the ranks at each read
(``metrics.stats.gathered_pairs``). Sample-efficient training scores each
rank's shard and takes the union of the ranks' easy samples, so every
rank's sampler drops the same ones.

``--common.tensorboard-logging`` writes each epoch's summaries through
``engine/utils.get_log_writers`` on the master.

Not ported yet, and refused when asked for: the profiler trace (its error
names its ROADMAP.md item). Also refused: an ``iou`` in ``stats.train`` of a segmentation model that
returns head-resolution logits in training (the default, for the fused
resize + CE); they would be compared with full-size masks (in the JAX package
that crashes). ``--model.segmentation.upsample-train-logits`` makes it train.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from cvnets_tpu_torch import parallel
from cvnets_tpu_torch.engine.train_state import (
    UnitNormalizer,
    batch_size,
    create_train_state,
    eval_net,
    make_eval_step,
    make_train_step,
    make_video_eval_step,
    valid_forward,
    votes_over_clips,
)
from cvnets_tpu_torch.engine.utils import get_log_writers, log_metrics
from cvnets_tpu_torch.layers.dtype_utils import autocast
from cvnets_tpu_torch.layers.normalization import AdjustBatchNormMomentum
from cvnets_tpu_torch.metrics import METRICS_REGISTRY, build_metrics
from cvnets_tpu_torch.metrics.stats import Statistics, add_pairs, gathered_pairs
from cvnets_tpu_torch.ops.image_ops import build_device_augmenter
from cvnets_tpu_torch.ops.mixing import build_mixing_fn
from cvnets_tpu_torch.optim import build_optimizer
from cvnets_tpu_torch.parallel.fsdp import shard_train_state, wants_sharding
from cvnets_tpu_torch.optim.scheduler import build_scheduler
from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.checkpoint_utils import (
    CheckpointManager,
    load_checkpoint,
    load_finetune,
)
from cvnets_tpu_torch.utils.common_utils import create_directories

DEFAULT_LOG_FREQ = 100

# (flag dest, what it needs) of the features the Trainer refuses
_UNPORTED = (
    ("common.profile_trace_dir",
     "the profiler trace waits for the port bench (ROADMAP.md queue 1 item 1)"),
)


class Trainer:
    def __init__(self, opts, model: nn.Module, criteria, train_loader, val_loader=None,
                 device: Optional[Union[str, torch.device]] = None,
                 train_sampler=None) -> None:
        for dest, why in _UNPORTED:
            if getattr(opts, dest, None):
                raise NotImplementedError(f"not ported yet: {why}")
        self.train_metric_names = getattr(opts, "stats.train", ["loss"])
        if (getattr(opts, "dataset.category", None) == "segmentation"
                and "iou" in {METRICS_REGISTRY.parse_key(n)[0] for n in self.train_metric_names}
                and not getattr(opts, "model.segmentation.upsample_train_logits", False)):
            raise ValueError(
                "stats.train has iou, but in training the segmentation model returns "
                "head-resolution logits, smaller than the masks; pass "
                "--model.segmentation.upsample-train-logits to upsample them, or drop iou "
                "from stats.train")
        self.opts = opts
        self.model = model
        self.criteria = criteria
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.train_sampler = train_sampler
        self.device = torch.device(device if device is not None else "cuda")
        model.to(self.device)

        self.max_epochs = getattr(opts, "scheduler.max_epochs", 100) or 100
        self.max_iterations = getattr(opts, "scheduler.max_iterations", 10**9) or 10**9
        if getattr(opts, "scheduler.is_iteration_based", False):
            self.max_epochs = 10**7
        self.log_freq = getattr(opts, "common.log_freq", DEFAULT_LOG_FREQ)
        self.save_interval_freq = getattr(opts, "common.save_interval_freq", 0) or 0
        self.ema_enabled = getattr(opts, "ema.enable", False)
        self.ema_copy_at_epoch = getattr(opts, "ema.copy_at_epoch", -1)
        self.val_metric_names = getattr(opts, "stats.val", ["loss"])
        self.ckpt_metric_name = getattr(opts, "stats.checkpoint_metric", "loss")
        self.generator = torch.Generator(self.device).manual_seed(
            getattr(opts, "common.seed", 0) or 0)
        self.is_master_node = parallel.is_master()

        def _set_cfg(key: str, default):
            value = getattr(opts, f"dataset.sample_efficient_training.{key}", None)
            return default if value is None else value

        self.set_enabled = bool(getattr(opts, "dataset.sample_efficient_training.enable",
                                        False))
        self.set_confidence = _set_cfg("sample_confidence", 0.5)
        self.set_every_k = _set_cfg("find_easy_samples_every_k_epochs", 5)
        self.set_min_epochs = _set_cfg("min_sample_frequency", 5)
        self._easy_counts: Dict[int, int] = {}

        self.scheduler = build_scheduler(opts)
        self.adjust_norm_mom = None
        if getattr(opts, "model.normalization.adjust_bn_momentum.enable", False):
            self.adjust_norm_mom = AdjustBatchNormMomentum(opts)
        self.state = create_train_state(
            model, build_optimizer(opts, model, model.get_lr_multipliers(opts)),
            ema_enabled=self.ema_enabled)
        load_finetune(opts, self.state)
        n_params = sum(p.numel() for p in model.parameters())
        logger.info(f"Model: {model.__class__.__name__} | params: {n_params / 1e6:.2f}M | "
                    f"device: {self.device}")

        self.save_dir = os.path.join(getattr(opts, "common.results_loc", "results"),
                                     getattr(opts, "common.run_label", "run_1"))
        create_directories(self.save_dir, self.is_master_node)  # the others wait for it
        self.ckpt_manager = CheckpointManager(opts, self.save_dir, self.is_master_node)
        if self.is_master_node:
            with open(os.path.join(self.save_dir, "config.yaml"), "w") as f:
                json.dump({k: v for k, v in sorted(vars(opts).items())
                           if isinstance(v, (str, int, float, bool, list, type(None)))},
                          f, indent=1)
        if wants_sharding(opts):
            parallel.broadcast_module_(model)
            if self.state.ema is not None:
                parallel.broadcast_module_(self.state.ema.model)
            shard_train_state(opts, self.state)
        self.start_epoch, self.train_iterations, best = load_checkpoint(
            opts, self.state, self.save_dir, self.generator)
        if best is not None:
            self.ckpt_manager.best_metric = best
        if self.state.shards is None:
            parallel.broadcast_module_(model)
            if self.state.ema is not None:
                parallel.broadcast_module_(self.state.ema.model)
        self.log_writers = (get_log_writers(opts, self.save_dir) if self.is_master_node
                            else [])

        train_metrics = build_metrics(opts, self.train_metric_names)
        val_metrics = build_metrics(opts, self.val_metric_names)
        augment = {"augment_fn": build_device_augmenter(opts),
                   "mixing_fn": build_mixing_fn(opts)}
        self._train_step = make_train_step(model, criteria, opts, train_metrics, **augment)
        self.accum_after_epoch = getattr(opts, "common.accum_after_epoch", 0) or 0
        self._train_step_noaccum = None
        if self.accum_after_epoch > 0 and (getattr(opts, "common.accum_freq", 1) or 1) > 1:
            self._train_step_noaccum = make_train_step(model, criteria, opts, train_metrics,
                                                       accum_freq=1, **augment)
        if votes_over_clips(opts):
            self._eval_step = make_video_eval_step(model, val_metrics, opts=opts)
            self._eval_step_ema = make_video_eval_step(model, val_metrics, use_ema=True,
                                                       opts=opts)
        else:
            self._eval_step = make_eval_step(model, criteria, val_metrics, opts=opts)
            self._eval_step_ema = make_eval_step(model, criteria, val_metrics, use_ema=True,
                                                 opts=opts)

    def read_back(self, stats: Statistics, pairs, load_time: float) -> None:
        """The host's only wait on the device inside an epoch: one copy of the
        summed (sum, count) pairs, added over the ranks."""
        stats.update(gathered_pairs(pairs), batch_load_time=load_time)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        stats = Statistics(self.opts, self.train_metric_names)
        step_fn = self._train_step
        if self._train_step_noaccum is not None and epoch < self.accum_after_epoch:
            step_fn = self._train_step_noaccum
        epoch_start = batch_start = time.time()
        samples_seen, pairs, load_time, lr = 0, None, 0.0, 0.0
        sampler = getattr(self.train_loader, "batch_sampler", None)
        total_samples = getattr(sampler, "n_samples_per_replica", None) \
            or getattr(sampler, "n_samples", None) or 0
        for batch in parallel.device_prefetch(self.train_loader, self.device):
            load_time += time.time() - batch_start
            if self.train_iterations >= self.max_iterations:
                break
            lr = self.scheduler.retrieve_lr(epoch, self.train_iterations)
            bn_momentum = None
            if self.adjust_norm_mom is not None:
                bn_momentum = self.adjust_norm_mom.get_momentum(epoch, self.train_iterations)
            self.state, step_pairs = step_fn(self.state, batch, lr, epoch, bn_momentum)
            pairs = add_pairs(pairs, step_pairs)
            samples_seen += batch_size(batch["samples"])
            self.train_iterations += 1
            if self.train_iterations % self.log_freq == 0:
                self.read_back(stats, pairs, load_time)
                pairs, load_time = None, 0.0
                stats.iter_summary(epoch, samples_seen, total_samples, epoch_start, lr)
            if self.save_interval_freq > 0 and self.train_iterations % self.save_interval_freq == 0:
                self.ckpt_manager.save_interval(self.state, self.train_iterations)
            batch_start = time.time()
        if pairs is not None:  # the iterations after the last log point
            self.read_back(stats, pairs, load_time)
        return stats.avg_statistics_all()

    def val_epoch(self, epoch: int, use_ema: bool = False) -> Dict[str, float]:
        if self.val_loader is None:
            return {}
        if hasattr(getattr(self.val_loader, "dataset", None), "class_caption_tokens"):
            from cvnets_tpu_torch.engine.evaluation_engine import zero_shot_eval

            net = eval_net(self.state, self.model, use_ema)
            stats = zero_shot_eval(self.opts, net, self.val_loader, self.device)
            stage = "validation (EMA)" if use_ema else "validation"
            logger.log(f"*** {stage.title()} summary for epoch {epoch}: zero-shot " + " || ".join(
                f"{k}: {v:.4f}" for k, v in stats.items()))
            return stats
        stats = Statistics(self.opts, self.val_metric_names)
        step = self._eval_step_ema if use_ema else self._eval_step
        pairs = None
        for batch in parallel.device_prefetch(self.val_loader, self.device):
            pairs = add_pairs(pairs, step(self.state, batch))
        stats.update(gathered_pairs(pairs))
        stats.epoch_summary(epoch, stage="validation (EMA)" if use_ema else "validation")
        return stats.avg_statistics_all()

    @torch.no_grad()
    def easy_sample_ids(self) -> set:
        """The ids of the samples of this epoch's train batches whose class the
        model predicts with a true-class probability of at least
        ``sample_confidence`` (eval mode, each batch's valid rows, its samples
        normalized as an eval step's where JAX's pass feeds them raw), as a
        union over the ranks."""
        # a sharded state's weights gathered first (a stand-in Trainer may have no state)
        model = eval_net(getattr(self, "state", None), self.model)
        to_unit = UnitNormalizer(self.opts)
        model.eval()
        easy = set()
        for batch in parallel.device_prefetch(self.train_loader, self.device):
            if "sample_id" not in batch:
                continue
            with autocast(self.opts, self.device):
                got = valid_forward(model, batch, lambda x: model(to_unit(x)))
            if got is None:
                continue
            batch, logits = got
            targets = batch["targets"]
            if isinstance(logits, dict):
                logits = logits.get("logits", next(iter(logits.values())))
            probs = torch.softmax(logits.float(), dim=-1)
            p_true = probs.gather(1, targets.clamp(min=0)[:, None])[:, 0]
            hit = (logits.argmax(dim=-1) == targets) & (p_true >= self.set_confidence)
            easy.update(batch["sample_id"][hit].tolist())
        return set().union(*parallel.all_gather_objects(sorted(easy)))

    def find_easy_samples(self, epoch: int) -> None:
        """Drop the samples found easy twice from the sampler's list
        (training_engine.py:375-421), the same on every rank."""
        easy = self.easy_sample_ids()
        for sid in easy:
            self._easy_counts[sid] = self._easy_counts.get(sid, 0) + 1
        skip = {s for s, n in self._easy_counts.items() if n >= 2}
        logger.info(f"Sample-efficient training: {len(easy)} easy samples at epoch {epoch}, "
                    f"{len(skip)} of them easy twice")
        if not skip:
            return
        sampler = self.train_loader.batch_sampler
        current = getattr(sampler, "img_indices", None)
        all_ids = set(current) if current is not None else set(range(sampler.n_data_samples))
        keep = sorted(all_ids - skip)
        if len(keep) < max(16, len(all_ids) // 10):
            return  # never drop (almost) everything
        self.train_loader.update_indices(keep)
        logger.info(f"Sample-efficient training: skipping {len(skip)} easy samples from "
                    f"epoch {epoch + 1} ({len(keep)} remain)")

    def run(self) -> None:
        for epoch in range(self.start_epoch, self.max_epochs):
            if self.train_sampler is not None:
                self.train_sampler.set_epoch(epoch)
                self.train_sampler.update_scales(epoch, is_master_node=self.is_master_node)
            train_stats = self.train_epoch(epoch)
            if (self.set_enabled and epoch >= self.set_min_epochs
                    and (epoch + 1) % self.set_every_k == 0):
                self.find_easy_samples(epoch)
            if train_stats:
                summary = " || ".join(f"{k}: {v:.4f}" for k, v in train_stats.items())
                logger.log(f"*** Training summary for epoch {epoch}: {summary}")
                log_metrics(self.log_writers, train_stats, epoch, prefix="train/")
            val_stats = self.val_epoch(epoch)
            log_metrics(self.log_writers, val_stats, epoch, prefix="val/")
            if self.ema_enabled:
                log_metrics(self.log_writers, self.val_epoch(epoch, use_ema=True), epoch,
                            prefix="val_ema/")
                if epoch == self.ema_copy_at_epoch:
                    if self.state.shards is not None:
                        self.state.shards.load_full_state_dict(
                            self.state.shards.full_state_dict(use_ema=True))
                    else:
                        self.model.load_state_dict(self.state.ema.model.state_dict())
                    logger.info(f"Copied EMA weights into model at epoch {epoch}")
            ckpt_metric = val_stats.get(
                self.ckpt_metric_name, val_stats.get("loss", train_stats.get("loss", 0.0))
            ) if val_stats else train_stats.get("loss", 0.0)
            self.ckpt_manager.save(self.state, epoch, self.train_iterations,
                                   float(ckpt_metric), self.generator)
            if self.train_iterations >= self.max_iterations:
                logger.info("Max iterations reached; stopping.")
                break
        for writer in self.log_writers:
            writer.close()
        logger.info("Training completed.")
