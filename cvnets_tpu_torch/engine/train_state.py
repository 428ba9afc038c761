"""Train state, train step and eval step (counterpart of
cvnets_tpu/engine/train_state.py:82-310).

The JAX step is one pure compiled program; this one runs eagerly and updates the
model, optimizer and EMA in place (no second copy of the state is made). Each step:
uint8 → [0, 1] on the device, with ``ToFloatTensor``'s mean/std when the
options ask for it (uint8 masks → int64 labels), autocast forward,
backward of the loss (of its ``total_loss`` when the loss is a dict), global-norm clip
``min(1, clip / (norm + 1e-6))``, the optimizer at the scheduler's LR times each
param group's ``lr_mult``, EMA of params and BN statistics (the clip, the
update and the EMA inside a ``torch.profiler`` range named
``OPTIMIZER_RANGE``), ``step += 1``. It
returns each metric's (sum, count) pairs with the sums on the device; nothing is
read back to the host.

Gradient accumulation (``accum_freq`` > 1) splits the batch into that many
contiguous micro-batches and steps once on the mean of their grads. In the JAX
step every micro-batch is applied to the pre-step BN statistics and only the
last one's update is kept (:195-226, :246), so the running statistics end one
momentum update from the last micro-batch. Here every micro-batch but the last
runs with BN momentum 0, which leaves the running statistics as they are. The
loss and every metric of the step are the last micro-batch's.

``bn_momentum`` (torch convention, from ``AdjustBatchNormMomentum``) is written
into every BatchNorm module for the step's last forward; the JAX step re-blends
the statistics its static momentum produced into the same value (:205-216).

Samples may be a dict of tensors (CLIP's ``{"image", "text"}``): each uint8
leaf is normalized as a tensor batch is, and accumulation slices every leaf
of samples and targets, as the JAX step's ``tree_map`` does (:164-169,
:215-221); ``batch_size`` counts a batch by its first leaf, as the JAX
Trainer does. The device-tier augmentation (``ops/image_ops.py``) and mixup
/ cutmix (``ops/mixing.py``) take tensor samples only (classification), as in
the JAX package, and run in the JAX step's order (:165-175): to [0, 1],
augment, mix, forward. Their host draws come from ``step_rng(seed, step, stream)``, as
the JAX step folds the step into its key: a step's augmentation depends on
(``common.seed``, step) alone, so a resumed run needs no generator state to
draw what an unbroken run draws.

A model with RangeAugment's neural augmentor gets its draws from a generator
on the batch's device seeded by (``common.seed``, step, ``NEURAL_AUG_STREAM``)
each step, drawn on the device (one draw a micro-batch, in order), and
returns ``{"augmented_tensor", "logits"}``; the loss receives the samples
before the augmentor (after ``to_unit``, augmentation and mixing), as in the
JAX step (:154, :162). The loss also gets ``epoch`` and ``iterations`` (the
step), which RangeAugment's curriculum reads.

A model with MoE layers (``modules/moe.py``) adds
``--model.moe.aux-loss-weight`` times the sum of their load-balance losses
to each training forward's loss (``total_loss`` of a dict loss), as the
JAX step adds its ``moe_loss`` collection (:151-158, :190, :211): once a
micro-batch, each micro-batch's capacity its own. Eval steps add nothing.

A video batch, (B, clips, T, C, H, W) (``kinetics``), trains each clip as
a sample: the clips fold into the batch and each target repeats for them.
(The JAX step hands the model the clips as its frames, which a MobileViT
encoder cannot take.) ``make_video_eval_step`` is JAX's ``eval_fn_video``
(evaluation_engine.py:72-107): the clips fold into the batch, and the logits
of a video's clips are summed or maxed by
``--model.video-classification.clip-out-voting-fn``; its loss metric is 0,
as JAX passes ``{"loss": 0.0}``.

A model that sets ``TAKES_GENERATOR`` (Mask R-CNN, whose samplers draw in its
forward) gets ``generator=``, a generator on the batch's device seeded by
(``common.seed``, step, ``DETECTION_STREAM``) each step.

In a process group (``parallel``) each data rank steps on its shard of the
global batch (the ranks of a model group on the same rows). The gradients
are averaged over the data group once a step, after the last micro-batch's
backward (the micro-batches before it accumulate locally, as DDP's
``no_sync``), so the clip, the optimizer and the EMA see the same gradients,
and the parameters stay the same bits, on every data rank. The BatchNorms
normalize with the global batch's statistics (``layers/normalization.py``)
and the losses that divide by a count over the batch divide by the global
one, so the step is the JAX package's on the global batch. Every host and
device draw of a step (augmentation, mixing, the augmentor, detection's
samplers) is seeded by (``common.seed``, step, stream, data index) at a data
index other than 0: data ranks draw differently, where JAX draws once over
the global batch, and the ranks of a model group draw alike.

A sharded state (``state.shards``, ``parallel.fsdp``: ``--dev.fsdp`` or a
model axis larger than 1) gathers the weights before the step's first
forward, turns the gradients into its shards' after the last backward
(reduce-scattered over the data group), clips by the global norm over every
shard, steps the optimizer and the EMA on the shards and frees the gathered
weights; an eval step gathers them (or the EMA's) first.

An eval step takes only a batch's ``n_valid`` leading rows where the batch
carries it (the rest pad the trailing batch, ``data/sampler``): each sample
counts once. A model with MoE layers runs the whole padded batch on every
rank and its prediction is cut after (``valid_forward``): JAX routes the
padded global batch, and the router's all-gather over the data group needs
every rank's rows, also on a rank whose batch is all padding.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
from torch.profiler import record_function

from cvnets_tpu_torch import parallel
from cvnets_tpu_torch.layers.dtype_utils import autocast
from cvnets_tpu_torch.metrics.stats import Pairs
from cvnets_tpu_torch.misc.averaging_utils import EMA
from cvnets_tpu_torch.modules.moe import MoEFFN, moe_aux_loss


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optional[torch.optim.Optimizer]  # None when only evaluating
    ema: Optional[EMA] = None  # None when EMA is disabled
    step: int = 0
    shards: Optional[Any] = None  # a parallel.fsdp.ShardedState when the state is sharded


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       ema_enabled: bool = False) -> TrainState:
    """``model`` must already be on its device; the EMA copy lands beside it."""
    return TrainState(model=model, optimizer=optimizer,
                      ema=EMA(model) if ema_enabled else None)


def clip_grad_norm_(params: List[torch.Tensor], grad_clip: Optional[float]
                    ) -> torch.Tensor:
    """Scale the grads of ``params`` in place by ``min(1, clip / (norm + 1e-6))``
    (train_state.py:232-235) and return their pre-clip global norm."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    if grad_clip is not None and grad_clip > 0:
        torch._foreach_mul_(grads, torch.clamp(grad_clip / (norm + 1e-6), max=1.0))
    return norm


def _labels(targets):
    """Segmentation masks cross to the device as uint8 and are widened there to
    the int64 labels the loss and the metrics index with; a dict of targets
    (detection's per-anchor labels and offsets) is taken as it is."""
    if isinstance(targets, torch.Tensor) and targets.dtype == torch.uint8:
        return targets.long()
    return targets


class UnitNormalizer:
    """uint8 pixels to [0, 1] floats on their device (the JAX step's division
    of the native loader's batches) and, under
    ``--image-augmentation.to-tensor.mean-std-normalization.enable``, per
    channel ``(x - mean) / std``: the JAX ``ToFloatTensor``'s normalization
    (cvnets_tpu/data/transforms/image.py:517-574), which runs on the host
    there. The port's ``ToFloatTensor`` keeps uint8 pixels, so batches of
    either decoder are normalized here, on the device: in the train and eval
    steps and in the offline segmentation eval, the port's one place that
    turns uint8 pixels into the model's input. A float batch is taken as it
    is."""

    def __init__(self, opts=None) -> None:
        prefix = "image_augmentation.to_tensor.mean_std_normalization."
        self.mean_std = None
        if opts is not None and getattr(opts, prefix + "enable", False):
            mean = getattr(opts, prefix + "mean", None) or [0.485, 0.456, 0.406]
            std = getattr(opts, prefix + "std", None) or [0.229, 0.224, 0.225]
            self.mean_std = tuple(torch.tensor(v, dtype=torch.float32).view(-1, 1, 1)
                                  for v in (mean, std))
        self._on_device: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def __call__(self, samples: torch.Tensor) -> torch.Tensor:
        if samples.dtype != torch.uint8:
            return samples
        x = samples.float() / 255.0
        if self.mean_std is None:
            return x
        if x.device not in self._on_device:  # sent up once, from pinned memory on a card
            self._on_device[x.device] = tuple(
                (t.pin_memory() if x.is_cuda else t).to(x.device, non_blocking=True)
                for t in self.mean_std)
        mean, std = self._on_device[x.device]
        return (x - mean) / std


def tree_map(fn: Callable, tree):
    """``fn`` on every tensor of a dict tree (or on a tensor); other leaves as they are."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def first_leaf(samples) -> torch.Tensor:
    """A batch's samples, or their first tensor leaf when they are a dict."""
    while isinstance(samples, dict):
        samples = next(iter(samples.values()))
    return samples


def batch_size(samples) -> int:
    """Rows of a batch's samples: its first tensor leaf's first dimension."""
    return first_leaf(samples).shape[0]


MIXING_STREAM, AUGMENT_STREAM, NEURAL_AUG_STREAM, DETECTION_STREAM = 0, 1, 2, 3
OPTIMIZER_RANGE = "train_step_optimizer"


def step_rng(seed: int, step: int, stream: int) -> np.random.Generator:
    """The host generator of one step's draws of one stream (and of this
    rank's data index, where it is not 0: the ranks of a model group hold
    the same rows and draw alike)."""
    index = parallel.data_index()
    return np.random.default_rng([seed, step, stream] + ([index] if index else []))


def step_generator(generators: Dict[torch.device, torch.Generator], device: torch.device,
                   seed: int, step: int, stream: int) -> torch.Generator:
    """The torch generator on ``device`` of one step's draws of one stream,
    kept in ``generators`` and seeded anew each step (setting a seed reads
    nothing back from the card)."""
    if device not in generators:
        generators[device] = torch.Generator(device=device)
    return generators[device].manual_seed(
        int(step_rng(seed, step, stream).integers(2 ** 62)))


VIDEO_BATCH_DIMS = 6  # (B, clips, T, C, H, W)


def fold_clips(samples: torch.Tensor, targets: torch.Tensor):
    """A video batch's clips as samples, each with its video's target."""
    return samples.flatten(0, 1), targets.repeat_interleave(samples.shape[1])


def valid_rows(batch: Dict) -> Optional[Dict]:
    """``batch`` without the padding rows past its ``n_valid`` (each tensor of
    its samples and targets cut to them), or None where it has none."""
    n = batch.get("n_valid")
    if n is None:
        return batch
    if n == 0:
        return None
    rows = lambda t: t[:n] if t.dim() else t  # noqa: E731
    return {k: tree_map(rows, v) for k, v in batch.items() if k != "n_valid"}


def routes_whole_batches(model: nn.Module) -> bool:
    """Whether the model's forward mixes a batch's rows: MoE's routing, whose
    capacity and buffer places count every row of the global batch."""
    return any(isinstance(m, MoEFFN) for m in model.modules())


def valid_forward(net: nn.Module, batch: Dict, forward: Optional[Callable] = None
                  ) -> Optional[Tuple[Dict, Any]]:
    """``batch`` cut to its valid rows and ``forward``'s (``net``'s) prediction
    of their samples, or None where it has none. A net that routes whole
    batches runs the padded batch, on every rank, and its prediction is cut
    after: JAX routes the padded global batch, and MoE's all-gather over the
    data group needs every rank's rows."""
    forward = forward or net
    n = batch.get("n_valid")
    if n is None or not routes_whole_batches(net):
        batch = valid_rows(batch)
        return None if batch is None else (batch, forward(batch["samples"]))
    b = batch_size(batch["samples"])
    prediction = forward(batch["samples"])
    batch = valid_rows(batch)
    if batch is None:
        return None
    return batch, tree_map(lambda t: t[:n] if t.dim() and t.shape[0] == b else t, prediction)


def _batch_values(metric_objs: Dict[str, Any], prediction, targets, extras) -> Pairs:
    return {name: metric.batch_values(prediction, targets, extras)
            for name, metric in metric_objs.items()}


def make_train_step(model: nn.Module, criteria: Callable, opts, metric_objs: Dict[str, Any],
                    accum_freq: Optional[int] = None, augment_fn: Optional[Callable] = None,
                    mixing_fn: Optional[Callable] = None
                    ) -> Callable[..., Tuple[TrainState, Pairs]]:
    """``accum_freq`` overrides ``--common.accum-freq`` (the Trainer builds a
    step without accumulation for the epochs before ``--common.accum-after-epoch``).
    ``augment_fn(images, rng)`` and ``mixing_fn(images, targets, n_classes, rng)``
    are ``build_device_augmenter`` and ``build_mixing_fn`` of the options."""
    grad_clip = getattr(opts, "common.grad_clip", None)
    ema_momentum = getattr(opts, "ema.momentum", 0.0001)
    if accum_freq is None:
        accum_freq = getattr(opts, "common.accum_freq", 1)
    accum_freq = max(1, accum_freq or 1)
    params = list(model.parameters())
    batch_norms = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    base_momentum = [m.momentum for m in batch_norms]
    seed = getattr(opts, "common.seed", 0) or 0
    n_classes = getattr(opts, "model.classification.n_classes", None)
    to_unit = UnitNormalizer(opts)
    augmentor = model._modules.get("neural_augmentor")
    takes_generator = getattr(model, "TAKES_GENERATOR", False)
    generators: Dict[torch.device, torch.Generator] = {}
    has_moe = any(isinstance(m, MoEFFN) for m in model.modules())
    moe_weight = getattr(opts, "model.moe.aux_loss_weight", 0.01) or 0.0

    def train_step(state: TrainState, batch: Dict, lr: float, epoch: int = 0,
                   bn_momentum: Optional[float] = None) -> Tuple[TrainState, Pairs]:
        samples, targets = tree_map(to_unit, batch["samples"]), _labels(batch["targets"])
        if isinstance(samples, torch.Tensor) and samples.dim() == VIDEO_BATCH_DIMS:
            samples, targets = fold_clips(samples, targets)
        if isinstance(samples, dict) and (augment_fn is not None or mixing_fn is not None):
            raise ValueError("device augmentation and mixup / cutmix take a tensor of "
                             "images (classification), not a dict of samples")
        if augment_fn is not None:
            samples = augment_fn(samples, step_rng(seed, state.step, AUGMENT_STREAM))
        if mixing_fn is not None:
            samples, targets = mixing_fn(samples, targets, n_classes,
                                         step_rng(seed, state.step, MIXING_STREAM))
        model.train()
        if state.shards is not None:
            state.shards.gather()
        state.optimizer.zero_grad(set_to_none=True)
        rows = batch_size(samples) // accum_freq
        device = first_leaf(samples).device
        if augmentor is not None:
            gen = step_generator(generators, device, seed, state.step, NEURAL_AUG_STREAM)
        elif takes_generator:
            gen = step_generator(generators, device, seed, state.step, DETECTION_STREAM)
        for i in range(accum_freq):
            last = i == accum_freq - 1
            for m, m0 in zip(batch_norms, base_momentum):
                m.momentum = (m0 if bn_momentum is None else bn_momentum) if last else 0.0
            if accum_freq > 1:
                rows_i = lambda t: t[i * rows:(i + 1) * rows]  # noqa: E731
                mb_samples, mb_targets = tree_map(rows_i, samples), tree_map(rows_i, targets)
            else:
                mb_samples, mb_targets = samples, targets
            with autocast(opts, device):
                if takes_generator:
                    prediction = model(mb_samples, generator=gen)
                elif augmentor is None:
                    prediction = model(mb_samples)
                else:
                    prediction = model(mb_samples,
                                       augmentation_draws=augmentor.draw(mb_samples, gen))
                loss = criteria(mb_samples, prediction, mb_targets, training=True,
                                epoch=epoch, iterations=state.step)
            total = loss["total_loss"] if isinstance(loss, dict) else loss
            if has_moe and moe_weight:
                total = total.float() + moe_weight * moe_aux_loss(model)
                loss = {**loss, "total_loss": total} if isinstance(loss, dict) else total
            total.backward()
        if accum_freq > 1:
            torch._foreach_div_([p.grad for p in params if p.grad is not None],
                                float(accum_freq))
        if state.shards is not None:
            state.shards.reduce_grads()
        else:
            parallel.sync_gradients(params)
        with record_function(OPTIMIZER_RANGE):
            if state.shards is not None:
                grad_norm = state.shards.clip_(grad_clip)
            else:
                grad_norm = clip_grad_norm_(params, grad_clip)
            for group in state.optimizer.param_groups:
                group["lr"] = lr * group.get("lr_mult", 1.0)
            state.optimizer.step()
            if state.shards is not None:
                state.shards.after_step()
            if state.ema is not None:
                state.ema.update(model, ema_momentum)
        state.step += 1
        return state, _batch_values(metric_objs, prediction, mb_targets,
                                    {"loss": loss, "grad_norm": grad_norm})

    return train_step


def eval_net(state: Optional[TrainState], model: nn.Module, use_ema: bool = False
             ) -> nn.Module:
    """The module an evaluation runs: the EMA's copy when asked for and kept,
    else ``model`` (also without a state); a sharded state's with its weights
    gathered (every rank calls this, before it drops a batch's padding)."""
    if state is None:
        return model
    use_ema = use_ema and state.ema is not None
    if getattr(state, "shards", None) is not None:
        return state.shards.gather(use_ema)
    return state.ema.model if use_ema else model


def make_eval_step(model: nn.Module, criteria: Callable, metric_objs: Dict[str, Any],
                   use_ema: bool = False, opts=None,
                   logit_subset: Optional[torch.Tensor] = None
                   ) -> Callable[[TrainState, Dict], Pairs]:
    """Eval-mode forward of the model, or of its EMA copy when ``use_ema`` and
    the state has one, under ``opts``' autocast (float32 without opts), and
    the metrics' (sum, count) pairs on the device. ``logit_subset``: indices
    (on the model's device) of the logits a shift set's classes keep
    (train_state.py:280-302)."""
    to_unit = UnitNormalizer(opts)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict) -> Pairs:
        net = eval_net(state, model, use_ema)
        net.eval()
        batch = dict(batch, samples=tree_map(to_unit, batch["samples"]))
        with autocast(opts, first_leaf(batch["samples"]).device):
            got = valid_forward(net, batch)
            if got is None:
                return {}
            batch, prediction = got
            samples, targets = batch["samples"], _labels(batch["targets"])
            if logit_subset is not None:
                if isinstance(prediction, dict):
                    prediction = dict(prediction, logits=prediction["logits"][:, logit_subset])
                else:
                    prediction = prediction[:, logit_subset]
            loss = criteria(samples, prediction, targets, training=False)
        return _batch_values(metric_objs, prediction, targets, {"loss": loss})

    return eval_step


def votes_over_clips(opts) -> bool:
    """Whether evaluation votes over each video's clips: under
    ``--common.inference-modality video``, as in JAX, and for the video
    category, whose (B, clips, ...) batches no other evaluation takes."""
    return (getattr(opts, "common.inference_modality", "image") == "video"
            or getattr(opts, "dataset.category", None) == "video_classification")


def make_video_eval_step(model: nn.Module, metric_objs: Dict[str, Any], use_ema: bool = False,
                         opts=None) -> Callable[[TrainState, Dict], Pairs]:
    """The metrics of clip-voted logits over (B, clips, T, C, H, W) batches."""
    to_unit = UnitNormalizer(opts)
    voting = getattr(opts, "model.video_classification.clip_out_voting_fn", "sum") or "sum"

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict) -> Pairs:
        net = eval_net(state, model, use_ema)
        net.eval()
        batch = dict(batch, samples=to_unit(batch["samples"]))
        with autocast(opts, batch["samples"].device):
            got = valid_forward(net, batch, lambda x: net(x.flatten(0, 1)).reshape(
                *x.shape[:2], -1))
        if got is None:
            return {}
        batch, logits = got
        samples, targets = batch["samples"], _labels(batch["targets"])
        logits = logits.amax(dim=1) if voting == "max" else logits.sum(dim=1)
        return _batch_values(metric_objs, logits, targets,
                             {"loss": torch.zeros((), device=samples.device)})

    return eval_step
