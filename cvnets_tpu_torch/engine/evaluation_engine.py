"""Evaluator (counterpart of cvnets_tpu/engine/evaluation_engine.py:18-70): the
``stats.val`` metrics of a model over a loader, the model given or filled from
a ``checkpoint_*.pt`` (a model state dict). A shift set's
``stats.logit_subset_indices`` (its dataset shares them) keep the logits of its
classes. ``run`` takes CLIP's zero-shot route when the test dataset has
``class_caption_tokens`` (evaluation_engine.py:109-168): the class captions'
embeddings in chunks of 100 classes, computed once and kept on the device,
then 100·image·textᵀ logits (the model's ``zero_shot_image_logits``) and
their top-1 / top-5 over the test loader, the counts summed on the device and
read back once. Under ``--common.inference-modality video`` (and for the
video category) ``run`` takes ``eval_fn_video`` (evaluation_engine.py:72-107):
each video's clips fold into the batch and their logits are summed or maxed
(``train_state.make_video_eval_step``).

In a process group each rank evaluates its shard of the test set (its
sampler's), counts only the samples of each batch (``n_valid``), and the
ranks' sums, counts and rows are gathered before the metrics are computed
(``metrics.stats.gathered_pairs``): every sample counts once. Under a model
axis larger than 1 (or ``--dev.fsdp``) the model is laid out over the grid
first (``parallel.fsdp.shard_eval_model``): tensor-parallel where the rules
split it, its weights whole for use, and the ranks of a model group evaluate
the same rows."""

from __future__ import annotations

import time
from typing import Dict, Optional, Union

import torch
import torch.nn as nn

from cvnets_tpu_torch import parallel
from cvnets_tpu_torch.engine.train_state import (
    TrainState,
    UnitNormalizer,
    batch_size,
    make_eval_step,
    make_video_eval_step,
    tree_map,
    valid_forward,
    votes_over_clips,
)
from cvnets_tpu_torch.layers.dtype_utils import autocast
from cvnets_tpu_torch.metrics.stats import Statistics, add_pairs, gathered_pairs
from cvnets_tpu_torch.parallel import device_prefetch
from cvnets_tpu_torch.parallel.fsdp import shard_eval_model, wants_sharding
from cvnets_tpu_torch.metrics.topk_accuracy import top_k_correct
from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.checkpoint_utils import load_file


ZERO_SHOT_CLASS_CHUNK = 100


@torch.no_grad()
def class_embeddings(opts, model: nn.Module, tokens, device: torch.device) -> torch.Tensor:
    """(C, D) normalized class embeddings of (C, n_captions, L) caption
    tokens, through ``model.encode_text`` in chunks of 100 classes."""
    model.eval()
    tokens = torch.as_tensor(tokens)
    if device.type == "cuda":
        tokens = tokens.pin_memory()
    chunks = []
    for c0 in range(0, tokens.shape[0], ZERO_SHOT_CLASS_CHUNK):
        chunk = tokens[c0:c0 + ZERO_SHOT_CLASS_CHUNK].to(device, non_blocking=True)
        with autocast(opts, device):
            chunks.append(model.encode_text(chunk))
    return torch.cat(chunks)


@torch.no_grad()
def zero_shot_eval(opts, model: nn.Module, loader, device: torch.device,
                   text_emb: Optional[torch.Tensor] = None) -> Dict[str, float]:
    """Zero-shot top-1 and top-5 (in %) of ``model`` over ``loader``, whose
    dataset gives ``class_caption_tokens()``; ``text_emb`` the class
    embeddings when they are already made."""
    if text_emb is None:
        text_emb = class_embeddings(opts, model, loader.dataset.class_caption_tokens(), device)
    model.eval()
    to_unit = UnitNormalizer(opts)
    correct, n = None, 0
    for batch in device_prefetch(loader, device):
        batch = dict(batch, samples=tree_map(to_unit, batch["samples"]))
        with autocast(opts, device):
            got = valid_forward(model, batch, lambda images: model(
                {"image": images, "text": text_emb})["zero_shot_image_logits"])
        if got is None:
            continue
        batch, logits = got
        images = batch["samples"]
        step = torch.stack([top_k_correct(logits, batch["targets"], k) for k in (1, 5)])
        correct = step if correct is None else correct + step
        n += batch_size(images)
    local = (correct.tolist() if correct is not None else [0.0, 0.0]) + [n]
    top1, top5, n = (sum(col) for col in zip(*parallel.all_gather_objects(local)))
    return {"top1": 100.0 * top1 / max(n, 1), "top5": 100.0 * top5 / max(n, 1)}


class Evaluator:
    def __init__(self, opts, model: nn.Module, test_loader, criteria=None,
                 checkpoint: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        self.opts = opts
        self.test_loader = test_loader
        self.device = torch.device(device if device is not None else "cuda")
        if checkpoint is not None:
            model.load_state_dict(load_file(checkpoint))
        model.to(self.device)
        if wants_sharding(opts):
            model = shard_eval_model(opts, model)
        self.state = TrainState(model=model, optimizer=None)
        if criteria is None:
            from cvnets_tpu_torch.loss import build_loss_fn

            criteria = build_loss_fn(opts, device=self.device)
        self.stats = Statistics(opts, getattr(opts, "stats.val", ["loss"]))
        self._class_emb: Optional[torch.Tensor] = None
        subset = getattr(opts, "stats.logit_subset_indices", None)
        self._eval_step = make_eval_step(
            model, criteria, self.stats.metrics, opts=opts,
            logit_subset=torch.tensor(subset, device=self.device) if subset else None)

    def _eval(self, step, stage: str) -> Dict[str, float]:
        start = time.time()
        pairs = None
        for batch in device_prefetch(self.test_loader, self.device):
            pairs = add_pairs(pairs, step(self.state, batch))
        self.stats.update(gathered_pairs(pairs))
        self.stats.epoch_summary(0, stage=stage)
        logger.info(f"Evaluation took {time.time() - start:.2f} seconds")
        return self.stats.avg_statistics_all()

    def eval_fn_image(self) -> Dict[str, float]:
        return self._eval(self._eval_step, "evaluation")

    def eval_fn_video(self) -> Dict[str, float]:
        return self._eval(make_video_eval_step(self.state.model, self.stats.metrics,
                                               opts=self.opts), "evaluation (video)")

    def eval_fn_zero_shot(self) -> Dict[str, float]:
        start = time.time()
        model = self.state.model
        if self._class_emb is None:
            self._class_emb = class_embeddings(
                self.opts, model, self.test_loader.dataset.class_caption_tokens(), self.device)
        out = zero_shot_eval(self.opts, model, self.test_loader, self.device, self._class_emb)
        logger.info(f"Zero-shot evaluation: {out} ({time.time() - start:.2f} seconds)")
        return out

    def run(self) -> Dict[str, float]:
        if votes_over_clips(self.opts):
            return self.eval_fn_video()
        if hasattr(getattr(self.test_loader, "dataset", None), "class_caption_tokens"):
            return self.eval_fn_zero_shot()
        return self.eval_fn_image()
