"""Checkpoints on ``torch.save`` with the file roles of the JAX package
(cvnets_tpu/utils/checkpoint_utils.py:74-214), as ``.pt`` files in the run's
directory:

* ``training_checkpoint_last.pt``: what a resume needs: epoch, iterations, best
  metric, the model's, the optimizer's and the EMA model's state dicts, the
  Trainer's generator and the default generator of its device;
* ``checkpoint_last.pt`` and ``checkpoint_best.pt``, and with EMA
  ``checkpoint_ema_last.pt`` and ``checkpoint_ema_best.pt``: a model state dict
  each (the best by the model's checkpoint metric, EMA's too);
* ``checkpoint_score_{metric:.4f}_ep{epoch}.pt`` for the k best epochs, and
  ``checkpoint_avg.pt``: the float64 mean of their parameters, cast back, with
  the buffers (BN statistics) of the current model, as the JAX package takes
  the current ``batch_stats``;
* ``checkpoint_epoch_{e}.pt`` under ``--common.save-all-checkpoints`` and
  ``checkpoint_iter_{n}.pt`` every ``--common.save-interval-freq`` iterations.

Files hold tensors, ints, floats, None and dicts only, so ``torch.load``'s
``weights_only`` reads them. Each is written under a temporary name and
renamed, so a run stopped during a save keeps the previous file whole. The
k-best list lives in the manager: a resumed run starts it empty, as the JAX
package does. In a process group only the master writes; a resume on every
rank reads the master's file (data index 0 takes its device generator, the
others reseed theirs from (seed, iterations, data index)). A sharded state
(``parallel.fsdp``) writes whole tensors, gathered on every rank before the
master writes (the files load into one process), and a resume cuts each
tensor to the rank's shard.

``--common.finetune`` (and ``--common.finetune-ema``) start a run from the
model weights of such a file with the JAX package's scope surgery
(``finetune_weights``, cvnets_tpu/utils/checkpoint_utils.py:226-307), or from
a reference CVNets checkpoint through ``utils/torch_checkpoint_converter.py``.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from cvnets_tpu_torch import parallel
from cvnets_tpu_torch.utils import logger

CHECKPOINT_EXTN = "pt"


def save_file(obj, path: str) -> None:
    tmp = f"{path}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load_file(path: str) -> dict:
    """A checkpoint's tensors on the CPU: ``load_state_dict`` puts each beside
    its parameter, and AdamW's step counts stay on the CPU, where a
    non-capturable AdamW keeps them (on the card it would read each back every
    step)."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_model_weights(path: str) -> Dict[str, torch.Tensor]:
    """The model state dict of ``path``: a ``checkpoint_*.pt`` file, or the
    model part of a ``training_checkpoint_*.pt`` one."""
    blob = load_file(path)
    return blob["model"] if isinstance(blob.get("model"), dict) else blob


def average_params(state_dicts: List[Dict[str, torch.Tensor]], param_names,
                   current: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``current`` with each parameter replaced by the float64 mean of its values
    in ``state_dicts``, cast back to its dtype."""
    out = dict(current)
    for name in param_names:
        mean = sum(sd[name].to("cpu", torch.float64) for sd in state_dicts) / len(state_dicts)
        out[name] = mean.to(current[name].dtype)
    return out


def _rng_state(device: torch.device) -> torch.Tensor:
    if device.type == "cuda":
        return torch.cuda.get_rng_state(device)
    return torch.get_rng_state()


def _set_rng_state(device: torch.device, state: torch.Tensor) -> None:
    if device.type == "cuda":
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


class CheckpointManager:
    """Writes the checkpoints on the master alone (``is_master``); every rank
    keeps the best metric, so that all of them agree on it."""

    def __init__(self, opts, save_dir: str, is_master: bool = True) -> None:
        self.save_dir = save_dir
        self.is_master = is_master
        self.k_best = getattr(opts, "common.k_best_checkpoints", 5) or 0
        self.save_all = getattr(opts, "common.save_all_checkpoints", False)
        self.max_metric = getattr(opts, "stats.checkpoint_metric_max", False)
        self.best_metric: float = -float("inf") if self.max_metric else float("inf")
        self.k_best_scores: List[Tuple[float, str]] = []
        if is_master:
            os.makedirs(save_dir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.save_dir, f"{name}.{CHECKPOINT_EXTN}")

    def is_best(self, metric: float) -> bool:
        return metric >= self.best_metric if self.max_metric else metric <= self.best_metric

    def save(self, state, epoch: int, iterations: int, ckpt_metric: float,
             generator: Optional[torch.Generator] = None) -> None:
        """The epoch-end checkpoints (checkpoint_utils.py:86-134)."""
        # settle the best before the resume state is written, so that a run
        # resumed after its best epoch keeps it (checkpoint_utils.py:98-103)
        new_best = self.is_best(ckpt_metric)
        if new_best:
            self.best_metric = ckpt_metric
        if getattr(state, "shards", None) is None and not self.is_master:
            return
        model_sd, ema_sd, optim_sd = _whole_state(state)
        if not self.is_master:
            return
        device = next(state.model.parameters()).device
        save_file({
            "epoch": epoch,
            "iterations": iterations,
            "best_metric": self.best_metric if abs(self.best_metric) != float("inf")
            else ckpt_metric,
            "model": model_sd,
            "optimizer": optim_sd,
            "ema": ema_sd,
            "generator": generator.get_state() if generator is not None else None,
            "rng": _rng_state(device),
        }, self.path("training_checkpoint_last"))
        save_file(model_sd, self.path("checkpoint_last"))
        if ema_sd is not None:
            save_file(ema_sd, self.path("checkpoint_ema_last"))
        if new_best:
            save_file(model_sd, self.path("checkpoint_best"))
            if ema_sd is not None:
                save_file(ema_sd, self.path("checkpoint_ema_best"))
        if self.save_all:
            save_file(model_sd, self.path(f"checkpoint_epoch_{epoch}"))
        if self.k_best > 0:
            self._update_k_best(state.model, model_sd, ckpt_metric, epoch)

    def _update_k_best(self, model, model_sd, metric: float, epoch: int) -> None:
        """Keep the k best score-named checkpoints and their average
        (checkpoint_utils.py:136-158); the epoch in the name keeps two equal
        scores apart."""
        path = self.path(f"checkpoint_score_{metric:.4f}_ep{epoch}")
        save_file(model_sd, path)
        self.k_best_scores.append((metric, path))
        self.k_best_scores.sort(key=lambda t: t[0], reverse=self.max_metric)
        while len(self.k_best_scores) > self.k_best:
            _, drop = self.k_best_scores.pop()
            if os.path.exists(drop):
                os.remove(drop)
        if len(self.k_best_scores) >= 2:
            kept = [load_file(p) for _, p in self.k_best_scores]
            names = [name for name, _ in model.named_parameters()]
            save_file(average_params(kept, names, model_sd), self.path("checkpoint_avg"))

    def save_interval(self, state, iterations: int) -> None:
        """The every-N-iterations checkpoint (checkpoint_utils.py:160-166)."""
        if getattr(state, "shards", None) is not None:
            model_sd = state.shards.full_state_dict()
        elif self.is_master:
            model_sd = state.model.state_dict()
        if self.is_master:
            save_file(model_sd, self.path(f"checkpoint_iter_{iterations}"))


def _whole_state(state) -> Tuple[dict, Optional[dict], dict]:
    """The model's, the EMA's and the optimizer's state dicts with whole
    tensors (a sharded state's gathered: every rank calls this then)."""
    shards = getattr(state, "shards", None)
    if shards is None:
        return (state.model.state_dict(),
                state.ema.model.state_dict() if state.ema is not None else None,
                state.optimizer.state_dict())
    return (shards.full_state_dict(),
            shards.full_state_dict(use_ema=True) if state.ema is not None else None,
            shards.full_optimizer_state_dict(state.optimizer))


def load_checkpoint(opts, state, save_dir: str,
                    generator: Optional[torch.Generator] = None
                    ) -> Tuple[int, int, Optional[float]]:
    """Restore ``state`` (and ``generator``) in place from ``--common.resume`` or,
    with ``--common.auto-resume``, from the run's ``training_checkpoint_last.pt``
    (checkpoint_utils.py:169-214). Returns (start epoch, iterations, best
    metric); (0, 0, None) when there is nothing to resume from."""
    path = getattr(opts, "common.resume", None)
    if not path and getattr(opts, "common.auto_resume", False):
        candidate = os.path.join(save_dir, f"training_checkpoint_last.{CHECKPOINT_EXTN}")
        path = candidate if os.path.isfile(candidate) else None
    if not path:
        return 0, 0, None
    blob = load_file(path)
    if getattr(state, "shards", None) is not None:
        state.shards.load_full_state_dict(blob["model"])
        state.shards.load_full_optimizer_state_dict(state.optimizer, blob["optimizer"])
        if state.ema is not None and blob["ema"] is not None:
            state.shards.load_full_state_dict(blob["ema"], use_ema=True)
    else:
        state.model.load_state_dict(blob["model"])
        state.optimizer.load_state_dict(blob["optimizer"])
        if state.ema is not None and blob["ema"] is not None:
            state.ema.model.load_state_dict(blob["ema"])
    state.step = blob["iterations"]
    if generator is not None and blob["generator"] is not None:
        generator.set_state(blob["generator"])
    device = next(state.model.parameters()).device
    index = parallel.data_index()
    if index == 0:
        _set_rng_state(device, blob["rng"])
    else:  # the file holds data index 0's generator: the others draw from (seed, step, index)
        torch.manual_seed(int(np.random.SeedSequence(
            [getattr(opts, "common.seed", 0) or 0, blob["iterations"], index]
        ).generate_state(1)[0]))
    epoch = blob["epoch"] + 1
    logger.info(f"Resumed from {path}: epoch {epoch}, iteration {blob['iterations']}")
    return epoch, blob["iterations"], blob["best_metric"]


def _renames(opts) -> List[Tuple[str, str]]:
    """``--model.rename-scopes-map``: "from:to" strings, or pairs from a yaml."""
    renames = []
    for item in getattr(opts, "model.rename_scopes_map", None) or []:
        if isinstance(item, (list, tuple)) and len(item) == 2:
            renames.append((item[0], item[1]))
        elif isinstance(item, str) and ":" in item:
            renames.append(tuple(item.split(":", 1)))
    return renames


def _patterns(opts, dest: str) -> List["re.Pattern"]:
    return [re.compile(p.strip()) for p in (getattr(opts, dest, "") or "").split(",")
            if p.strip()]


def is_reference_checkpoint(blob: dict, tensors: Dict[str, torch.Tensor],
                            current: Dict[str, torch.Tensor]) -> bool:
    """A file the port did not write: a state dict under ``model_state_dict``
    or ``state_dict``, or ``tensors`` (the file's, renamed) most of which name
    none of the model's (``current``)."""
    if any(isinstance(blob.get(k), dict) for k in ("model_state_dict", "state_dict")):
        return True
    return not tensors or 2 * sum(k not in current for k in tensors) > len(tensors)


def _converted(opts, path: str, current: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A reference checkpoint walked onto ``current`` under
    ``--model.rename-scopes-map`` and ``--model.resume-exclude-scopes``."""
    from cvnets_tpu_torch.utils.torch_checkpoint_converter import load_reference_checkpoint

    return load_reference_checkpoint(
        path, current, rename_map=_renames(opts),
        exclude_scopes=getattr(opts, "model.resume_exclude_scopes", "") or "")


def pretrained_weights(opts, path: str, current: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """The model weights of ``path`` for an evaluation or an export: a port
    file's model state dict as it is (``load_model_weights``), a reference
    checkpoint converted onto ``current``."""
    blob = load_file(path)
    weights = blob["model"] if isinstance(blob.get("model"), dict) else blob
    if is_reference_checkpoint(blob, weights, current):
        return _converted(opts, path, current)
    return weights


def finetune_weights(opts, path: str, current: Dict[str, torch.Tensor],
                     flag: str = "--common.finetune") -> Dict[str, torch.Tensor]:
    """``current`` (a model's state dict) with the tensors of ``path`` laid over
    it, ``flag`` naming the option that gave the file.

    A ``checkpoint_*.pt`` of the port, or the model part of a
    ``training_checkpoint_*.pt``, goes under the JAX package's scope surgery:
    ``--model.rename-scopes-map`` rewrites the file's keys (each from:to regex
    in order), a key matching ``--model.resume-exclude-scopes`` keeps its
    fresh value, a key the file lacks keeps its fresh value and is reported
    unless it matches ``--model.ignore-missing-scopes``, and a tensor of
    another shape keeps its fresh value with a warning. A reference CVNets
    checkpoint (a state dict under ``model_state_dict`` or ``state_dict``, or
    one most of whose tensors name none of the model's) goes through the
    structural walk of ``utils/torch_checkpoint_converter.py``, as the JAX
    package sends every ``.pt`` file (engine/training_engine.py:167-200)."""
    blob = load_file(path)
    if not isinstance(blob, dict):
        raise ValueError(f"{flag} {path}: not a state dict")
    src = blob["model"] if isinstance(blob.get("model"), dict) else blob
    src = {k: v for k, v in src.items() if isinstance(v, torch.Tensor)}
    for pat, rep in _renames(opts):
        src = {re.sub(pat, rep, k): v for k, v in src.items()}
    if is_reference_checkpoint(blob, src, current):
        logger.info(f"{flag} {path}: a reference checkpoint, converted by its structure")
        return _converted(opts, path, current)
    exclude = _patterns(opts, "model.resume_exclude_scopes")
    ignore = _patterns(opts, "model.ignore_missing_scopes")
    out, missing = dict(current), []
    for key, fresh in current.items():
        if any(r.search(key) for r in exclude):
            continue
        if key not in src:
            if not any(r.search(key) for r in ignore):
                missing.append(key)
        elif tuple(src[key].shape) != tuple(fresh.shape):
            logger.warning(f"Shape mismatch for '{key}': checkpoint "
                           f"{tuple(src[key].shape)} vs model {tuple(fresh.shape)}; "
                           "keeping the fresh values")
        else:
            out[key] = src[key].to(fresh.dtype)
    if missing:
        logger.warning(f"Finetune checkpoint missing {len(missing)} tensor(s); keeping the "
                       f"fresh values of e.g. {missing[:3]} (silence with "
                       "--model.ignore-missing-scopes)")
    return out


def load_finetune(opts, state) -> None:
    """``--common.finetune`` into ``state``'s model in place, and into its EMA
    copy ``--common.finetune-ema`` or, without one, the finetuned model's
    weights (the EMA starts where the model does)."""
    path = getattr(opts, "common.finetune", None)
    if not path:
        return
    state.model.load_state_dict(finetune_weights(opts, path, state.model.state_dict()))
    logger.info(f"Loaded finetune weights from {path}")
    if state.ema is not None:
        ema_path = getattr(opts, "common.finetune_ema", None)
        state.ema.model.load_state_dict(
            finetune_weights(opts, ema_path, state.ema.model.state_dict()) if ema_path
            else state.model.state_dict())
        if ema_path:
            logger.info(f"Loaded finetune EMA weights from {ema_path}")
