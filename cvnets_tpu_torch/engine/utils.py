"""Log writers (counterpart of cvnets_tpu/engine/utils.py:1-68): scalars a
step as JSON lines in ``<save dir>/scalars.jsonl``, or through TensorBoard's
``SummaryWriter`` into ``<save dir>/tb`` under
``--common.tensorboard-logging``; where ``tensorboard`` is missing the writer
falls back to JSON lines with a warning, as the JAX package's does. The
Trainer builds them on the master alone."""

from __future__ import annotations

import json
import os
from typing import Dict, List

from cvnets_tpu_torch.utils import logger


class BaseLogWriter:
    def add_scalar(self, tag: str, value: float, step: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class JSONLLogWriter(BaseLogWriter):
    """Appends ``{"tag", "value", "step"}`` lines, flushed each time."""

    def __init__(self, log_dir: str) -> None:
        os.makedirs(log_dir, exist_ok=True)
        self._f = open(os.path.join(log_dir, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TensorBoardLogWriter(BaseLogWriter):
    def __init__(self, log_dir: str) -> None:
        from torch.utils.tensorboard import SummaryWriter  # needs the tensorboard package

        self._w = SummaryWriter(log_dir=log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._w.add_scalar(tag, value, step)

    def close(self) -> None:
        self._w.close()


def get_log_writers(opts, save_location: str) -> List[BaseLogWriter]:
    """The writers ``--common.tensorboard-logging`` asks for (none without it)."""
    writers: List[BaseLogWriter] = []
    if getattr(opts, "common.tensorboard_logging", False):
        try:
            writers.append(TensorBoardLogWriter(os.path.join(save_location, "tb")))
        except Exception as e:  # noqa: BLE001  (the JAX package's fallback)
            logger.warning(f"TensorBoard writer unavailable ({e}); using jsonl")
            writers.append(JSONLLogWriter(save_location))
    return writers


def log_metrics(writers: List[BaseLogWriter], metrics: Dict[str, float], step: int,
                prefix: str = "") -> None:
    for w in writers:
        for k, v in metrics.items():
            if isinstance(v, (int, float)):
                w.add_scalar(f"{prefix}{k}", v, step)
