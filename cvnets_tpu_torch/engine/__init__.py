"""Training and evaluation engine (counterpart of cvnets_tpu/engine)."""

from cvnets_tpu_torch.engine.evaluation_engine import Evaluator
from cvnets_tpu_torch.engine.training_engine import Trainer

__all__ = ["Evaluator", "Trainer"]
