"""Detection models (counterpart of cvnets_tpu/models/detection/__init__.py)."""

from collections import namedtuple

# (labels, scores, boxes, masks), as the JAX package's DetectionPredTuple
DetectionPredTuple = namedtuple("DetectionPredTuple", ["labels", "scores", "boxes", "masks"],
                                defaults=(None,))
