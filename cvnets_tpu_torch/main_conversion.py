"""Export entry point of the port (counterpart of main_conversion.py):

    python -m cvnets_tpu_torch.main_conversion --common.config-file <yaml> \
        [--model.classification.pretrained <checkpoint.pt>] [--conversion.reparameterize]

1. builds the model on ``device`` (the CUDA card unless the caller asks for
   the CPU) and loads ``--model.<category>.pretrained`` (else
   ``--common.finetune``): a checkpoint of the port, or a reference CVNets
   checkpoint through ``utils/torch_checkpoint_converter.py``;
2. with ``--conversion.reparameterize`` folds the MobileOne and RepLK blocks
   (MobileOne, FastViT's MobileOne units) into deploy form
   (``utils/reparam_utils.reparameterize_model``);
3. exports the eval forward in float32 at the config's crop size, batch 1,
   with ``torch.export.export`` and writes ``model.pt2`` (``torch.export.save``)
   and ``model_graph.txt``, the graph's readable text, under
   ``<results_loc>/<run_label>``;
4. checks the reloaded program against the live model on
   ``--conversion.input-image-path`` or a seeded batch and logs max |diff|
   and its ratio to the largest output; above 1e-2 of it is an error.

On the card the attention layers run their kernels, which the graph records
as ``torch.ops.cvnets_tpu_torch.*`` custom ops (``ops/separable_attention.py``,
``ops/mha_attention.py``, ``ops/window_attention.py``): a process that loads
``model.pt2`` must ``import cvnets_tpu_torch`` first, which registers them.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

from cvnets_tpu_torch.constants import DEFAULT_IMAGE_WIDTH
from cvnets_tpu_torch.models import get_model
from cvnets_tpu_torch.options.opts import get_conversion_arguments
from cvnets_tpu_torch.utils import logger
from cvnets_tpu_torch.utils.common_utils import device_setup

OPS_NAMESPACE = "cvnets_tpu_torch"


def crop_size(opts) -> tuple:
    """(height, width) of the eval forward: the crop size of the options'
    sampler (``sampler.vbs.*`` for a variable batch sampler, else
    ``sampler.bs.*``)."""
    key = "vbs" if "variable" in (getattr(opts, "sampler.name", "") or "") else "bs"
    return tuple(getattr(opts, f"sampler.{key}.crop_size_{side}", None) or DEFAULT_IMAGE_WIDTH
                 for side in ("height", "width"))


def pretrained_path(opts) -> Optional[str]:
    category = getattr(opts, "dataset.category", "classification")
    return (getattr(opts, f"model.{category}.pretrained", None)
            or getattr(opts, "common.finetune", None))


def load_pretrained(opts, model: torch.nn.Module) -> None:
    """The weights of ``pretrained_path(opts)``, if any, into ``model``: a
    port checkpoint as it is, a reference one through the converter."""
    from cvnets_tpu_torch.utils.checkpoint_utils import pretrained_weights

    path = pretrained_path(opts)
    if path:
        model.load_state_dict(pretrained_weights(opts, path, model.state_dict()))
        logger.info(f"Loaded pretrained weights from {path}")


def logits_of(out):
    return out["logits"] if isinstance(out, dict) and "logits" in out else out


class EvalForward(torch.nn.Module):
    """The model's eval forward returning its logits (what is exported)."""

    def __init__(self, model: torch.nn.Module) -> None:
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return logits_of(self.model(x))


def custom_op_nodes(program) -> List[str]:
    """The ``cvnets_tpu_torch`` custom ops an exported program calls, one
    entry a node."""
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith(f"{OPS_NAMESPACE}.")]


def check_input(opts, shape: tuple, device) -> torch.Tensor:
    """The assertion check's batch: the image of ``--conversion.input-image-path``
    (resized, in [0, 1], repeated over the batch) or a seeded normal batch."""
    path = getattr(opts, "conversion.input_image_path", None)
    if path and os.path.isfile(path):
        from PIL import Image

        with Image.open(path) as img:
            pixels = np.asarray(img.convert("RGB").resize((shape[3], shape[2])), np.float32)
        logger.info(f"Assertion check uses image {path}")
        x = torch.from_numpy(pixels / 255.0).permute(2, 0, 1)[None].expand(shape)
        return x.contiguous().to(device)
    rng = np.random.default_rng(getattr(opts, "common.seed", 0) or 0)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


@dataclass
class Conversion:
    """What an export made: the program's path, its ``cvnets_tpu_torch``
    custom op nodes, and the assertion check's max |exported - live| and its
    ratio to the live output's largest magnitude."""

    path: str
    custom_ops: List[str]
    max_abs_diff: float
    rel_diff: float


def main(opts, device: Union[str, torch.device, None] = None, **kwargs) -> Conversion:
    device = device_setup(opts, device)
    model = get_model(opts, device=device)
    load_pretrained(opts, model)
    if getattr(opts, "conversion.reparameterize", False):
        from cvnets_tpu_torch.utils.reparam_utils import reparameterize_model

        model.eval()
        reparameterize_model(model)
        logger.info("Folded re-parameterizable branches into deploy form")
    forward = EvalForward(model).eval()
    shape = (1, 3, *crop_size(opts))
    example = torch.zeros(shape, device=device)
    with torch.no_grad():
        program = torch.export.export(forward, (example,))
    ops = custom_op_nodes(program)
    logger.info(f"Exported the eval forward at {shape} ({len(ops)} {OPS_NAMESPACE} custom "
                "op nodes)")

    out_dir = os.path.join(getattr(opts, "common.results_loc", "results"),
                           getattr(opts, "common.run_label", "run_1"))
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "model.pt2")
    torch.export.save(program, path)
    with open(os.path.join(out_dir, "model_graph.txt"), "w") as f:
        f.write(str(program.graph_module.code))
    logger.info(f"Saved the exported program to {path}")

    # assertion check (reference utils/pytorch_to_coreml.py:97): the reloaded
    # program against the live model
    x = check_input(opts, shape, device)
    with torch.no_grad():
        got = torch.export.load(path).module()(x)
        want = forward(x)
    abs_diff = float((got.float() - want.float()).abs().max())
    rel = abs_diff / (float(want.float().abs().max()) or 1.0)
    logger.info(f"Assertion check: max |exported - live| = {abs_diff:.3e} (rel {rel:.3e})")
    if rel > 1e-2:
        logger.error(f"Exported model diverges from the live model: rel {rel}")
    return Conversion(path, ops, abs_diff, rel)


def main_worker_conversion(args: Optional[List[str]] = None,
                           device: Union[str, torch.device, None] = None,
                           **kwargs) -> Conversion:
    return main(get_conversion_arguments(args=args), device=device, **kwargs)


if __name__ == "__main__":
    main_worker_conversion(sys.argv[1:])
