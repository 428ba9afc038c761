"""Gradient checkpointing in the port (``layers/remat.py``): with
``--model.classification.gradient-checkpointing`` (each stage of a conv
family, each ViT block dense or MoE, each Swin block) the loss, the
gradients, the parameters, the BN running statistics and their step
counters, and the EMA after two AdamW steps equal those of the run without
it, bit for bit. The recomputation in the backward must not move a BN's
statistics a second time nor draw other dropout masks (MobileNetV2's
classifier dropout 0.1, the ViT's dropout and stochastic depth 0.1), and an
MoE layer's load-balance loss must count once. The text tower's case is in
test_torch_clip.py. JAX's ``nn.remat`` is functional, so there is nothing
to hold against the JAX package here beyond what the models' own parity
tests hold."""

from __future__ import annotations

import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import (  # noqa: E402
    SWIN_MICRO_ARGS,
    VIT_MICRO_ARGS,
    assert_checkpointing_changes_nothing,
    checkpointing_runs,
    micro_swin_modes,
    torch_threads,
    uint8_batches,
)

CASES = {
    "mobilenetv2": ["--model.classification.name", "mobilenetv2",
                    "--model.classification.mobilenetv2.width-multiplier", "0.25",
                    "--model.classification.classifier-dropout", "0.1",
                    "--model.classification.n-classes", "13",
                    "--dataset.category", "classification"],
    "vit": VIT_MICRO_ARGS + ["--model.classification.vit.dropout", "0.1",
                             "--model.classification.vit.stochastic-dropout", "0.1"],
    "vit_moe": VIT_MICRO_ARGS + ["--model.classification.vit.moe-num-experts", "4",
                                 "--model.classification.vit.moe-capacity-factor", "0.75"],
    "swin": SWIN_MICRO_ARGS,
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    with torch_threads(2):
        yield


@pytest.mark.parametrize("name", sorted(CASES))
def test_checkpointing_changes_no_loss_grad_statistic_or_ema(name):
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments

    batches = uint8_batches(seed=3, n=2, batch=4, size=64)
    with micro_swin_modes():
        runs = checkpointing_runs(CASES[name], batches)
        opts = get_training_arguments(args=CASES[name] + [
            "--model.classification.gradient-checkpointing"])
        assert get_model(opts, device="cpu").gradient_checkpointing
    assert_checkpointing_changes_nothing(runs)
    assert all(np.isfinite(runs["on"][0]))


class CountedStage(torch.nn.Sequential):
    """conv → BN → dropout, counting its forwards."""

    def __init__(self) -> None:
        super().__init__(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4),
                         torch.nn.Dropout(0.5))
        self.calls = 0

    def forward(self, x):
        self.calls += 1
        return super().forward(x)


def test_recomputation_runs_in_the_backward_and_keeps_the_bn_statistics():
    """A checkpointed stage's forward runs twice a step (the second time in
    the backward), with the output, the input's grad, the dropout mask and
    the BN statistics of a plain call."""
    from cvnets_tpu_torch.layers.remat import remat

    torch.manual_seed(0)
    stage, twin = CountedStage().train(), CountedStage().train()
    twin.load_state_dict(stage.state_dict())
    x = torch.randn(2, 3, 8, 8, requires_grad=True)
    x2 = x.detach().clone().requires_grad_()
    torch.manual_seed(1)
    out = remat(stage, x)
    (out ** 2).sum().backward()
    torch.manual_seed(1)
    out2 = twin(x2)
    (out2 ** 2).sum().backward()
    assert (stage.calls, twin.calls) == (2, 1)
    assert torch.equal(out, out2) and torch.equal(x.grad, x2.grad)
    for key, value in twin.state_dict().items():
        assert torch.equal(stage.state_dict()[key], value), key
