"""RangeAugment and distillation on a CUDA card, at the recipe's real shapes
(no JAX here: these run on a machine with a card and no JAX, as
``python -m pytest --noconftest -m cuda tests/test_torch_range_augment_card.py``):
the augmentor at 256 × 3 × 224² on the train step's draws against the same
arithmetic on the CPU, the neural-augmentation and soft-KL losses with no
host sync, and the separable-attention kernels at MobileViTv2-2.0's 384²
shapes against their plain versions. Each skips without a card.
Tolerances: the augmentor's output 1e-6 (float32 elementwise), the scalars'
grads 1e-4 relative (sums over 38.5M elements in other orders); the kernels
as tests/test_torch_separable_attention.py holds the flagship's."""

from __future__ import annotations

import pytest
import torch


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the recipe's shapes and the kernels run there only)")


def _opts(*extra):
    from cvnets_tpu_torch.options.opts import get_training_arguments

    return get_training_arguments(args=[
        "--model.learn-augmentation.mode", "distribution",
        "--model.learn-augmentation.brightness", "--model.learn-augmentation.contrast",
        "--model.learn-augmentation.noise", *extra])


@pytest.mark.cuda
def test_augmentor_on_the_card_matches_the_cpu_on_the_train_steps_draws():
    _need_card()
    from cvnets_tpu_torch.engine.train_state import NEURAL_AUG_STREAM, step_generator
    from cvnets_tpu_torch.models.neural_augmentor.neural_aug import NeuralAugmentor

    aug = NeuralAugmentor(_opts()).train()
    on_card = NeuralAugmentor(_opts()).cuda().train()
    x = torch.rand((256, 3, 224, 224), generator=torch.Generator().manual_seed(0))
    draws = on_card.draw(x.cuda(), step_generator({}, torch.device("cuda"), 0, 5,
                                                  NEURAL_AUG_STREAM))
    cpu_draws = {n: {k: None if t is None else t.cpu() for k, t in d.items()}
                 for n, d in draws.items()}
    outs = []
    for module, inputs, d in ((aug, x, cpu_draws), (on_card, x.cuda(), draws)):
        out = module(inputs, d)
        out.square().mean().backward()
        outs.append(out.detach().cpu())
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-6
    for (name, p), q in zip(aug.named_parameters(), on_card.parameters()):
        torch.testing.assert_close(q.grad.cpu(), p.grad, rtol=1e-4, atol=1e-7, msg=name)


@pytest.mark.cuda
def test_range_augment_losses_take_no_host_sync_on_the_card():
    _need_card()
    from cvnets_tpu_torch.loss.neural_augmentation import NeuralAugmentation

    na = NeuralAugmentation(_opts())
    x = torch.rand((8, 3, 32, 32), device="cuda")
    pred = {"augmented_tensor": (x * 1.2).clamp(0, 1), "logits": torch.randn(8, 5, device="cuda")}
    step = torch.tensor(3, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        host = na(x, pred, None, epoch=3)
        device = na(x, pred, None, epoch=step)
        zero = na(x, pred["logits"], None)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.allclose(host, device, rtol=1e-6) and zero.item() == 0.0


# MobileViTv2-2.0 at 384², batch 32: (BP, N, C) of its three attention stages
FINETUNE_SHAPES = [(128, 576, 256), (128, 144, 384), (128, 36, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("bp,n,c", FINETUNE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_separable_kernels_match_plain_at_the_finetunes_shapes(bp, n, c, dtype):
    _need_card()
    from cvnets_tpu_torch.ops.separable_attention import (
        SeparableAttention,
        separable_attention_backward,
        separable_attention_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(c)
    qkv = torch.randn((bp, n, 1 + 2 * c), generator=gen, device="cuda").to(dtype)
    g = torch.randn((bp, n, c), generator=gen, device="cuda").to(dtype)
    qkv.requires_grad_(True)
    out = SeparableAttention.apply(qkv, c)
    out.backward(g)
    q, k, v = qkv.detach().split([1, c, c], dim=-1)
    ref = separable_attention_plain(q, k, v)
    ref_grads = separable_attention_backward(q, k, v, g)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol * max(
        1.0, ref.float().abs().max().item())
    for got, want in zip(qkv.grad.split([1, c, c], dim=-1), ref_grads):
        scale = max(want.float().abs().max().item(), 1e-4)
        assert (got.float() - want.float()).abs().max().item() <= tol * scale
