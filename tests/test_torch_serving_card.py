"""The serving path on a CUDA card (no JAX here: run on a machine with a card
as ``python -m pytest --noconftest -m cuda tests/test_torch_serving_card.py``):
int8 dynamic layers reach ``torch._int_mm`` (its CUDA shape rules met by the
padding, the sums exact against the CPU's), the int8 models' float32 logits on
the card against a CPU copy, and the exported programs of a micro MobileViTv2
and the micro ViT record the forward kernels as ``cvnets_tpu_torch`` custom op
nodes (9 and 2), as does a window-attention call (1), and run them after a
reload. Each skips without a card. Tolerances: int8 sums exact; the
weight-only logits 1e-3 of max(1, |logit|) (TF32 off, other summation
orders), the dynamic ones 5e-2 (a code moves where float32 noise crosses a
rounding tie); the reloaded program within 1e-5 of the live model (the same
kernels on the same input)."""

from __future__ import annotations

import copy
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, "tests")

from torch_port_helpers import SMALL_MODEL_ARGS, VIT_MICRO_ARGS  # noqa: E402

TOL = {"weight-only": 1e-3, "dynamic": 5e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch._int_mm's CUDA route and the kernels run there)")


@pytest.mark.cuda
@pytest.mark.parametrize("m, k, n", [(5, 27, 13), (34, 64, 13), (128, 768, 1000), (17, 8, 8)])
def test_int8_matmul_on_cuda_is_exact(m, k, n):
    _need_card()
    from cvnets_tpu_torch.quantization import int8_matmul

    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-127, 128, (m, k), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (n, k), dtype=np.int8))
    got = int8_matmul(a.cuda(), w.cuda())
    assert got.dtype == torch.int32 and tuple(got.shape) == (m, n)
    assert torch.equal(got.cpu(), a.int() @ w.int().t())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["weight-only", "dynamic"])
@pytest.mark.parametrize("args", [SMALL_MODEL_ARGS, VIT_MICRO_ARGS], ids=["mobilevit_v2", "vit"])
def test_int8_models_on_cuda_reach_int_mm_and_match_the_cpu(args, mode, monkeypatch):
    _need_card()
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.quantization import int8_layers, prequantize

    calls = []
    real = torch._int_mm

    def spy(a, b):
        calls.append((a.device.type, tuple(a.shape), tuple(b.shape)))
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", spy)
    opts = get_training_arguments(args=args + ["--common.int8-inference",
                                               "--common.int8-mode", mode])
    model = prequantize(get_model(opts, device="cuda")).eval()
    on_cpu = copy.deepcopy(model).cpu()
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(0))
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            got = model(x.cuda()).cpu()
            cuda_calls = list(calls)
            want = on_cpu(x)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    layers = int8_layers(model)
    if mode == "dynamic":
        assert len(cuda_calls) == len(layers) and all(d == "cuda" for d, _, _ in cuda_calls)
        assert all(m_ > 16 and k_ % 8 == 0 and n_ % 8 == 0 for _, (m_, k_), (_, n_) in cuda_calls)
        assert all(layer.int_mm_calls == 1 for layer in layers.values())
    else:
        assert not cuda_calls
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= TOL[mode] * scale


@pytest.mark.cuda
@pytest.mark.parametrize("args, n, op", [
    (SMALL_MODEL_ARGS, 9, "separable_attention_fwd"), (VIT_MICRO_ARGS, 2, "mha_attention_fwd")],
    ids=["mobilevit_v2", "vit"])
def test_exported_programs_count_the_custom_op_nodes_on_cuda(args, n, op, tmp_path):
    _need_card()
    from cvnets_tpu_torch.main_conversion import main_worker_conversion

    done = main_worker_conversion(args=args + [
        "--sampler.bs.crop-size-width", "64", "--sampler.bs.crop-size-height", "64",
        "--common.results-loc", str(tmp_path)])
    assert done.custom_ops == [f"cvnets_tpu_torch.{op}.default"] * n
    assert done.rel_diff <= 1e-5


@pytest.mark.cuda
def test_window_attention_exports_as_one_custom_op_node_on_cuda():
    _need_card()
    from cvnets_tpu_torch.main_conversion import custom_op_nodes
    from cvnets_tpu_torch.ops.window_attention import fused_window_attention, window_fwd_kernel

    class Call(torch.nn.Module):
        def forward(self, q, k, v, bias):
            return fused_window_attention(q, k, v, 3, bias)

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((8, 49, 48), generator=g).cuda() for _ in range(3))
    bias = torch.randn((3, 49, 49), generator=g).cuda()
    with torch.no_grad():
        program = torch.export.export(Call(), (q, k, v, bias))
        assert custom_op_nodes(program) == ["cvnets_tpu_torch.window_attention_fwd.default"]
        before = window_fwd_kernel.launches
        got = program.module()(q, k, v, bias)
        assert window_fwd_kernel.launches == before + 1
        assert torch.equal(got, Call()(q, k, v, bias))
