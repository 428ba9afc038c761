"""The port's separable-attention core against the JAX package: the plain torch
version against the Pallas body (interpret mode) and ``separable_attention_core``,
the autograd Function's grads against ``jax.grad`` through the custom VJP, the
dispatch rule ``separable_attention_eligible`` at its edge and
``LinearSelfAttention`` past it (the kernel's entry patched to fail) against the
JAX layer, and — on a CUDA card only — the hand-written kernel against the
plain version and the layer past the limit launching no kernel.

JAX is imported inside the tests that use it, so that on a machine with a card and
no JAX the kernel tests run alone:
``python -m pytest --noconftest -m cuda tests/test_torch_separable_attention.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cvnets_tpu_torch.ops.separable_attention import (
    SeparableAttention,
    separable_attention_eligible,
    separable_attention_kernel,
    separable_attention_plain,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

# float32 on both sides, same formula; only the order of the N-term sums differs
FWD_ATOL = 1e-5
# the backward chains three such sums (ctx, dctx·k, s·ds)
GRAD_ATOL = 1e-4

# the flagship's (N, C) per MobileViTv2 stage, at a small BP
SHAPES = [(4, 256, 128), (4, 64, 192), (4, 16, 256)]


def _qkv(bp, n, c, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bp, n, 1)).astype(np.float32),
            rng.standard_normal((bp, n, c)).astype(np.float32),
            rng.standard_normal((bp, n, c)).astype(np.float32))


@pytest.mark.parametrize("bp,n,c", [(2, 16, 128), (2, 64, 192)])
def test_plain_matches_pallas_body_in_interpret_mode(bp, n, c):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from cvnets_tpu.ops.pallas.mobilevit_attn import _attn_kernel

    q, k, v = _qkv(bp, n, c)
    ref = pl.pallas_call(
        _attn_kernel,
        grid=(bp,),
        in_specs=[pl.BlockSpec((1, n, 1), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, n, c), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, n, c), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, n, c), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((bp, n, c), jnp.float32),
        interpret=True,
    )(q, k, v)
    out = separable_attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("bp,n,c", SHAPES)
def test_plain_matches_jax_core(bp, n, c):
    import jax.numpy as jnp
    from cvnets_tpu.ops.pallas.mobilevit_attn import separable_attention_core

    q, k, v = _qkv(bp, n, c, seed=1)
    ref = separable_attention_core(*map(jnp.asarray, (q, k, v)))
    out = SeparableAttention.apply(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("bp,n,c", [(2, 8, 16), (3, 64, 192)])
def test_function_grads_match_jax_custom_vjp(bp, n, c):
    import jax
    import jax.numpy as jnp
    from cvnets_tpu.ops.pallas.mobilevit_attn import separable_attention_core

    q, k, v = _qkv(bp, n, c, seed=2)
    w = np.random.default_rng(3).standard_normal((bp, n, c)).astype(np.float32)

    def f(q, k, v):
        return jnp.sum(separable_attention_core(q, k, v) * w)

    ref = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    (SeparableAttention.apply(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=GRAD_ATOL,
                                   rtol=0, err_msg=name)


def test_function_grads_match_autograd_of_plain():
    """The hand-written backward against torch autograd through the plain forward,
    on a strided q/k/v split of one qkv tensor as LinearSelfAttention makes it."""
    rng = np.random.default_rng(4)
    d = 24
    qkv = torch.from_numpy(rng.standard_normal((3, 32, 1 + 2 * d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 32, d)).astype(np.float32))
    grads = []
    for fn in (SeparableAttention.apply, separable_attention_plain):
        x = qkv.clone().requires_grad_()
        q, k, v = x.split([1, d, d], dim=-1)
        (fn(q, k, v) * w).sum().backward()
        grads.append(x.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), atol=1e-5, rtol=0)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = map(torch.from_numpy, _qkv(2, 8, 16))
    before = separable_attention_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        separable_attention_kernel(q, k, v)
    assert separable_attention_kernel.launches == before


@pytest.mark.parametrize("n,ok", [(12256, True), (12257, False), (1024, True)],
                         ids=["n12256", "n12257", "deeplabv3_layer3"])
def test_eligibility_is_what_the_kernel_shared_memory_takes(n, ok):
    """(N + 32)·4 bytes in the 48 KB a block has without opting in: at most
    12,256 tokens (DeepLabv3's largest map, 1,024, far inside)."""
    assert separable_attention_eligible(n) is ok


def _layer_pair(embed: int, x: np.ndarray):
    """The JAX ``LinearSelfAttention`` with perturbed weights and the port's
    layer on the same weights."""
    import sys

    sys.path.insert(0, "tests")
    from torch_port_helpers import both_opts, perturbed_variables

    from cvnets_tpu.layers.linear_attention import LinearSelfAttention as JaxLayer
    from cvnets_tpu_torch.layers.linear_attention import LinearSelfAttention
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    opts_jax, opts_torch = both_opts([])
    jlayer = JaxLayer(opts=opts_jax, embed_dim=embed)
    variables = perturbed_variables(jlayer, x)
    layer = LinearSelfAttention(opts_torch, embed)
    load_jax_params(layer, variables["params"])
    return jlayer, variables, layer


def test_layer_past_the_kernel_limit_takes_the_plain_branch_and_matches_jax(monkeypatch):
    """N = 12,257 tokens: with ``separable_attention_bphw`` patched to fail (the
    dispatch is the same on the CPU), the layer computes through its plain
    branch and matches the JAX layer (its non-kernel route): f32 on both
    sides, the context a sum of 12,257 terms in another order (1e-4, where
    FWD_ATOL holds sums of at most 256). At N = 12,256 the same layer reaches
    the patched entry."""
    import jax.numpy as jnp

    from cvnets_tpu_torch.layers import linear_attention

    x = np.random.default_rng(5).standard_normal((1, 2, 12257, 8)).astype(np.float32)
    jlayer, variables, layer = _layer_pair(8, x)
    assert layer.use_kernel

    def refuse(*args):
        raise AssertionError("separable_attention_bphw was called")

    monkeypatch.setattr(linear_attention, "separable_attention_bphw", refuse)
    with torch.no_grad():
        out = layer(torch.from_numpy(x))
        ref = jlayer.apply(variables, jnp.asarray(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
        with pytest.raises(AssertionError, match="separable_attention_bphw"):
            layer(torch.from_numpy(x[:, :, :12256]))


@pytest.mark.cuda
def test_layer_past_the_kernel_limit_runs_on_cuda_without_the_kernel():
    """Where the kernel used to raise, the layer on the card computes through
    its plain branch: finite, equal to the same layer with the kernel off, and
    no kernel launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    from cvnets_tpu_torch.layers.linear_attention import LinearSelfAttention
    from cvnets_tpu_torch.options.opts import get_training_arguments

    torch.manual_seed(0)
    layer = LinearSelfAttention(get_training_arguments(args=[]), 64).cuda()
    x = torch.randn((2, 4, 12257, 64), device="cuda")
    before = separable_attention_kernel.launches
    with torch.no_grad():
        out = layer(x)
        layer.use_kernel = False
        want = layer(x)
    torch.cuda.synchronize()
    assert separable_attention_kernel.launches == before
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c", [(256, 128), (64, 192), (16, 256)])
def test_kernel_matches_plain_on_cuda(n, c, dtype):
    """BP=512 is the flagship's batch 128 × patch area 4. Tolerances: float32 sums
    in another order (1e-5); bfloat16 output rounding (2e-2 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU or interpret mode)")
    g = torch.Generator(device="cuda").manual_seed(0)
    qkv = torch.randn((512, n, 1 + 2 * c), generator=g, device="cuda").to(dtype)
    q, k, v = qkv.split([1, c, c], dim=-1)
    before = separable_attention_kernel.launches
    out = separable_attention_kernel(q, k, v)
    torch.cuda.synchronize()
    assert separable_attention_kernel.launches == before + 1
    ref = separable_attention_plain(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=2e-2)
