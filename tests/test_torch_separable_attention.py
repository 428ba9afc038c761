"""The port's separable-attention core against the JAX package: the plain torch
version against the Pallas body (interpret mode) and ``separable_attention_core``,
the qkv-taking autograd Function's gradient of qkv against ``jax.grad`` through
the custom VJP (float32 and bfloat16 inputs), ``LinearSelfAttention``'s
parameter gradients on the kernel route against the JAX layer's, the dispatch
rule ``separable_attention_eligible`` at its edge and the layer past it (the
kernels' entry patched to fail) against the JAX layer, and — on a CUDA card
only — the hand-written forward (with its saved statistics) and backward
kernels against the plain versions at the flagship's and DeepLabv3's shapes,
the backward the same bit for bit on a rerun, both at ragged token counts and
at each cluster size, both layouts the wrappers take, an expanded or
transposed upstream gradient, and the layer past the limit launching no
kernel.

JAX is imported inside the tests that use it, so that on a machine with a card and
no JAX the kernel tests run alone:
``python -m pytest --noconftest -m cuda tests/test_torch_separable_attention.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cvnets_tpu_torch.ops.separable_attention import (
    SeparableAttention,
    separable_attention_backward,
    separable_attention_bwd_kernel,
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
# (BP, N, C) of every separable-attention call of the flagship (batch 128 ×
# patch area 4) and of DeepLabv3 (batch 8 × 4), as chip_smoke.py runs them
CARD_SHAPES = [(512, 256, 128), (512, 64, 192), (512, 16, 256),
               (32, 1024, 128), (32, 256, 192), (32, 256, 256)]


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
    out = SeparableAttention.apply(torch.from_numpy(np.concatenate([q, k, v], -1)), c)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=0)


def _qkv_grads(bp, n, c, dtype):
    """The gradient of qkv through the Function and jax.grad's of q, k and v
    through ``separable_attention_core``, on the same seeded inputs (rounded
    to ``dtype`` first) and the same weights of the output."""
    import jax
    import jax.numpy as jnp
    from cvnets_tpu.ops.pallas.mobilevit_attn import separable_attention_core

    q, k, v = _qkv(bp, n, c, seed=2)
    w = np.random.default_rng(3).standard_normal((bp, n, c)).astype(np.float32)
    qkv = torch.from_numpy(np.concatenate([q, k, v], -1)).to(dtype).requires_grad_()
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ins = [jnp.asarray(t.float().numpy()).astype(jdtype) for t in qkv.detach().split([1, c, c], -1)]

    def f(q, k, v):
        return jnp.sum(separable_attention_core(q, k, v).astype(jnp.float32) * w)

    ref = jax.grad(f, argnums=(0, 1, 2))(*ins)
    (SeparableAttention.apply(qkv, c).float() * torch.from_numpy(w)).sum().backward()
    return qkv.grad.float().split([1, c, c], -1), [np.asarray(r.astype(jnp.float32)) for r in ref]


def test_bphw_matches_jax_bphw():
    """The layer's entry ``separable_attention_qkv`` ((B, P, N, 1 + 2C), q, k
    and v joined as the qkv projection makes them) against the JAX package's
    ``separable_attention_bphw`` on q, k and v held apart, float32."""
    import jax.numpy as jnp
    from cvnets_tpu.ops.pallas.mobilevit_attn import separable_attention_bphw as jax_bphw

    from cvnets_tpu_torch.ops.separable_attention import separable_attention_qkv

    q, k, v = (a.reshape(2, 4, 16, -1) for a in _qkv(8, 16, 32, seed=9))
    ref = jax_bphw(*map(jnp.asarray, (q, k, v)))
    out = separable_attention_qkv(torch.from_numpy(np.concatenate([q, k, v], -1)), 32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=0)


@pytest.mark.parametrize("bp,n,c", [(2, 8, 16), (3, 64, 192)])
def test_function_grads_match_jax_custom_vjp(bp, n, c):
    """float32: the gradient of qkv against jax.grad's of q, k and v."""
    got, ref = _qkv_grads(bp, n, c, torch.float32)
    for name, g, want in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), want, atol=GRAD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("bp,n,c", [(2, 8, 16), (3, 64, 192)])
def test_function_grads_from_bf16_inputs_match_jax_custom_vjp(bp, n, c):
    """bfloat16 qkv: both sides compute the VJP in float32 from the same bf16
    inputs and round each gradient to bf16 once, so they differ by at most one
    bf16 step of the gradient (2^-7 relative) where the float32 values fall on
    either side of a rounding edge, plus GRAD_ATOL."""
    got, ref = _qkv_grads(bp, n, c, torch.bfloat16)
    for name, g, want in zip("qkv", got, ref):
        np.testing.assert_allclose(g.numpy(), want, atol=GRAD_ATOL, rtol=2 ** -7, err_msg=name)


def test_function_grads_match_autograd_of_plain():
    """The hand-written backward against torch autograd through the plain forward,
    on one qkv tensor as LinearSelfAttention makes it."""
    rng = np.random.default_rng(4)
    d = 24
    qkv = torch.from_numpy(rng.standard_normal((3, 32, 1 + 2 * d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 32, d)).astype(np.float32))
    grads = []
    for fn in (lambda x: SeparableAttention.apply(x, d),
               lambda x: separable_attention_plain(*x.split([1, d, d], dim=-1))):
        x = qkv.clone().requires_grad_()
        (fn(x) * w).sum().backward()
        grads.append(x.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), atol=1e-5, rtol=0)


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = map(torch.from_numpy, _qkv(2, 8, 16))
    before = separable_attention_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        separable_attention_kernel(q, k, v)
    assert separable_attention_kernel.launches == before


def test_backward_wrapper_rejects_what_the_kernel_does_not_take():
    qkv = torch.from_numpy(np.concatenate(_qkv(2, 8, 16), -1))
    q, k, v = qkv.split([1, 16, 16], dim=-1)
    stats, ctx = torch.zeros((2, 2)), torch.zeros((2, 16))
    before = separable_attention_bwd_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        separable_attention_bwd_kernel(q, k, v, v, stats, ctx, *torch.empty_like(qkv).split(
            [1, 16, 16], dim=-1))
    assert separable_attention_bwd_kernel.launches == before


@pytest.mark.parametrize("c,ok", [(512, True), (520, False), (12, False), (8, True),
                                  (0, False), (128, True)],
                         ids=["c512", "c520", "c12", "c8", "c0", "flagship_layer3"])
def test_eligibility_is_what_the_kernel_shared_memory_takes(c, ok):
    """The kernels' shared memory no longer grows with N ((10·C + 10) floats a
    block, 20 KB at C = 512), so any N is taken; a lane reads eight channels
    at once and covers at most two groups of 32 lanes' worth, so C must be a
    multiple of 8 up to 512 (MobileViTv2 at width multiplier 2.0)."""
    assert separable_attention_eligible(c) is ok


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
    """C = 12, not a multiple of 8: with ``separable_attention_qkv`` patched to
    fail (the dispatch is the same on the CPU), the layer computes through its
    plain branch and matches the JAX layer (its non-kernel route), f32 on both
    sides. At C = 16 the same input reaches the patched entry."""
    import jax.numpy as jnp

    from cvnets_tpu_torch.layers import linear_attention

    x = np.random.default_rng(5).standard_normal((1, 2, 64, 12)).astype(np.float32)
    jlayer, variables, layer = _layer_pair(12, x)
    assert layer.use_kernel

    def refuse(*args):
        raise AssertionError("separable_attention_qkv was called")

    monkeypatch.setattr(linear_attention, "separable_attention_qkv", refuse)
    with torch.no_grad():
        out = layer(torch.from_numpy(x))
        ref = jlayer.apply(variables, jnp.asarray(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FWD_ATOL, rtol=0)
        x16 = np.random.default_rng(6).standard_normal((1, 2, 64, 16)).astype(np.float32)
        with pytest.raises(AssertionError, match="separable_attention_qkv"):
            _layer_pair(16, x16)[2](torch.from_numpy(x16))


def test_layer_param_grads_on_the_kernel_route_match_jax():
    """``LinearSelfAttention`` with the kernel route on (the qkv-taking Function,
    its plain twins on the CPU) against ``jax.grad`` of the JAX layer over its
    parameters, on the same perturbed weights (``load_jax_params``): each
    parameter's gradient, mapped onto the port's layout by loading the JAX
    gradient tree with ``load_jax_params``. float32; the gradients chain the
    core's sums with the two projections' (GRAD_ATOL)."""
    import jax
    import jax.numpy as jnp

    from cvnets_tpu_torch.layers.linear_attention import LinearSelfAttention
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    embed = 16
    x = np.random.default_rng(7).standard_normal((2, 4, 32, embed)).astype(np.float32)
    w = np.random.default_rng(8).standard_normal((2, 4, 32, embed)).astype(np.float32)
    jlayer, variables, layer = _layer_pair(embed, x)
    assert layer.use_kernel and separable_attention_eligible(embed)

    def loss(params):
        return jnp.sum(jlayer.apply({**variables, "params": params}, jnp.asarray(x)) * w)

    jgrads = jax.grad(loss)(variables["params"])
    (layer(torch.from_numpy(x)) * torch.from_numpy(w)).sum().backward()
    want = LinearSelfAttention(get_training_arguments(args=[]), embed)
    load_jax_params(want, jax.tree_util.tree_map(np.asarray, jgrads))
    got = dict(layer.named_parameters())
    for name, p in want.named_parameters():
        np.testing.assert_allclose(got[name].grad.numpy(), p.detach().numpy(),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_layer_cross_path_matches_jax():
    """The temporal (cross) path of the video models: q and k from the
    previous frame ``x_prev``, v from ``x``, through slices of the one fused
    projection (JAX linear_attention.py:46-57). The layer's output and the
    gradients of x, x_prev and every parameter against ``jax.grad`` of the
    JAX layer with ``x_prev``, on the kernel route (its plain twins here) and
    on the plain branch; a previous frame with another token count takes the
    plain branch. float32, GRAD_ATOL."""
    import jax
    import jax.numpy as jnp

    from cvnets_tpu_torch.layers.linear_attention import LinearSelfAttention
    from cvnets_tpu_torch.options.opts import get_training_arguments
    from cvnets_tpu_torch.utils.jax_params import load_jax_params

    embed = 16
    rng = np.random.default_rng(9)
    x, x_prev, w = (rng.standard_normal((2, 4, 32, embed)).astype(np.float32)
                    for _ in range(3))
    jlayer, variables, layer = _layer_pair(embed, x)

    def loss(params, a, b):
        return jnp.sum(jlayer.apply({**variables, "params": params}, jnp.asarray(a),
                                    x_prev=jnp.asarray(b)) * w)

    jgrads, gx, gprev = jax.grad(loss, argnums=(0, 1, 2))(variables["params"], x, x_prev)
    want = LinearSelfAttention(get_training_arguments(args=[]), embed)
    load_jax_params(want, jax.tree_util.tree_map(np.asarray, jgrads))
    for use_kernel in (True, False):
        layer.use_kernel = use_kernel
        layer.zero_grad()
        a, b = (torch.from_numpy(t).requires_grad_() for t in (x, x_prev))
        (layer(a, b) * torch.from_numpy(w)).sum().backward()
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(gx), atol=GRAD_ATOL, rtol=0)
        np.testing.assert_allclose(b.grad.numpy(), np.asarray(gprev), atol=GRAD_ATOL, rtol=0)
        got = dict(layer.named_parameters())
        for name, p in want.named_parameters():
            np.testing.assert_allclose(got[name].grad.numpy(), p.detach().numpy(),
                                       atol=GRAD_ATOL, rtol=0, err_msg=name)
    setattr(jlayer.opts, "model.enable_pallas_kernels", False)  # its kernel takes M = N
    short = np.asarray(jlayer.apply(variables, jnp.asarray(x),
                                    x_prev=jnp.asarray(x_prev[:, :, :8])))
    with torch.no_grad():
        got_short = layer(torch.from_numpy(x), torch.from_numpy(x_prev[:, :, :8]))
    np.testing.assert_allclose(got_short.numpy(), short, atol=FWD_ATOL, rtol=0)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")


def _card_qkv(bp, n, c, dtype, seed=0):
    """A qkv tensor (q, k, v its column views, as on the main path) and a g."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((bp, n, 1 + 2 * c), generator=gen, device="cuda").to(dtype)
    g = torch.randn((bp, n, c), generator=gen, device="cuda").to(dtype)
    return qkv, g


def _assert_qkv_grads_close(got, ref, c, dtype):
    """dq, dk and dv, the column parts of one (BP, N, 1 + 2C) gradient, each
    finite and within its own tolerance of the reference: float32 GRAD_ATOL
    (three sums chained in another order); bfloat16 2e-2 of that part's
    largest value (each rounded to bf16 once, from float32 values that
    differ), never under GRAD_ATOL: where a part is zero in exact arithmetic
    (dq at N = 1, where s = 1) the two sides' float32 cancellations leave
    ~1e-6. dq runs about 100 times larger than dk and dv, so one tolerance
    for the whole dqkv would let a wrong dk or dv pass."""
    assert bool(torch.isfinite(got).all())
    for part, a, b in zip(("dq", "dk", "dv"), got.float().split([1, c, c], dim=-1),
                          ref.float().split([1, c, c], dim=-1)):
        tol = GRAD_ATOL if dtype == torch.float32 else max(2e-2 * b.abs().max().item(),
                                                           GRAD_ATOL)
        err = (a - b).abs().max().item()
        assert err <= tol, f"{part}: max abs err {err} > {tol}"


def _stats_plain(q, k):
    """The forward's saved statistics in plain torch: (max, sum of exp(q -
    max)) a row and ctx, float32."""
    qf = q.float()[..., 0]
    m = qf.max(dim=1).values
    s = torch.exp(qf - m[:, None])
    ctx = ((k.float() * torch.softmax(q.float(), dim=1)).sum(dim=1))
    return torch.stack([m, s.sum(dim=1)], dim=1), ctx


@pytest.mark.cuda
def test_layer_past_the_kernel_limit_runs_on_cuda_without_the_kernel():
    """Where the kernels would raise (C = 520 > 512), the layer on the card
    computes through its plain branch: finite, equal to the same layer with
    the kernel off, and no kernel launched."""
    _need_card()
    from cvnets_tpu_torch.layers.linear_attention import LinearSelfAttention
    from cvnets_tpu_torch.options.opts import get_training_arguments

    torch.manual_seed(0)
    layer = LinearSelfAttention(get_training_arguments(args=[]), 520).cuda()
    x = torch.randn((2, 4, 64, 520), device="cuda")
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
    """BP=512 is the flagship's batch 128 × patch area 4. The output and the
    statistics the forward saves for the backward (the softmax's max and sum a
    row, ctx). Tolerances: float32 sums in another order (1e-5; the sum of
    exponentials 1e-5 relative); bfloat16 output rounding (2e-2 relative)."""
    _need_card()
    qkv, _ = _card_qkv(512, n, c, dtype)
    q, k, v = qkv.split([1, c, c], dim=-1)
    before = separable_attention_kernel.launches
    out, stats, ctx = separable_attention_kernel(q, k, v)
    torch.cuda.synchronize()
    assert separable_attention_kernel.launches == before + 1
    ref = separable_attention_plain(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=2e-2)
    ref_stats, ref_ctx = _stats_plain(q, k)
    torch.testing.assert_close(stats, ref_stats, atol=0, rtol=1e-5)
    torch.testing.assert_close(ctx, ref_ctx, atol=1e-5, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bp,n,c", CARD_SHAPES)
def test_backward_kernel_matches_plain_on_cuda(bp, n, c, dtype):
    """dq, dk and dv of the backward kernel (one dqkv, from the forward
    kernel's statistics) against ``separable_attention_backward`` at every
    shape of the flagship and DeepLabv3, each part to its own tolerance
    (``_assert_qkv_grads_close``)."""
    _need_card()
    qkv, g = _card_qkv(bp, n, c, dtype, seed=1)
    q, k, v = qkv.split([1, c, c], dim=-1)
    _, stats, ctx = separable_attention_kernel(q, k, v)
    dqkv = torch.full_like(qkv, float("nan"))
    before = separable_attention_bwd_kernel.launches
    separable_attention_bwd_kernel(q, k, v, g, stats, ctx, *dqkv.split([1, c, c], dim=-1))
    torch.cuda.synchronize()
    assert separable_attention_bwd_kernel.launches == before + 1
    ref = torch.cat(separable_attention_backward(q, k, v, g), dim=-1)
    _assert_qkv_grads_close(dqkv, ref, c, dtype)


# (BP, N, C) off the main path's shapes (as chip_smoke.py's SEP_RAGGED): a
# ragged last run of each block (N not a multiple of the blocks a row times a
# step of tokens) with, on a 132-SM H100, 1, 2, 4 and 8 blocks a row (the
# cluster size grows while BP·blocks < 2·SMs and N ≥ 2·blocks·step); N past
# the old 12,256 limit; a block with fewer tokens than a warp step (N 5 at C
# 64: 4 tokens a warp, 32 a step); one token; C 512 (two groups a lane)
RAGGED_SHAPES = [(512, 1000, 128), (200, 1000, 128), (100, 1000, 192), (32, 1000, 128),
                 (32, 12257, 128), (4, 5, 64), (3, 1, 128), (16, 300, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bp,n,c", RAGGED_SHAPES)
def test_kernels_match_plain_at_ragged_token_counts_on_cuda(bp, n, c, dtype):
    """Forward (output and saved statistics) and backward (dq, dk, dv) against
    the plain versions where the rows' runs of tokens do not divide evenly,
    and the same bits on a rerun. Tolerances as at the main path's shapes."""
    _need_card()
    qkv, g = _card_qkv(bp, n, c, dtype, seed=5)
    q, k, v = qkv.split([1, c, c], dim=-1)
    out, stats, ctx = separable_attention_kernel(q, k, v)
    ref = separable_attention_plain(q, k, v)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=1e-2, rtol=2e-2)
    ref_stats, ref_ctx = _stats_plain(q, k)
    torch.testing.assert_close(stats, ref_stats, atol=0, rtol=1e-5)
    torch.testing.assert_close(ctx, ref_ctx, atol=1e-5, rtol=0)
    runs = []
    for _ in range(2):
        dqkv = torch.full_like(qkv, float("nan"))
        separable_attention_bwd_kernel(q, k, v, g, stats, ctx, *dqkv.split([1, c, c], dim=-1))
        runs.append(dqkv)
    torch.cuda.synchronize()
    _assert_qkv_grads_close(runs[0], torch.cat(separable_attention_backward(q, k, v, g), -1),
                            c, dtype)
    assert torch.equal(runs[0], runs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("grad", ["sum", "transposed"])
def test_function_takes_any_upstream_gradient_on_cuda(grad):
    """The Function's backward on the card takes the gradient autograd hands
    over whatever its strides: the expanded ones of ``out.sum().backward()``
    (strides 0) or a transposed one. The gradient of qkv against autograd of
    the plain forward, bfloat16 as on the main path."""
    _need_card()
    bp, n, c = 32, 256, 128
    qkv, _ = _card_qkv(bp, n, c, torch.bfloat16, seed=6)
    w = torch.randn((bp, c, n), device="cuda").to(torch.bfloat16)
    grads = []
    for fn in (lambda x: SeparableAttention.apply(x, c),
               lambda x: separable_attention_plain(*x.split([1, c, c], dim=-1))):
        x = qkv.detach().clone().requires_grad_()
        out = fn(x)
        if grad == "sum":
            out.sum().backward()
        else:  # out's gradient is w transposed: channel stride n
            out.backward(w.transpose(1, 2))
        grads.append(x.grad)
    torch.cuda.synchronize()
    _assert_qkv_grads_close(grads[0], grads[1], c, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("bp,n,c", [(512, 256, 128), (32, 1024, 128), (32, 256, 192)])
def test_backward_kernel_gives_the_same_bits_on_a_rerun(bp, n, c):
    """No atomics: the cluster's partial sums are added in rank order, so two
    runs of the forward and backward give the same bits (DeepLabv3's shapes
    split each row over eight blocks)."""
    _need_card()
    qkv, g = _card_qkv(bp, n, c, torch.bfloat16, seed=2)
    runs = []
    for _ in range(2):
        x = qkv.detach().clone().requires_grad_()
        out = SeparableAttention.apply(x, c)
        out.backward(g)
        runs.append((out, x.grad))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernels_take_separate_contiguous_tensors_as_well_as_qkv_views(dtype):
    """The wrappers take any (row, token) strides with the channel dim
    contiguous: q, k and v as three contiguous tensors (16-byte aligned rows)
    give the same bits as the same values as column views of one qkv (rows one
    element off alignment), forward and backward; a channel stride other
    than 1 is refused."""
    _need_card()
    c = 192
    qkv, g = _card_qkv(32, 256, c, dtype, seed=3)
    views = qkv.split([1, c, c], dim=-1)
    apart = [t.contiguous() for t in views]
    results = []
    for q, k, v in (views, apart):
        out, stats, ctx = separable_attention_kernel(q, k, v)
        grads = [torch.empty(t.shape, dtype=dtype, device="cuda") for t in (q, k, v)]
        separable_attention_bwd_kernel(q, k, v, g, stats, ctx, *grads)
        results.append((out, stats, ctx, *grads))
    torch.cuda.synchronize()
    for a, b in zip(*results):
        assert torch.equal(a, b)
    channels_strided = torch.empty((32, c, 256), dtype=dtype, device="cuda").transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        separable_attention_kernel(apart[0], channels_strided, apart[2])


# (BP, N, C) of MobileViTv2-1.0's spatio-temporal cross calls at 8 clips × 256²
# (batch 8 × patch area 4)
CROSS_SHAPES = [(32, 256, 128), (32, 64, 192), (32, 16, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bp,n,c", CROSS_SHAPES)
def test_cross_path_kernels_match_plain_on_cuda(bp, n, c, dtype):
    """The layer's cross path on the card: q, k from ``x_prev`` and v from
    ``x`` concatenated into one qkv for the kernels, against the layer's plain
    branch (``use_kernel`` off) on the same weights and inputs: the output,
    and the gradients of x, x_prev and the projections (the qkv gradient
    split back through the concatenation). The kernels launch once each."""
    _need_card()
    from cvnets_tpu_torch.layers.linear_attention import LinearSelfAttention
    from cvnets_tpu_torch.options.opts import get_training_arguments

    torch.manual_seed(0)
    layer = LinearSelfAttention(get_training_arguments(args=[]), c).cuda().to(dtype)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x, x_prev, w = (torch.randn((bp // 4, 4, n, c), generator=gen, device="cuda").to(dtype)
                    for _ in range(3))
    results = []
    for use_kernel in (True, False):
        layer.use_kernel = use_kernel
        layer.zero_grad()
        a, b = (t.detach().clone().requires_grad_() for t in (x, x_prev))
        before = (separable_attention_kernel.launches, separable_attention_bwd_kernel.launches)
        out = layer(a, b)
        out.backward(w)
        torch.cuda.synchronize()
        launched = (separable_attention_kernel.launches - before[0],
                    separable_attention_bwd_kernel.launches - before[1])
        assert launched == ((1, 1) if use_kernel else (0, 0))
        results.append([out.detach(), a.grad, b.grad] +
                       [p.grad.clone() for p in layer.parameters()])
    for i, (got, ref) in enumerate(zip(*results)):
        assert bool(torch.isfinite(got).all()), i
        scale = max(ref.float().abs().max().item(), 1.0)
        tol = 1e-4 * scale if dtype == torch.float32 else 2e-2 * scale
        err = (got.float() - ref.float()).abs().max().item()
        assert err <= tol, f"tensor {i}: max abs err {err} > {tol}"
