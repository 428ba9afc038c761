"""The port's fused multi-head attention against the JAX package: the autograd
Function on CPU tensors (plain forward and plain backward) against the JAX
``fused_mha_attention`` run through its Pallas kernels in interpret mode and
through its off-TPU reference, forward and the grads of q, k and v, and for
S > 512 against the long-sequence ``attn_core_long`` in interpret mode; the
plain row statistics against the JAX long forward's lse and float64; and — on a
CUDA card only — the hand-written kernels against the plain versions at the
ViT shapes and at S = 640, 1024 and 4096, the forward's statistics with them.

JAX is imported inside the tests that use it, so that on a machine with a card
and no JAX the kernel tests run alone:
``python -m pytest --noconftest -m cuda tests/test_torch_mha_attention.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cvnets_tpu_torch.ops.mha_attention import (
    MHAAttention,
    fused_attention_eligible,
    fused_mha_attention,
    mha_attention_backward_plain,
    mha_attention_plain,
    mha_attention_stats_plain,
    mha_bwd_kernel,
    mha_fwd_kernel,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

# float32 on both sides, same formula; the JAX tests of these kernels use the
# same bounds (tests/test_pallas_kernels.py:132-141)
FWD_ATOL = 1e-5
GRAD_ATOL = 1e-4

# (B, S, H, D): the JAX interpret-mode shape (odd S, 64-wide heads) and S = 1
CPU_CASES = [(2, 53, 3, 64), (2, 1, 3, 64)]


def _inputs(b, s, h, d, masked, seed=0):
    """q (already scaled), k, v, the loss weights w and an additive key mask in
    which batch element 0 has every key masked (its rows attend uniformly)."""
    rng = np.random.default_rng(seed)
    e = h * d
    q, k = ((rng.standard_normal((b, s, e)) * 0.3).astype(np.float32) for _ in range(2))
    v, w = (rng.standard_normal((b, s, e)).astype(np.float32) for _ in range(2))
    mask = None
    if masked:
        mask = np.where(rng.random((b, s)) < 0.2, -1e30, 0.0).astype(np.float32)
        mask[0] = -1e30
    return q, k, v, w, mask


def _port(q, k, v, w, mask, heads):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    out = fused_mha_attention(tq, tk, tv, heads, tm)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


def _jax(q, k, v, w, mask, heads, interpret):
    import jax
    import jax.numpy as jnp

    import cvnets_tpu.ops.pallas.mha_attn as M

    km = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v):
        return jnp.sum(M.fused_mha_attention(q, k, v, heads, km) * w)

    try:
        M._INTERPRET = interpret
        args = tuple(map(jnp.asarray, (q, k, v)))
        out = M.fused_mha_attention(*args, heads, km)
        grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    finally:
        M._INTERPRET = False
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("interpret", [True, False], ids=["pallas_interpret", "reference"])
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "key_mask"])
@pytest.mark.parametrize("b,s,h,d", CPU_CASES)
def test_function_matches_jax(b, s, h, d, masked, interpret):
    q, k, v, w, mask = _inputs(b, s, h, d, masked)
    ref, ref_grads = _jax(q, k, v, w, mask, h, interpret)
    out, grads = _port(q, k, v, w, mask, h)
    np.testing.assert_allclose(out, ref, atol=FWD_ATOL, rtol=0)
    for name, got, want in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_fully_masked_keys_attend_uniformly():
    """With every key at -1e30 each logit is -1e30 exactly in float32, so the
    softmax is uniform and the output is the mean of v, as in JAX."""
    q, k, v, _, mask = _inputs(2, 9, 2, 16, masked=True, seed=3)
    out = mha_attention_plain(*map(torch.from_numpy, (q, k, v)), 2, torch.from_numpy(mask))
    want = np.broadcast_to(v[0].mean(axis=0), v[0].shape)
    np.testing.assert_allclose(out[0].numpy(), want, atol=FWD_ATOL, rtol=0)


def test_plain_backward_matches_autograd_of_plain():
    """The hand-written VJP against torch autograd through the plain forward, on
    q, k, v that are column slices of one qkv tensor as the layer makes them."""
    rng = np.random.default_rng(4)
    h, d = 2, 16
    qkv = torch.from_numpy(rng.standard_normal((3, 11, 3 * h * d)).astype(np.float32))
    mask = torch.from_numpy(np.where(rng.random((3, 11)) < 0.3, -1e30, 0.0).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 11, h * d)).astype(np.float32))
    grads = []
    for fn in (MHAAttention.apply, mha_attention_plain):
        x = qkv.clone().requires_grad_()
        (fn(*x.chunk(3, dim=-1), h, mask) * w).sum().backward()
        grads.append(x.grad)
    torch.testing.assert_close(grads[0], grads[1], atol=1e-5, rtol=0)
    # and the function itself on the same residuals
    q, k, v = qkv.chunk(3, dim=-1)
    out = mha_attention_plain(q, k, v, h, mask)
    dq, dk, dv = mha_attention_backward_plain(q, k, v, mask, out, w, h)
    torch.testing.assert_close(torch.cat([dq, dk, dv], dim=-1), grads[1], atol=1e-5, rtol=0)


@pytest.mark.parametrize("seq,embed", [(197, 768), (512, 1024), (513, 768), (1024, 768),
                                       (1000, 64), (4096, 1024), (8192, 256), (64, 2048)])
def test_eligibility_is_the_jax_rule(seq, embed):
    """On the CPU the JAX rule; on the card (``on_cuda``) any S at H·D ≤ 1024,
    since the CUDA kernels tile a ragged S (S = 1000 and 513 included)."""
    from cvnets_tpu.ops.pallas.mha_attn import fused_attention_eligible as jax_rule
    from cvnets_tpu.ops.pallas.mha_attn_long import long_attention_eligible

    heads = max(1, embed // 64)  # D = 64: the head-dim test passes, the JAX rule decides
    assert fused_attention_eligible(seq, embed, heads) == jax_rule(seq, embed)
    if seq > 512:  # fused_mha_attention's second test, at the input's itemsize
        for itemsize in (2, 4):
            assert (fused_attention_eligible(seq, embed, heads, itemsize)
                    == long_attention_eligible(seq, embed, itemsize))
    for itemsize in (2, 4):
        assert fused_attention_eligible(seq, embed, heads, itemsize,
                                        on_cuda=True) == (embed <= 1024)


@pytest.mark.parametrize("seq,embed,heads,ok", [
    (197, 768, 12, True), (1024, 768, 12, True),    # ViT-B/16 at 224² and 512²
    (197, 768, 16, False), (1024, 768, 16, False),  # D = 48
    (197, 768, 8, False),                           # D = 96
    (197, 1024, 8, True), (197, 64, 4, True),       # D = 128 and 16
    (197, 768, 7, False),                           # 7 heads do not divide 768
])
def test_eligibility_needs_a_head_dim_the_kernels_take(seq, embed, heads, ok):
    """The JAX rule passes every one of these shapes; the kernels take
    D in {16, 32, 64, 128} only, so the rest take the einsum route."""
    assert fused_attention_eligible(seq, embed, heads) is ok


@pytest.mark.parametrize("embed,heads", [(192, 4), (256, 4)], ids=["d48", "d64"])
def test_layer_sends_a_head_dim_the_kernels_lack_to_the_einsum_route(embed, heads,
                                                                     monkeypatch):
    """With ``fused_mha_attention`` patched to raise, a MultiHeadAttention with
    D = 48 still runs (the einsum route, the same output as with
    ``use_kernel`` off) and one with D = 64 reaches the patched entry."""
    import argparse

    from cvnets_tpu_torch.layers import multi_head_attention
    from cvnets_tpu_torch.layers.multi_head_attention import MultiHeadAttention

    def refuse(*args):
        raise AssertionError("fused_mha_attention was called")

    layer = MultiHeadAttention(argparse.Namespace(), embed, heads).eval()
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((2, 17, embed))
                         .astype(np.float32))
    monkeypatch.setattr(multi_head_attention, "fused_mha_attention", refuse)
    with torch.no_grad():
        if embed // heads == 64:
            with pytest.raises(AssertionError, match="fused_mha_attention"):
                layer(x)
            return
        out = layer(x)
        layer.use_kernel = False
        torch.testing.assert_close(out, layer(x), atol=0, rtol=0)


def _jax_long(q, k, v, w, mask, heads):
    """``attn_core_long`` through its Pallas kernels in interpret mode."""
    import jax
    import jax.numpy as jnp

    import cvnets_tpu.ops.pallas.mha_attn as M
    from cvnets_tpu.ops.pallas.mha_attn_long import attn_core_long

    b, s, _ = q.shape
    m = (jnp.zeros((b, 1, s), jnp.float32) if mask is None
         else jnp.asarray(mask).reshape(b, 1, s))
    args = tuple(map(jnp.asarray, (q, k, v)))
    try:
        M._INTERPRET = True
        out = attn_core_long(*args, m, heads)
        grads = jax.grad(lambda *t: jnp.sum(attn_core_long(*t, m, heads) * w),
                         argnums=(0, 1, 2))(*args)
    finally:
        M._INTERPRET = False
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "key_mask"])
@pytest.mark.parametrize("s", [384, 640])
def test_function_matches_jax_long_kernels(s, masked):
    """S = 384 (3 kv blocks of 128) and 640 (5 of 128, the JAX dispatch test's
    S), B = 2, H = 2, D = 64; keys masked at random but no row fully masked."""
    q, k, v, w, mask = _inputs(2, s, 2, 64, masked)
    if mask is not None:
        mask[0] = np.where(np.random.default_rng(1).random(s) < 0.2, -1e30, 0.0)
    ref, ref_grads = _jax_long(q, k, v, w, mask, 2)
    out, grads = _port(q, k, v, w, mask, 2)
    np.testing.assert_allclose(out, ref, atol=FWD_ATOL, rtol=0)
    for name, got, want in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_ATOL, err_msg=name)


def test_fully_masked_row_follows_the_einsum_reference_not_the_long_kernel():
    """Batch element 0 has every key at -1e30. The port's grads equal the JAX
    einsum reference's there. The JAX long kernel saves lse = m + log(S), which
    rounds to m = -1e30 in float32, so its backward recomputes p = 1 and not
    1/S: its dv for that element comes out S times the reference's (recorded
    here; the forward, uniform attention, agrees)."""
    s = 384
    q, k, v, w, mask = _inputs(2, s, 2, 64, masked=True, seed=5)
    ref, ref_grads = _jax(q, k, v, w, mask, 2, interpret=False)
    out, grads = _port(q, k, v, w, mask, 2)
    np.testing.assert_allclose(out, ref, atol=FWD_ATOL, rtol=0)
    for name, got, want in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_ATOL, err_msg=name)
    long_out, long_grads = _jax_long(q, k, v, w, mask, 2)
    np.testing.assert_allclose(long_out[0], ref[0], atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(long_grads[2][0], s * ref_grads[2][0], rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(long_grads[2][1], ref_grads[2][1], atol=GRAD_ATOL,
                               rtol=GRAD_ATOL)


def _jax_long_lse(q, k, v, mask, heads):
    """``mha_attn_long._pallas_fwd`` in interpret mode: its lse = m + log(l),
    (B, S, H)."""
    import jax.numpy as jnp

    import cvnets_tpu.ops.pallas.mha_attn as M
    from cvnets_tpu.ops.pallas.mha_attn_long import _pallas_fwd

    b, s, _ = q.shape
    m = (jnp.zeros((b, 1, s), jnp.float32) if mask is None
         else jnp.asarray(mask).reshape(b, 1, s))
    try:
        M._INTERPRET = True
        _, lse = _pallas_fwd(*map(jnp.asarray, (q, k, v)), m, heads)
    finally:
        M._INTERPRET = False
    return np.asarray(lse)


def _stats(q, k, v, mask, heads):
    return mha_attention_stats_plain(*map(torch.from_numpy, (q, k, v)), heads,
                                     None if mask is None else torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "key_mask"])
def test_stats_plain_matches_the_jax_long_kernels_lse(masked):
    """S = 384 (3 kv blocks of 128), B = 2, H = 2, D = 64: max + log-sum of
    the plain statistics against the lse that the JAX long forward saves, on
    rows that are not fully masked (there the JAX lse rounds to -1e30 and
    loses the log(S); see the test below). float32 on both sides, the blocked
    online softmax against one pass: 1e-5, as FWD_ATOL."""
    h = 2
    q, k, v, _, mask = _inputs(2, 384, h, 64, masked, seed=7)
    if mask is not None:
        mask[0] = np.where(np.random.default_rng(2).random(384) < 0.2, -1e30, 0.0)
        mask[1, :10] = -1e30
    lse = _jax_long_lse(q, k, v, mask, h)                 # (B, S, H)
    stats = _stats(q, k, v, mask, h)                      # (2, B, H, S)
    got = (stats[0] + stats[1]).transpose(0, 2, 1)
    np.testing.assert_allclose(got, lse, atol=FWD_ATOL, rtol=FWD_ATOL)


@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "key_mask"])
def test_stats_plain_matches_float64(masked):
    """The pair against the same formula in float64 numpy on the same float32
    inputs, batch element 0 fully masked where masked: float32 logits and
    sums, so 1e-5 relative (absolute 1e-5 for a log-sum near 0)."""
    h, d = 3, 32
    q, k, v, _, mask = _inputs(2, 53, h, d, masked, seed=8)
    qh, kh = (x.astype(np.float64).reshape(2, 53, h, d) for x in (q, k))
    logits = np.einsum("bqhd,bkhd->bhqk", qh, kh)
    if mask is not None:
        logits = logits + mask.astype(np.float64)[:, None, None, :]
    m = logits.max(axis=-1)
    want = np.stack([m, np.log(np.exp(logits - m[..., None]).sum(axis=-1))])
    np.testing.assert_allclose(_stats(q, k, v, mask, h), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s", [9, 384])
def test_stats_plain_of_a_fully_masked_row_are_the_mask_and_log_s(s):
    """Every key of batch element 0 at -1e30: each logit is -1e30 exactly in
    float32, so the max is -1e30 and the log-sum log(S) exactly, the pair that
    keeps the uniform row's 1/S for the backward."""
    q, k, v, _, mask = _inputs(2, s, 2, 16, masked=True, seed=9)
    stats = _stats(q, k, v, mask, 2)
    assert (stats[0, 0] == np.float32(-1e30)).all()
    assert (stats[1, 0] == torch.log(torch.tensor(float(s))).item()).all()


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, w, mask = _inputs(2, 8, 2, 16, masked=False)
    q, k, v = map(torch.from_numpy, (q, k, v))
    fwd, bwd = mha_fwd_kernel.launches, mha_bwd_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        mha_fwd_kernel(q, k, v, 2)
    with pytest.raises(ValueError, match="CUDA"):
        mha_bwd_kernel(q, k, v, None, q, q, torch.zeros(2, 2, 2, 8), 2)
    assert (mha_fwd_kernel.launches, mha_bwd_kernel.launches) == (fwd, bwd)


def test_long_sequences_off_the_cpu_raise_instead_of_running_plain():
    """Off the CPU there is no plain version: an S > 512, blocked by the
    long-sequence rule or ragged (4,097), reaches the kernel wrapper, which
    asks for a CUDA device (a meta tensor stands in for a card), and an
    H·D past the kernels' 1,024 raises and names the limit."""
    for s in (1024, 4097):
        q = torch.empty((1, s, 64), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            fused_mha_attention(q, q, q, 4)
    q = torch.empty((1, 4097, 2048), device="meta")
    with pytest.raises(NotImplementedError, match="H·D ≤ 1024"):
        fused_mha_attention(q, q, q, 16)


# ---------------------------------------------------------------- on a card

# (B, S, H, D): ViT-B/16 at 224² (batch cut to 16 for the test's time), the
# micro ViT's D = 16, the single-tile kernel's longest sequence, and the
# long-sequence range: ViT-B/16 at 512² without the CLS token, ViT-B at 1024²
# without it, and an S of 10 key tiles at D = 16; then the backward's shapes:
# ViT-B/16 at 224² at its batch, a ragged S at D = 16 (three 128-row blocks,
# the last of 77 rows), S = 640 at D = 32, and D = 128 (64-row blocks)
CUDA_CASES = [(16, 197, 12, 64), (16, 17, 4, 16), (4, 512, 12, 64),
              (32, 1024, 12, 64), (2, 4096, 12, 64), (4, 640, 4, 16),
              (128, 197, 12, 64), (4, 333, 4, 16), (2, 640, 8, 32), (2, 256, 6, 128)]


def _cuda_inputs(b, s, h, d, dtype, masked, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    e = h * d
    qkv = torch.randn((b, s, 3 * e), generator=g, device="cuda").to(dtype)
    q, k, v = qkv.chunk(3, dim=-1)  # column slices, as MultiHeadAttention makes them
    q = q * d ** -0.5
    mask = None
    if masked:
        mask = torch.where(torch.rand((b, s), generator=g, device="cuda") < 0.2, -1e30, 0.0)
        mask[0] = -1e30
    dout = torch.randn((b, s, e), generator=g, device="cuda").to(dtype)
    return q, k, v, mask, dout


def _tol(ref, dtype):
    # float32: the same float32 math in another order. bfloat16: P and dS are
    # rounded to bf16 before their products (2^-9 relative each) and the
    # outputs to bf16, against a float32 reference from the same bf16 inputs.
    return 1e-5 if dtype == torch.float32 else 2e-2 * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "key_mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,d", CUDA_CASES)
def test_kernels_match_plain_on_cuda(b, s, h, d, dtype, masked):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    q, k, v, mask, dout = _cuda_inputs(b, s, h, d, dtype, masked)
    launches = mha_fwd_kernel.launches, mha_bwd_kernel.launches
    out, stats = mha_fwd_kernel(q, k, v, h, mask)
    dq, dk, dv = mha_bwd_kernel(q, k, v, mask, out, dout, stats, h)
    torch.cuda.synchronize()
    assert (mha_fwd_kernel.launches, mha_bwd_kernel.launches) == (launches[0] + 1,
                                                                  launches[1] + 1)
    ref = mha_attention_plain(q, k, v, h, mask)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(ref, dtype), rtol=0)
    # the backward from the reference output, as JAX's VJP takes it
    ref_grads = mha_attention_backward_plain(q, k, v, mask, ref, dout, h)
    for name, got, want in zip("qkv", (dq, dk, dv), ref_grads):
        torch.testing.assert_close(got.float(), want.float(), atol=_tol(want, dtype),
                                   rtol=0, msg=lambda m: f"d{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "key_mask"])
@pytest.mark.parametrize("b,s,h,d", [(32, 1024, 12, 64), (128, 197, 12, 64)])
def test_backward_gives_the_same_bits_on_every_call(b, s, h, d, masked):
    """No atomics: dq is summed over key tiles and dk, dv over query tiles in a
    fixed order, so two calls on the same inputs agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    q, k, v, mask, dout = _cuda_inputs(b, s, h, d, torch.bfloat16, masked)
    out, stats = mha_fwd_kernel(q, k, v, h, mask)
    first = mha_bwd_kernel(q, k, v, mask, out, dout, stats, h)
    for _ in range(2):
        again = mha_bwd_kernel(q, k, v, mask, out, dout, stats, h)
        for name, x, y in zip("qkv", first, again):
            assert torch.equal(x, y), f"d{name}"


@pytest.mark.cuda
def test_function_on_cuda_runs_the_kernels_and_never_the_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    q, k, v, _, dout = _cuda_inputs(2, 197, 12, 64, torch.bfloat16, masked=False)
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    launches = mha_fwd_kernel.launches, mha_bwd_kernel.launches
    fused_mha_attention(q, k, v, 12).backward(dout)
    torch.cuda.synchronize()
    assert (mha_fwd_kernel.launches, mha_bwd_kernel.launches) == (launches[0] + 1,
                                                                  launches[1] + 1)
    # S = 1024 takes the same kernels, and so does S = 4097, which neither
    # TPU kernel tiles (the CUDA tiles cover a ragged S)
    fused_mha_attention(*(torch.zeros((1, 1024, 768), device="cuda"),) * 3, 12)
    torch.cuda.synchronize()
    assert mha_fwd_kernel.launches == launches[0] + 2
    fused_mha_attention(*(torch.zeros((1, 4097, 768), device="cuda"),) * 3, 12)
    torch.cuda.synchronize()
    assert mha_fwd_kernel.launches == launches[0] + 3


@pytest.mark.cuda
def test_kernels_match_plain_at_vit_b_1024_with_its_cls_token_on_cuda():
    """ViT-B/16 at 1024² with the CLS token: S = 4,097 = 17 · 241, which no
    128-row block divides (the last tile holds one row), at batch 2 in bf16:
    output, statistics, dq, dk and dv against the plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    b, s, h, d = 2, 4097, 12, 64
    assert fused_attention_eligible(s, h * d, h, 2, on_cuda=True)
    q, k, v, mask, dout = _cuda_inputs(b, s, h, d, torch.bfloat16, masked=False)
    out, stats = _check_forward(q, k, v, h, mask)
    grads = mha_bwd_kernel(q, k, v, mask, out, dout, stats, h)
    ref = mha_attention_plain(q, k, v, h, mask)
    for name, got, want in zip("qkv", grads,
                               mha_attention_backward_plain(q, k, v, mask, ref, dout, h)):
        torch.testing.assert_close(got.float(), want.float(), atol=_tol(want, torch.bfloat16),
                                   rtol=0, msg=lambda m: f"d{name}: {m}")


# the new forward's shapes: ViT-B/16 at 224² and at 512² without the CLS
# token, a ragged S at D = 16 (three 128-row blocks, the last of 77 rows),
# S = 640 at D = 32 and D = 128 (64-row blocks)
FWD_CUDA_CASES = [(128, 197, 12, 64), (32, 1024, 12, 64), (4, 333, 4, 16), (2, 640, 8, 32),
                  (2, 256, 6, 128)]


def _check_forward(q, k, v, h, mask):
    out, stats = mha_fwd_kernel(q, k, v, h, mask)
    torch.cuda.synchronize()
    ref = mha_attention_plain(q, k, v, h, mask)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(ref, q.dtype), rtol=0)
    # the statistics are float32 sums of float32 logits of the same inputs:
    # 1e-2 relative (to max(|ref|, 1)) in bf16, as chip_smoke.py holds them
    ref_stats = mha_attention_stats_plain(q, k, v, h, mask)
    err = ((stats - ref_stats).abs() / ref_stats.abs().clamp(min=1.0)).max().item()
    assert err <= (1e-5 if q.dtype == torch.float32 else 1e-2), err
    return out, stats


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "key_mask"])
@pytest.mark.parametrize("b,s,h,d", FWD_CUDA_CASES)
def test_forward_output_and_stats_match_plain_on_cuda(b, s, h, d, masked):
    """q, k, v column slices of one qkv tensor; with the mask, batch element
    0 fully masked (its statistics -1e30 and log S)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    q, k, v, mask, _ = _cuda_inputs(b, s, h, d, torch.bfloat16, masked)
    _check_forward(q, k, v, h, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64])
def test_forward_on_an_unaligned_stride_takes_the_scalar_path(d):
    """A qkv tensor one column wider than 3·H·D: its token stride is odd, so
    no 16-byte copy can be used and the forward loads element by element."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    b, s, h = 2, 200, 4
    e = h * d
    g = torch.Generator(device="cuda").manual_seed(3)
    qkv = torch.randn((b, s, 3 * e + 1), generator=g, device="cuda").to(torch.bfloat16)
    q, k, v = qkv[..., :e] * d ** -0.5, qkv[..., e:2 * e], qkv[..., 2 * e:3 * e]
    assert k.stride(1) % 8 != 0
    mask = torch.where(torch.rand((b, s), generator=g, device="cuda") < 0.2, -1e30, 0.0)
    mask[0] = -1e30
    _check_forward(q, k, v, h, mask)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d", [(128, 197, 12, 64), (32, 1024, 12, 64)])
def test_forward_gives_the_same_bits_on_every_call(b, s, h, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    q, k, v, mask, _ = _cuda_inputs(b, s, h, d, torch.bfloat16, masked=True)
    out, stats = mha_fwd_kernel(q, k, v, h, mask)
    again = mha_fwd_kernel(q, k, v, h, mask)
    assert torch.equal(out, again[0]) and torch.equal(stats, again[1])


# ByteFormer-Tiny's windows: (B·n_windows, window, 3, 64) at batch 48, the JPEG
# recipe's first stage (window 128) and the wav recipe's (window 32)
BYTEFORMER_CUDA_CASES = [(384, 128, 3, 64), (6144, 32, 3, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "window_masked"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,s,h,d", BYTEFORMER_CUDA_CASES)
def test_kernels_match_plain_at_byteformer_windows_on_cuda(b, s, h, d, dtype, masked):
    """Output, statistics, dq, dk and dv at ByteFormer's shapes; masked, window 0
    is padding whole (``--model.classification.byteformer.mask-windowed-attn``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    q, k, v, mask, dout = _cuda_inputs(b, s, h, d, dtype, masked)
    out, stats = mha_fwd_kernel(q, k, v, h, mask)
    grads = mha_bwd_kernel(q, k, v, mask, out, dout, stats, h)
    ref = mha_attention_plain(q, k, v, h, mask)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(ref, dtype), rtol=0)
    ref_stats = mha_attention_stats_plain(q, k, v, h, mask)
    rel = ((stats - ref_stats).abs() / ref_stats.abs().clamp(min=1.0)).max().item()
    assert rel <= (1e-5 if dtype == torch.float32 else 1e-2)
    ref_grads = mha_attention_backward_plain(q, k, v, mask, ref, dout, h)
    for name, got, want in zip("qkv", grads, ref_grads):
        # float32: dq sums 32-128 products of a few units in another order, up
        # to ~9e-6 off at S = 32 (chip_smoke.py's _mha_case holds grads at 1e-4)
        tol = 1e-4 if dtype == torch.float32 else _tol(want, dtype)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0,
                                   msg=lambda m: f"d{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["no_mask", "key_mask"])
def test_a_batch_past_the_grid_limit_runs_in_slices_on_cuda(masked):
    """B > 65,535 (the grid's z limit): the wrappers launch each kernel once a
    slice of at most 65,535 and the result is the plain version's."""
    from cvnets_tpu_torch.ops.mha_attention import MAX_GRID_BATCH

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    b, s, h, d = MAX_GRID_BATCH + 37, 32, 1, 16
    q, k, v, mask, dout = _cuda_inputs(b, s, h, d, torch.float32, masked)
    if masked:
        mask[-1] = -1e30  # a fully masked row in the second slice too
    launches = mha_fwd_kernel.launches, mha_bwd_kernel.launches
    out, stats = mha_fwd_kernel(q, k, v, h, mask)
    grads = mha_bwd_kernel(q, k, v, mask, out, dout, stats, h)
    torch.cuda.synchronize()
    assert (mha_fwd_kernel.launches - launches[0], mha_bwd_kernel.launches - launches[1]) \
        == (2, 2)
    assert tuple(stats.shape) == (2, b, h, s)
    ref = mha_attention_plain(q, k, v, h, mask)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(stats, mha_attention_stats_plain(q, k, v, h, mask),
                               atol=1e-5, rtol=1e-5)
    for name, got, want in zip("qkv", grads,
                               mha_attention_backward_plain(q, k, v, mask, ref, dout, h)):
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0, msg=lambda m: f"d{name}: {m}")
