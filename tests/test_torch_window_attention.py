"""The port's window attention against the JAX package: the autograd Function on
CPU tensors (plain forward and plain backward) against the JAX
``fused_window_attention`` run through its Pallas kernels in interpret mode and
against the einsum math of its reference, forward and the grads of q, k, v and
the bias, shifted and not, at the shapes of the JAX test (B = 3, nW = 4, H = 3,
D = 32) at windows of S = 16, 49 and 64 tokens; the plain VJP against
autograd; the wrappers' checks; and — on a CUDA card only — the hand-written
kernels against the plain versions at the four Swin-T stage shapes (batch cut),
the forward and the backward at S = 16 and 64 and every head dim, at image
counts that end a block's prefetch early and on the scalar-load path, with the
forward's output and dbias the same bit for bit over repeated runs.

JAX is imported inside the tests that use it, so that on a machine with a card
and no JAX the kernel tests run alone:
``python -m pytest --noconftest -m cuda tests/test_torch_window_attention.py``."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cvnets_tpu_torch.ops.window_attention import (
    WindowAttentionFunction,
    _bwd_chunk,
    _fwd_chunk,
    fused_window_attention,
    window_attention_backward_plain,
    window_attention_eligible,
    window_attention_plain,
    window_bwd_kernel,
    window_fwd_kernel,
)

torch.set_float32_matmul_precision("highest")  # as tests/conftest.py pins JAX

# float32 on both sides, same formula; the JAX test of these kernels states the
# same bounds (tests/test_pallas_kernels.py:379-387)
FWD_ATOL = 1e-5
GRAD_ATOL = GRAD_RTOL = 1e-4


def _inputs(b=3, nw=4, s=49, h=3, d=32, seed=0):
    """As the JAX test's ``_win_qkv``: q (already scaled), k, v, the (H, S, S)
    bias and a (nW, S, S) mask with -100 at random places."""
    rng = np.random.default_rng(seed)
    e, bnw = h * d, b * nw
    q = (rng.standard_normal((bnw, s, e)) * 0.3).astype(np.float32)
    k = (rng.standard_normal((bnw, s, e)) * 0.3).astype(np.float32)
    v = rng.standard_normal((bnw, s, e)).astype(np.float32)
    bias = (rng.standard_normal((h, s, s)) * 0.5).astype(np.float32)
    mask = np.where(rng.random((nw, s, s)) < 0.3, -100.0, 0.0).astype(np.float32)
    return q, k, v, bias, mask


def _port(q, k, v, bias, mask, heads):
    """Output and the grads of sum(out²) (the JAX test's loss) through the
    Function on CPU tensors."""
    tq, tk, tv, tb = (torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias))
    out = fused_window_attention(tq, tk, tv, heads, tb,
                                 None if mask is None else torch.from_numpy(mask))
    (out ** 2).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv, tb)]


def _jax(q, k, v, bias, mask, heads, interpret):
    """The JAX kernels in interpret mode, or the einsum reference of the JAX
    test (``_win_gold``) under jax.grad."""
    import jax
    import jax.numpy as jnp

    import cvnets_tpu.ops.pallas.mha_attn as M
    from cvnets_tpu.ops.pallas.window_attn import fused_window_attention as jax_fused

    m = None if mask is None else jnp.asarray(mask)

    def gold(q, k, v, bias):
        bnw, s, e = q.shape
        qh, kh, vh = (t.reshape(bnw, s, heads, e // heads) for t in (q, k, v))
        logits = jnp.einsum("bnhd,bmhd->bhnm", qh, kh) + bias[None]
        if m is not None:
            nw = m.shape[0]
            logits = (logits.reshape(bnw // nw, nw, heads, s, s)
                      + m[None, :, None]).reshape(bnw, heads, s, s)
        p = jax.nn.softmax(logits, axis=-1)
        return jnp.einsum("bhnm,bmhd->bnhd", p, vh).reshape(bnw, s, e)

    fn = (lambda q, k, v, b: jax_fused(q, k, v, heads, b, m)) if interpret else gold
    args = tuple(map(jnp.asarray, (q, k, v, bias)))
    try:
        M._INTERPRET = interpret
        out = fn(*args)
        grads = jax.grad(lambda *t: jnp.sum(fn(*t) ** 2), argnums=(0, 1, 2, 3))(*args)
    finally:
        M._INTERPRET = False
    return np.asarray(out), [np.asarray(g) for g in grads]


# (S, id prefix): Swin's own window 7 is the case without a prefix
_WINDOWS = [(16, "window4-"), (49, ""), (64, "window8-")]


@pytest.mark.parametrize("s,shifted,interpret", [
    pytest.param(s, shifted, interpret, id=f"{prefix}{shift_id}-{route_id}")
    for s, prefix in _WINDOWS
    for shifted, shift_id in ((True, "shift_mask"), (False, "no_mask"))
    for interpret, route_id in ((True, "pallas_interpret"), (False, "einsum"))])
def test_function_matches_jax(s, shifted, interpret):
    """At windows of 4, 7 and 8 tokens a side: S = 16, Swin's 49 (a 64-row
    tile with 15 padded rows) and 64 (no padded row), the shapes the card
    tests give the kernels."""
    q, k, v, bias, mask = _inputs(s=s)
    mask = mask if shifted else None
    ref, ref_grads = _jax(q, k, v, bias, mask, 3, interpret)
    out, grads = _port(q, k, v, bias, mask, 3)
    np.testing.assert_allclose(out, ref, atol=FWD_ATOL, rtol=0)
    for name, got, want in zip(("q", "k", "v", "bias"), grads, ref_grads):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=name)


def test_plain_backward_matches_autograd_of_plain():
    """The hand-written VJP (dbias included) against torch autograd through the
    plain forward, on q, k, v that are column thirds of one qkv tensor, as
    WindowAttention makes them."""
    rng = np.random.default_rng(4)
    h, d, nw = 2, 8, 3
    qkv = torch.from_numpy(rng.standard_normal((2 * nw, 16, 3 * h * d)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal((h, 16, 16)).astype(np.float32))
    mask = torch.from_numpy(np.where(rng.random((nw, 16, 16)) < 0.3, -100.0, 0.0)
                            .astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2 * nw, 16, h * d)).astype(np.float32))
    grads = []
    for fn in (WindowAttentionFunction.apply, window_attention_plain):
        x, b = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
        (fn(*x.chunk(3, dim=-1), h, b, mask) * w).sum().backward()
        grads.append((x.grad, b.grad))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    q, k, v = qkv.chunk(3, dim=-1)
    out = window_attention_plain(q, k, v, h, bias, mask)
    dq, dk, dv, dbias = window_attention_backward_plain(q, k, v, h, bias, mask, out, w)
    torch.testing.assert_close(torch.cat([dq, dk, dv], dim=-1), grads[1][0], atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(dbias, grads[1][1], atol=1e-5, rtol=1e-5)


def test_eligibility_is_the_jax_shape_rule_without_its_tpu_switch(monkeypatch):
    """H·D ≤ 1024 as in the JAX shape rule (window_attn.py:49-50), but S ≤ 64,
    not 512: the kernels tile one window of at most 64 tokens. The TPU-only
    environment switch that keeps the JAX kernel off by default is not read."""
    monkeypatch.setenv("CVNETS_TPU_FORCE_WINDOW_KERNEL", "0")
    assert window_attention_eligible(49, 96, 3) and window_attention_eligible(64, 1024, 16)
    assert not window_attention_eligible(65, 96, 3)
    assert not window_attention_eligible(512, 1024, 16)
    assert not window_attention_eligible(49, 2048, 32)


@pytest.mark.parametrize("seq,embed,heads,ok", [
    (49, 96, 3, True), (49, 768, 24, True),   # Swin-T's stages 1 and 4 (D = 32)
    (49, 48, 3, True),                        # D = 16
    (81, 96, 3, False),                       # window 9
    (49, 144, 3, False), (49, 384, 3, False),  # D = 48 and 128
    (49, 96, 5, False),                       # 5 heads do not divide 96
])
def test_eligibility_matches_what_the_kernels_take(seq, embed, heads, ok):
    """S ≤ 64, H·D ≤ 1024, H | H·D and D in {16, 32, 64}: the shapes the
    wrappers' checks let through, and no other."""
    assert window_attention_eligible(seq, embed, heads) is ok


def test_micro_swin_at_window_9_takes_the_einsum_route_and_matches_jax(monkeypatch):
    """``--model.classification.swin.window-size 9`` gives windows of 81 tokens,
    which the kernels do not tile: with the fused entry patched to raise, the
    micro Swin at D = 16 runs every block on the einsum route, and its eval
    logits at 112 px (maps 28/14/7/4 padded to 36/18/9/9; stages 1-2 shift by
    4) match the JAX model's (f32, the sums in another order: 1e-4). At window
    7 the same model reaches the patched entry."""
    import sys

    import jax.numpy as jnp

    sys.path.insert(0, "tests")
    from torch_port_helpers import (
        SWIN_MICRO_ARGS,
        both_opts,
        micro_swin_modes,
        nchw,
        perturbed_variables,
        port_model_from,
    )

    from cvnets_tpu.models import get_model as jax_model
    from cvnets_tpu_torch.models import get_model
    from cvnets_tpu_torch.modules import swin_transformer_block

    def refuse(*args):
        raise AssertionError("fused_window_attention was called")

    x = np.random.default_rng(9).standard_normal((2, 112, 112, 3)).astype(np.float32)
    with micro_swin_modes():
        opts_jax, opts_torch = both_opts(
            SWIN_MICRO_ARGS + ["--model.classification.swin.window-size", "9"])
        jmodel = jax_model(opts_jax)
        variables = perturbed_variables(jmodel, x)
        model = port_model_from(opts_torch, variables).eval()
        monkeypatch.setattr(swin_transformer_block, "fused_window_attention", refuse)
        with torch.no_grad():
            out = model(nchw(x))
        ref = jmodel.apply(variables, jnp.asarray(x), training=False)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
        seven = get_model(both_opts(SWIN_MICRO_ARGS)[1], device="cpu").eval()
        with torch.no_grad(), pytest.raises(AssertionError, match="fused_window_attention"):
            seven(nchw(x))


@pytest.mark.parametrize("n_img,nw,heads,d,chunk", [
    (128, 64, 3, 32, 64), (128, 16, 6, 32, 32), (128, 4, 12, 32, 16), (128, 1, 24, 32, 8),
    (2, 4, 2, 32, 1),      # fewer images than a wave holds: one image a block
    (128, 64, 12, 64, 128),  # more positions × heads than a wave: all images a block
    (101, 4, 12, 64, 21),  # two blocks an SM at D = 64; a last block of 17 images
], ids=["swin_t_stage1", "stage2", "stage3", "stage4", "small", "wide", "d64"])
def test_bwd_chunk_is_the_fewest_images_that_fill_one_wave(n_img, nw, heads, d, chunk):
    """On 132 SMs (an H100), three bf16 backward blocks an SM (two at D = 64):
    the chunk keeps every block of the launch resident at once, and one image
    less would not (unless every block already takes one image, or every
    image when the positions and heads alone fill the wave)."""
    slots = (2 if d == 64 else 3) * 132
    assert _bwd_chunk(n_img, nw, heads, d, 132) == chunk

    def blocks(c):
        return -(-n_img // c) * nw * heads

    assert blocks(chunk) <= max(slots, nw * heads)
    assert chunk == 1 or blocks(chunk - 1) > slots


@pytest.mark.parametrize("n_img,nw,heads,d,chunk", [
    (128, 64, 3, 32, 64), (128, 16, 6, 32, 26), (128, 4, 12, 32, 12), (128, 1, 24, 32, 6),
    (2, 4, 2, 32, 1),      # fewer images than a wave holds: one image a block
    (128, 64, 12, 64, 128),  # more positions × heads than a wave: all images a block
    (101, 4, 12, 64, 13),  # three blocks an SM at D = 64; a last block of 10 images
], ids=["swin_t_stage1", "stage2", "stage3", "stage4", "small", "wide", "d64"])
def test_fwd_chunk_is_the_fewest_images_that_fill_one_wave(n_img, nw, heads, d, chunk):
    """On 132 SMs (an H100), four bf16 forward blocks an SM (three at D = 64):
    the chunk keeps every block of the launch resident at once, and one image
    less would not (unless every block already takes one image, or every
    image when the positions and heads alone fill the wave)."""
    slots = (3 if d == 64 else 4) * 132
    assert _fwd_chunk(n_img, nw, heads, d, 132) == chunk

    def blocks(c):
        return -(-n_img // c) * nw * heads

    assert blocks(chunk) <= max(slots, nw * heads)
    assert chunk == 1 or blocks(chunk - 1) > slots


def test_kernel_wrappers_reject_what_the_kernels_do_not_take():
    q, k, v, bias, mask = map(torch.from_numpy, _inputs(b=1, nw=2, s=16, h=2, d=16))
    launches = window_fwd_kernel.launches, window_bwd_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        window_fwd_kernel(q, k, v, 2, bias, mask)
    with pytest.raises(ValueError, match="CUDA"):
        window_bwd_kernel(q, k, v, 2, bias, mask, q)
    long = torch.empty((1, 100, 32), device="meta")  # windows of 10 x 10 tokens
    with pytest.raises(NotImplementedError, match="64"):
        window_fwd_kernel(long, long, long, 2, torch.zeros(2, 100, 100))
    assert (window_fwd_kernel.launches, window_bwd_kernel.launches) == launches


# ---------------------------------------------------------------- on a card

# (B·nW, nW, H) of Swin-T's four stages at 224² with the batch cut from 128 to 4
# (S = 49, D = 32); stage 4 is one window an image and never shifts
CUDA_STAGES = [(4 * 64, 64, 3), (4 * 16, 16, 6), (4 * 4, 4, 12), (4, 1, 24)]


def _cuda_inputs(bnw, nw, h, dtype, shifted, seed=0, s=49, d=32, pad=0):
    """q, k, v as column thirds of one qkv tensor, as WindowAttention makes
    them; ``pad`` extra columns make the token stride 3·H·D + pad."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    e = h * d
    qkv = torch.randn((bnw, s, 3 * e + pad), generator=g, device="cuda").to(dtype)
    q, k, v = qkv[..., :3 * e].chunk(3, dim=-1)
    q = q * d ** -0.5
    bias = 0.5 * torch.randn((h, s, s), generator=g, device="cuda")
    mask = None
    if shifted:
        mask = torch.where(torch.rand((nw, s, s), generator=g, device="cuda") < 0.3,
                           -100.0, 0.0)
    dout = torch.randn((bnw, s, e), generator=g, device="cuda").to(dtype)
    return q, k, v, bias, mask, dout


def _tol(ref, dtype):
    # float32: the same float32 math in another order; bfloat16: P and dS are
    # rounded to bf16 before their products and the outputs to bf16
    return 1e-5 if dtype == torch.float32 else 2e-2 * ref.float().abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True], ids=["no_mask", "shift_mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bnw,nw,h", CUDA_STAGES, ids=["stage1", "stage2", "stage3", "stage4"])
def test_kernels_match_plain_on_cuda(bnw, nw, h, dtype, shifted):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    if shifted and nw == 1:
        pytest.skip("stage 4 is one window an image and never shifts")
    q, k, v, bias, mask, dout = _cuda_inputs(bnw, nw, h, dtype, shifted)
    launches = window_fwd_kernel.launches, window_bwd_kernel.launches
    out = window_fwd_kernel(q, k, v, h, bias, mask)
    dq, dk, dv, dbias = window_bwd_kernel(q, k, v, h, bias, mask, dout)
    torch.cuda.synchronize()
    assert (window_fwd_kernel.launches, window_bwd_kernel.launches) == (launches[0] + 1,
                                                                        launches[1] + 1)
    ref = window_attention_plain(q, k, v, h, bias, mask)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(ref, dtype), rtol=0)
    ref_grads = window_attention_backward_plain(q, k, v, h, bias, mask, ref, dout)
    for name, got, want in zip(("dq", "dk", "dv", "dbias"), (dq, dk, dv, dbias), ref_grads):
        # dbias sums B·nW windows' dS: its float32 error grows with the count
        tol = _tol(want, dtype) * (1e2 if name == "dbias" and dtype == torch.float32 else 1)
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
def test_dbias_is_the_same_bit_for_bit_on_every_run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    q, k, v, bias, mask, dout = _cuda_inputs(128 * 64, 64, 3, torch.bfloat16, True)
    first = window_bwd_kernel(q, k, v, 3, bias, mask, dout)
    for _ in range(3):
        again = window_bwd_kernel(q, k, v, 3, bias, mask, dout)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_function_on_cuda_runs_the_kernels_and_never_the_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    q, k, v, bias, mask, dout = _cuda_inputs(16, 4, 12, torch.bfloat16, True)
    q, k, v, bias = (t.detach().requires_grad_() for t in (q, k, v, bias))
    launches = window_fwd_kernel.launches, window_bwd_kernel.launches
    fused_window_attention(q, k, v, 12, bias, mask).backward(dout)
    torch.cuda.synchronize()
    assert (window_fwd_kernel.launches, window_bwd_kernel.launches) == (launches[0] + 1,
                                                                        launches[1] + 1)
    assert bias.grad.dtype == torch.float32 and bias.grad.shape == (12, 49, 49)


def _backward_matches_plain(q, k, v, bias, mask, dout, h):
    """One counted launch; dq, dk, dv and dbias against the plain VJP at the
    bf16 bound of ``_tol`` (P and dS rounded to bf16 before their products,
    the outputs to bf16)."""
    launches = window_bwd_kernel.launches
    got = window_bwd_kernel(q, k, v, h, bias, mask, dout)
    torch.cuda.synchronize()
    assert window_bwd_kernel.launches == launches + 1
    ref = window_attention_plain(q, k, v, h, bias, mask)
    want = window_attention_backward_plain(q, k, v, h, bias, mask, ref, dout)
    for name, a, b in zip(("dq", "dk", "dv", "dbias"), got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=_tol(b, q.dtype), rtol=0,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True], ids=["no_mask", "shift_mask"])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("s", [16, 64], ids=["window4", "window8"])
def test_backward_matches_plain_at_other_windows_on_cuda(s, d, shifted):
    """Windows of 4 × 4 (S = 16: three warps of four own only padded rows) and
    8 × 8 (S = 64: no padded row), every head dim the kernels take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    q, k, v, bias, mask, dout = _cuda_inputs(3 * 4, 4, 2, torch.bfloat16, shifted, s=s, d=d)
    _backward_matches_plain(q, k, v, bias, mask, dout, 2)


def _images_for(chunk_of, nw, h, device, rule=_bwd_chunk):
    """The first image count from 2 whose bf16 chunk (``rule``: ``_bwd_chunk``
    or ``_fwd_chunk``, a function of the shapes and the card) passes
    ``chunk_of(n_img, chunk)``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for n_img in range(2, 4096):
        if chunk_of(n_img, rule(n_img, nw, h, 32, sms)):
            return n_img
    raise AssertionError("no image count gives such a chunk")


@pytest.mark.cuda
@pytest.mark.parametrize("nw,h,case", [
    (4, 12, "ragged"), (1, 24, "ragged"),  # the last block of each position is short
    (4, 12, "one"),                        # every block takes one image
], ids=["ragged_nw4", "ragged_nw1", "chunk_of_one"])
def test_backward_prefetch_ends_at_the_chunk_on_cuda(nw, h, case):
    """A block prefetches the next image's window while it computes this one:
    an image count that the chunk does not divide, and a chunk of one image,
    hold the copy that must not be issued past the block's last image."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    device = torch.device("cuda")
    if case == "ragged":
        n_img = _images_for(lambda n, c: c > 1 and n % c != 0, nw, h, device)
    else:
        n_img = _images_for(lambda n, c: c == 1, nw, h, device)
    q, k, v, bias, mask, dout = _cuda_inputs(n_img * nw, nw, h, torch.bfloat16, nw > 1)
    _backward_matches_plain(q, k, v, bias, mask, dout, h)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64])
def test_backward_on_an_unaligned_stride_takes_the_scalar_path_on_cuda(d):
    """A token stride of 3·H·D + 1 elements for k and v is no multiple of 16
    bytes, so the kernel loads its tiles without cp.async."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    q, k, v, bias, mask, dout = _cuda_inputs(2 * 4, 4, 2, torch.bfloat16, True, d=d, pad=1)
    assert k.stride(1) * k.element_size() % 16 != 0
    _backward_matches_plain(q, k, v, bias, mask, dout, 2)


@pytest.mark.cuda
def test_dbias_is_the_same_bit_for_bit_at_stage4():
    """Swin-T's stage 4 at batch 128: one window an image, 24 heads."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    q, k, v, bias, mask, dout = _cuda_inputs(128, 1, 24, torch.bfloat16, False)
    first = window_bwd_kernel(q, k, v, 24, bias, mask, dout)
    for _ in range(3):
        again = window_bwd_kernel(q, k, v, 24, bias, mask, dout)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


def _forward_matches_plain(q, k, v, bias, mask, h):
    """One counted launch; the output against the plain version at the bf16
    bound of ``_tol`` (P rounded to bf16 before P·V, the output to bf16)."""
    launches = window_fwd_kernel.launches
    out = window_fwd_kernel(q, k, v, h, bias, mask)
    torch.cuda.synchronize()
    assert window_fwd_kernel.launches == launches + 1
    ref = window_attention_plain(q, k, v, h, bias, mask)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(ref, q.dtype), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True], ids=["no_mask", "shift_mask"])
@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("s", [16, 64], ids=["window4", "window8"])
def test_forward_matches_plain_at_other_windows_on_cuda(s, d, shifted):
    """Windows of 4 × 4 (S = 16: three warps of four own only padded rows and
    skip the products) and 8 × 8 (S = 64: no padded row), every head dim."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    q, k, v, bias, mask, _ = _cuda_inputs(3 * 4, 4, 2, torch.bfloat16, shifted, s=s, d=d)
    _forward_matches_plain(q, k, v, bias, mask, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("nw,h,case", [
    (4, 12, "ragged"), (1, 24, "ragged"),  # the last block of each position is short
    (4, 12, "one"),                        # every block takes one image
], ids=["ragged_nw4", "ragged_nw1", "chunk_of_one"])
def test_forward_prefetch_ends_at_the_chunk_on_cuda(nw, h, case):
    """The forward prefetches the next image's window while it computes this
    one: an image count that its chunk does not divide, and a chunk of one
    image, hold the copy that must not be issued past the block's last image."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    device = torch.device("cuda")
    if case == "ragged":
        n_img = _images_for(lambda n, c: c > 1 and n % c != 0, nw, h, device, _fwd_chunk)
    else:
        n_img = _images_for(lambda n, c: c == 1, nw, h, device, _fwd_chunk)
    q, k, v, bias, mask, _ = _cuda_inputs(n_img * nw, nw, h, torch.bfloat16, nw > 1)
    _forward_matches_plain(q, k, v, bias, mask, h)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64])
def test_forward_on_an_unaligned_stride_takes_the_scalar_path_on_cuda(d):
    """A token stride of 3·H·D + 1 elements for k and v is no multiple of 16
    bytes, so the forward loads its tiles without cp.async."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    q, k, v, bias, mask, _ = _cuda_inputs(2 * 4, 4, 2, torch.bfloat16, True, d=d, pad=1)
    assert k.stride(1) * k.element_size() % 16 != 0
    _forward_matches_plain(q, k, v, bias, mask, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("bnw,nw,h", [(128 * 64, 64, 3), (128, 1, 24)],
                         ids=["stage1", "stage4"])
def test_forward_gives_the_same_bits_on_every_call(bnw, nw, h):
    """Swin-T's stages 1 (shifted) and 4 at batch 128: no atomics, so every
    call writes the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU or interpret mode)")
    q, k, v, bias, mask, _ = _cuda_inputs(bnw, nw, h, torch.bfloat16, nw > 1)
    first = window_fwd_kernel(q, k, v, h, bias, mask)
    for _ in range(3):
        assert torch.equal(window_fwd_kernel(q, k, v, h, bias, mask), first)
