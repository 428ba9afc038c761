"""Ring attention: exact softmax attention with the sequence sharded over the
model group (counterpart of cvnets_tpu/parallel/ring_attention.py), on the
MHA kernels (ops/mha_attention.py).

``MultiHeadAttention`` routes here under ``--dev.sequence-parallel`` when the
model axis M > 1 divides S, there is no ``attn_mask``, as many queries as
keys, and no attention dropout in training (multi_head_attention.py:77-100
of the JAX layer); the ring then takes precedence over the local kernels.

Each model rank takes its S/M slice of the pre-scaled q, of k, v and of the
key mask (``scatter_to_model``: the slices' gradients are gathered back),
in float32 as JAX's ``_ring_attn_local`` computes (ring_attention.py:69-75),
and the k, v and mask blocks travel M-1 times round the group (rank i sends
to i+1, so at step j rank i holds rank i-j's block):

* forward: each (q slice, kv block) pair is one launch of the forward kernel
  ``mha_fwd_kernel``, which returns the block's normalised output, its row
  max m and the log of its row sum. The blocks merge in log-sum-exp form,
  m and the log-sum kept apart: a fully masked row (every key -1e30) has
  m = -1e30 and a log-sum of log(S/M) in each block, so the merge adds the
  blocks' sums to log(S) and keeps the einsum reference's uniform 1/S row,
  where m + log-sum would round the count away. The token slices are
  gathered over the group at the end, differentiably, and the output cast to
  q's dtype.
* backward: each pair is one call of ``mha_bwd_kernel`` with the global
  output and the global statistics of the q slice, which makes p = exp(s -
  m - log l) and delta = rowsum(dO·O) the whole row's: the call gives the
  block's exact dq, dk and dv. The dk and dv of a block ride round the ring
  with it and reach their owner after the last step. The forward saves the
  global (out, statistics), as flash attention does, where JAX's body is
  ``jax.checkpoint``-ed.
* a block whose head dim the kernels do not take, and every block on the
  CPU, runs the plain twins (``mha_attention_plain`` and its statistics,
  ``mha_attention_block_backward_plain``).

The transport (``rotate``): ``batch_isend_irecv`` over NCCL; over gloo, CPU
tensors go as they are, and CUDA tensors through pinned host memory, since
gloo takes a CUDA tensor in the collectives the grid uses (``all_reduce``,
``all_gather``, ``reduce_scatter_tensor``) but not in ``isend``/``irecv``:
two gloo ranks sharing an H100 abort on a bad address there. The compute
never leaves the card. A block that fails to arrive raises (the group's
timeout).

The ring's arithmetic is written once, as generators (``forward_steps``,
``backward_steps``) that yield the blocks a rank sends and are sent the
blocks it receives. ``over_the_group`` drives one of them with ``rotate``;
``ring_attention_in_process`` drives M of them in lockstep in one process
(``in_lockstep``): the tests' and ``chip_smoke.py``'s check of the same code
without a group.
"""

from __future__ import annotations

from typing import Generator, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from cvnets_tpu_torch.ops.mha_attention import (
    fused_attention_eligible,
    mha_attention_block_backward_plain,
    mha_attention_plain,
    mha_attention_stats_plain,
    mha_bwd_kernel,
    mha_fwd_kernel,
)
from cvnets_tpu_torch.parallel import mesh
from cvnets_tpu_torch.parallel.tensor_parallel import gather_from_model, scatter_to_model

def ring_attention_eligible(seq: int) -> bool:
    """A model axis larger than 1 that divides the sequence
    (ring_attention.py:90-97)."""
    n = mesh.model_size()
    return n > 1 and seq % n == 0


def ring_transport(t: torch.Tensor) -> str:
    """The route a block of ``t``'s device takes round the model group, for
    printing (``rotate`` decides it from the backend and the device)."""
    if dist.get_backend(mesh.model_group()) == "nccl":
        return "nccl batch_isend_irecv"
    return "gloo via pinned host" if t.is_cuda else "gloo batch_isend_irecv"


def _kernel_takes(q: torch.Tensor, heads: int) -> bool:
    b, s, e = q.shape
    return q.is_cuda and fused_attention_eligible(s, e, heads, q.element_size(), True)


def block_forward(q, k, v, heads: int, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (q slice, kv block) pair: the normalised output and the (2, B, H, S)
    row statistics (max, log of the sum)."""
    if _kernel_takes(q, heads):
        return mha_fwd_kernel(q, k, v, heads, mask)
    with torch.autocast(q.device.type, enabled=False):
        return (mha_attention_plain(q, k, v, heads, mask),
                mha_attention_stats_plain(q, k, v, heads, mask))


def block_backward(q, k, v, mask, out, g, stats, heads: int):
    """One pair's dq, dk, dv from the whole row's output and statistics."""
    if _kernel_takes(q, heads):
        return mha_bwd_kernel(q, k, v, mask, out, g, stats, heads)
    with torch.autocast(q.device.type, enabled=False):
        return mha_attention_block_backward_plain(q, k, v, mask, out, g, stats, heads)


class Merge:
    """The running log-sum-exp merge of one q slice's blocks."""

    def __init__(self, out: torch.Tensor, stats: torch.Tensor, heads: int) -> None:
        b, s, e = out.shape
        self.shape = (b, s, heads, e // heads)
        self.out = out.reshape(self.shape)
        self.m, self.log_sum = stats[0], stats[1]

    def add(self, out: torch.Tensor, stats: torch.Tensor) -> None:
        m = torch.maximum(self.m, stats[0])
        a = torch.exp(self.m - m + self.log_sum)  # (B, H, S): each side's mass over e^m
        c = torch.exp(stats[0] - m + stats[1])
        total = a + c
        wa, wc = ((w / total).permute(0, 2, 1)[..., None] for w in (a, c))
        self.out = self.out * wa + out.reshape(self.shape) * wc
        self.m, self.log_sum = m, torch.log(total)

    def result(self) -> Tuple[torch.Tensor, torch.Tensor]:
        b, s, h, d = self.shape
        return self.out.reshape(b, s, h * d), torch.stack([self.m, self.log_sum]).contiguous()


def _pack(tensors: Sequence[Optional[torch.Tensor]]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors if t is not None])


def _unpack(flat: torch.Tensor, like: Sequence[Optional[torch.Tensor]]) -> List:
    out, start = [], 0
    for t in like:
        if t is None:
            out.append(None)
            continue
        out.append(flat[start:start + t.numel()].view_as(t))
        start += t.numel()
    return out


def rotate(tensors: Sequence[Optional[torch.Tensor]]) -> List:
    """The float32 ``tensors`` of the previous model rank, this rank's sent to
    the next: one message a step, packed."""
    g = mesh.grid()
    n, i = g.model, g.model_index
    dst, src = g.model_ranks[(i + 1) % n], g.model_ranks[(i - 1) % n]
    group = mesh.model_group()
    flat = _pack(tensors)
    staged = flat.is_cuda and dist.get_backend(group) == "gloo"
    send = flat.to("cpu").pin_memory() if staged else flat
    recv = torch.empty_like(send, pin_memory=staged) if staged else torch.empty_like(flat)
    ops = [dist.P2POp(dist.isend, send, dst, group), dist.P2POp(dist.irecv, recv, src, group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return _unpack(recv.to(flat.device) if staged else recv, tensors)


def forward_steps(q, k, v, mask, heads: int, n: int) -> Generator:
    """The q slice's output and statistics over the ring's ``n`` blocks, as a
    generator that yields the blocks it sends and is sent those it receives."""
    merge = Merge(*block_forward(q, k, v, heads, mask), heads)
    for _ in range(n - 1):
        k, v, mask = yield [k, v, mask]
        merge.add(*block_forward(q, k, v, heads, mask))
    return merge.result()


def backward_steps(q, k, v, mask, out, g, stats, heads: int, n: int) -> Generator:
    """dq of the q slice, and dk, dv of this rank's kv block (come home), as
    ``forward_steps``' generator."""
    dq, dk, dv = block_backward(q, k, v, mask, out, g, stats, heads)
    for _ in range(n - 1):
        k, v, mask, dk, dv = yield [k, v, mask, dk, dv]
        dq_j, dk_j, dv_j = block_backward(q, k, v, mask, out, g, stats, heads)
        dq, dk, dv = dq + dq_j, dk + dk_j, dv + dv_j
    if n > 1:
        dk, dv = yield [dk, dv]
    return dq, dk, dv


def over_the_group(steps: Generator):
    """Run a ring's steps, each send a ``rotate`` round the model group."""
    try:
        sent = next(steps)
        while True:
            sent = steps.send(rotate(sent))
    except StopIteration as done:
        return done.value


def in_lockstep(ranks: List[Generator]) -> List:
    """Run ``n`` ranks' ring steps in this process, step by step, rank i
    receiving what rank i - 1 sent: the rotation without a group."""
    n, results = len(ranks), [None] * len(ranks)
    sent = []
    for i, steps in enumerate(ranks):
        try:
            sent.append(next(steps))
        except StopIteration as done:
            results[i] = done.value
    while sent:
        received, sent = [sent[(i - 1) % n] for i in range(n)], []
        for i, steps in enumerate(ranks):
            try:
                sent.append(steps.send(received[i]))
            except StopIteration as done:
                results[i] = done.value
    return results


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, heads: int):
        n = mesh.model_size()
        out, stats = over_the_group(forward_steps(q, k, v, mask, heads, n))
        ctx.heads, ctx.n = heads, n
        ctx.save_for_backward(q, k, v, mask, out, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, mask, out, stats = ctx.saved_tensors
        dq, dk, dv = over_the_group(backward_steps(q, k, v, mask, out, g.contiguous(), stats,
                                                   ctx.heads, ctx.n))
        return dq, dk, dv, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                   key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention of the whole (B, S, H·D) q (already scaled), k and v,
    the sequence sharded over the model group; every model rank passes the
    same tensors and gets the whole (B, S, H·D) context in q's dtype.
    ``key_mask``: an additive (B, S) float mask (0 / -1e30) or None."""
    qs, ks, vs = (scatter_to_model(t.float(), 1).contiguous() for t in (q, k, v))
    mask = None
    if key_mask is not None:
        s = q.shape[1] // mesh.model_size()
        mask = key_mask.float().narrow(1, mesh.model_index() * s, s).contiguous()
    out = _Ring.apply(qs, ks, vs, mask, heads)
    return gather_from_model(out, 1).to(q.dtype)


def ring_attention_in_process(q, k, v, heads: int, n: int, key_mask=None, g=None):
    """The ring's steps over ``n`` slices of the whole float32 (B, S, H·D) q
    (scaled), k and v in this process, the ranks run in lockstep
    (``in_lockstep``). Returns the output and, when the output's gradient
    ``g`` is given, dq, dk and dv."""
    s = q.shape[1] // n
    cut = lambda t, i: None if t is None else t[:, i * s:(i + 1) * s].contiguous()  # noqa: E731
    results = in_lockstep([forward_steps(cut(q, i), cut(k, i), cut(v, i), cut(key_mask, i),
                                         heads, n) for i in range(n)])
    out = torch.cat([o for o, _ in results], 1)
    if g is None:
        return out
    grads = in_lockstep([backward_steps(cut(q, i), cut(k, i), cut(v, i), cut(key_mask, i), o,
                                        cut(g, i), st, heads, n)
                         for i, (o, st) in enumerate(results)])
    return (out,) + tuple(torch.cat(parts, 1) for parts in zip(*grads))
