"""Mixture-of-Experts FFN (counterpart of cvnets_tpu/modules/moe.py):
``MoEFFN`` (:55-132) and the pre-norm block ``MoETransformerEncoder``
(:135-181).

The routing is JAX's, decision for decision. The router runs in float32
outside autocast (:73-76); k rounds each take every token's largest
remaining probability (the first one on a tie, in torch as in JAX); a
token's place in its expert's buffer is its rank among the round's tokens
sent there, in (B, S) row-major order, after what earlier rounds filled
(:89-108); the capacity ``C = min(max(ceil(k·T·cf / E), 1), T)`` is the whole
batch's, so the earlier images win; a place ≥ C is dropped; the kept gates
are renormalised by ``max(Σ, 1e-9)``; the load-balance loss is
``E · Σ_e mean(probs)_e · importance_e / k`` (:112-115).

JAX builds one-hot (T, E, C) dispatch and combine tensors and contracts
them by einsum. At ViT-B/16-MoE's batch of 128 (T = 25,216, C = 7,880) each
is 1.6e9 elements a layer, so the port computes the same function in index
form: each kept (token, round) is copied into an (E·C, D) buffer at
``expert·C + place``, the experts run as two ``bmm`` over (E, C, ·), and each
token gathers its k rows back, weighted by its renormalised gates. The
expert leaves keep JAX's layout and rank (``experts_fc1`` (E, D, F),
``experts_fc1_bias`` (E, 1, F), ``experts_fc2`` (E, F, D),
``experts_fc2_bias`` (E, 1, D)), so the optimizer's rank > 1 decay mask
decays the 3-D biases, as JAX's does. Expert parallelism
(``_expert_sharding_constraint``) has nothing to do on one device.

The forward reads nothing back to the host (no boolean indexing: a round
that is not dispatched writes a spare last row of the buffer), and runs in
three ``torch.profiler`` ranges, ``MOE_ROUTE`` (the router, the routing
and the copy into the buffer), ``MOE_EXPERTS`` (the two products) and
``MOE_COMBINE`` (the weighted gather), so that a profile splits its time.

In training ``MoEFFN`` leaves its load-balance loss in ``aux_loss`` (None
in eval: JAX's ``sow`` is a no-op outside a mutable collection); the train
step adds ``--model.moe.aux-loss-weight`` times their sum. A recomputation
under gradient checkpointing writes the same value again.
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import torch
import torch.nn as nn
from torch.profiler import record_function

from cvnets_tpu_torch.layers.activation import build_act_layer
from cvnets_tpu_torch.layers.init_utils import init_tensor
from cvnets_tpu_torch.layers.linear_layer import LinearLayer
from cvnets_tpu_torch.layers.multi_head_attention import MultiHeadAttention
from cvnets_tpu_torch.layers.normalization import get_normalization_layer


MOE_ROUTE, MOE_EXPERTS, MOE_COMBINE = "moe_route", "moe_experts", "moe_combine"


def arguments_moe(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    group = parser.add_argument_group(title="MoE arguments")
    group.add_argument("--model.moe.aux-loss-weight", type=float, default=0.01,
                       help="Weight of the MoE layers' load-balance loss, which the train "
                            "step adds to the loss")
    return parser


def capacity(n_tokens: int, num_experts: int, top_k: int, capacity_factor: float) -> int:
    """Each expert's buffer: ceil(k·T·cf / E), at least 1 and at most T (:69-70)."""
    cap = int(-(-(top_k * n_tokens * capacity_factor) // num_experts))
    return min(max(cap, 1), n_tokens)


def route(probs: torch.Tensor, top_k: int, cap: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """JAX's k rounds over the (T, E) float32 router probabilities.

    Returns (expert, place, kept, weight, importance): the (T, k) expert and
    buffer place of each round, whether it is kept (place < C), its gate
    renormalised over the token's kept rounds (0 where dropped), and the (E,)
    share of tokens each expert was chosen for, summed over the rounds."""
    num_experts = probs.shape[1]
    masked = probs
    fill = torch.zeros(num_experts, dtype=torch.int32, device=probs.device)
    importance = torch.zeros(num_experts, dtype=probs.dtype, device=probs.device)
    ids = torch.arange(num_experts, device=probs.device)
    experts, places, kepts, gates = [], [], [], []
    for _ in range(top_k):
        gate, expert = masked.max(dim=-1)  # the first maximum, as jnp.argmax
        # (E, T): each expert's row, so the rank of a token among the round's
        # tokens of its expert is a scan along the row (contiguous, fast)
        chosen = (ids[:, None] == expert[None, :]).to(torch.int32)
        place = (chosen.cumsum(1) - 1 + fill[:, None]).gather(0, expert[None, :])[0]
        kept = place < cap
        fill = fill + (chosen * kept[None, :]).sum(1, dtype=torch.int32)
        importance = importance + chosen.to(probs.dtype).mean(1)
        masked = masked * (1 - chosen.t()).to(probs.dtype)
        experts.append(expert)
        places.append(place.long())
        kepts.append(kept)
        gates.append(gate * kept)
    gates = torch.stack(gates, 1)
    weight = gates / gates.sum(1, keepdim=True).clamp_min(1e-9)
    return (torch.stack(experts, 1), torch.stack(places, 1), torch.stack(kepts, 1), weight,
            importance)


class MoEFFN(nn.Module):
    """Sparse FFN on (B, S, D) tokens: each token to its top-k of E experts."""

    def __init__(self, opts, embed_dim: int, ffn_latent_dim: int, num_experts: int = 8,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 act_name: Optional[str] = None) -> None:
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k={top_k} out of range for {num_experts} experts")
        e, d, f = num_experts, embed_dim, ffn_latent_dim
        self.num_experts, self.top_k, self.capacity_factor = e, top_k, capacity_factor
        self.router = LinearLayer(d, e, bias=False)
        self.experts_fc1 = nn.Parameter(torch.empty(e, d, f))
        self.experts_fc1_bias = nn.Parameter(torch.zeros(e, 1, f))
        self.experts_fc2 = nn.Parameter(torch.empty(e, f, d))
        self.experts_fc2_bias = nn.Parameter(torch.zeros(e, 1, d))
        self.act = build_act_layer(opts, act_name)
        self.aux_loss: Optional[torch.Tensor] = None

    def init_own_parameters(self, generator: Optional[torch.Generator]) -> None:
        """The stacked experts: normals at std 0.02, zero biases (:117-121)."""
        for w in (self.experts_fc1, self.experts_fc2):
            init_tensor(w, "normal", 0.02, generator)
        for b in (self.experts_fc1_bias, self.experts_fc2_bias):
            nn.init.zeros_(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        e, k = self.num_experts, self.top_k
        tokens = x.reshape(b * s, d)
        t = b * s
        cap = capacity(t, e, k, self.capacity_factor)
        with record_function(MOE_ROUTE):
            with torch.autocast(device_type=x.device.type, enabled=False):
                probs = torch.softmax(self.router(tokens.float()), dim=-1)  # (T, E)
            expert, place, kept, weight, importance = route(probs, k, cap)
            self.aux_loss = (e * (probs.mean(0) * importance / k).sum()) if self.training \
                else None
            # each (token, round) to its row expert·C + place of the buffer; a
            # round that is not dispatched (JAX's dispatch = combine > 0) to the
            # spare row e·C, dropped after
            slot = expert * cap + place
            dispatched = kept & (weight > 0)
            rows = torch.where(dispatched, slot, e * cap).reshape(-1)
            xin = tokens.new_zeros(e * cap + 1, d).index_copy(
                0, rows, tokens[:, None].expand(t, k, d).reshape(t * k, d))[:e * cap]
        with record_function(MOE_EXPERTS):
            h = torch.bmm(xin.view(e, cap, d), self.experts_fc1)
            h = self.act(h + self.experts_fc1_bias.to(h.dtype))  # the bias in the compute dtype
            out = torch.bmm(h, self.experts_fc2)
            out = (out + self.experts_fc2_bias.to(out.dtype)).reshape(e * cap, d)
        with record_function(MOE_COMBINE):
            # index_select, whose backward is one scatter-add: each row of the
            # buffer is read by at most one dispatched round (the others read
            # row 0 at weight 0 and add zeros to it)
            gathered = out.index_select(0, torch.where(dispatched, slot, 0).reshape(-1))
            y = (gathered.view(t, k, d).float() * weight[..., None]).sum(1).to(out.dtype)
        return y.reshape(b, s, d)


class MoETransformerEncoder(nn.Module):
    """Pre-norm MHA + MoE FFN on (B, S, E) tokens: ``TransformerEncoder`` with
    the dense FFN swapped for ``MoEFFN``; no stochastic depth and no FFN
    dropout, as the JAX block has none."""

    def __init__(self, opts, embed_dim: int, ffn_latent_dim: int, num_heads: int = 8,
                 num_experts: int = 8, top_k: int = 2, capacity_factor: float = 1.25,
                 attn_dropout: float = 0.0, dropout: float = 0.0,
                 transformer_norm_layer: str = "layer_norm", norm_eps: float = 1e-5) -> None:
        super().__init__()
        self.pre_norm_mha = get_normalization_layer(
            opts, embed_dim, transformer_norm_layer, eps=norm_eps) or nn.Identity()
        self.mha = MultiHeadAttention(opts, embed_dim, num_heads, attn_dropout=attn_dropout)
        self.pre_norm_ffn = get_normalization_layer(
            opts, embed_dim, transformer_norm_layer, eps=norm_eps) or nn.Identity()
        self.moe_ffn = MoEFFN(opts, embed_dim, ffn_latent_dim, num_experts=num_experts,
                              top_k=top_k, capacity_factor=capacity_factor)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, x_prev: Optional[torch.Tensor] = None,
                key_padding_mask: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.mha(self.pre_norm_mha(x), x_kv=x_prev, key_padding_mask=key_padding_mask,
                     attn_mask=attn_mask)
        x = x + self.dropout(y)
        return x + self.dropout(self.moe_ffn(self.pre_norm_ffn(x)))


def moe_aux_loss(model: nn.Module) -> Optional[torch.Tensor]:
    """The sum of the load-balance losses the model's MoE layers left in their
    last training forward, or None when it has none."""
    losses = [m.aux_loss for m in model.modules()
              if isinstance(m, MoEFFN) and m.aux_loss is not None]
    return torch.stack(losses).sum() if losses else None
