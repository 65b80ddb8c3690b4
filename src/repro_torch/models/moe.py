"""Mixture-of-Experts FFN: a softmax top-k router over stacked experts.

Two functions compute it:

- :func:`moe_layer`, the reference's group-limited capacity dispatch
  (Switch/T5X): tokens are split into groups, each expert takes at most a
  capacity of tokens a group, queued slot-major, and dispatch and combine
  are one-hot contractions.  A token past capacity is dropped.  It returns
  the Switch load-balancing aux loss too.  ``forward`` and the losses use
  it.
- :func:`moe_tokens`, what :func:`moe_layer` computes when every token is
  a group of its own (capacity k, so nothing is dropped), grouped by
  expert: each expert runs over the tokens routed to it.  The
  cache-filling prefill uses it, as the reference's engine routes each
  prompt token alone through ``decode_step``, and so does an eager
  decode step unless asked for the capacity dispatch.  It never builds
  the [E, tokens, C, d] dispatch, but it counts each expert's tokens on
  the host, so a captured decode graph runs :func:`moe_layer` instead,
  which at S=1 computes the same function.

The expert FFN is SiLU-gated whatever ``cfg.act`` says, as in the
reference (grok-1's ``act="geglu"`` reaches only its dense MLPs, of which
it has none).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import ParamBuilder
from repro_torch.sharding.partitioning import constrain

MOE_GROUP = 512  # tokens per dispatch group


def init_moe(b: ParamBuilder, cfg: ModelConfig,
             stacked: int | None = None) -> None:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    lead = (stacked,) if stacked else ()
    lax_ = ("layers",) if stacked else ()
    b.add("router", lead + (d, e), lax_ + ("embed", None), scale=0.02)
    b.add("w_gate", lead + (e, d, f), lax_ + ("experts", "embed", "expert_ffn"))
    b.add("w_up", lead + (e, d, f), lax_ + ("experts", "embed", "expert_ffn"))
    b.add("w_down", lead + (e, f, d), lax_ + ("experts", "expert_ffn", "embed"))


def router_probs(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Softmax router probabilities [..., E] in f32 of x [..., d]."""
    logits = torch.matmul(x.reshape(-1, x.shape[-1]).float(),
                          params["router"].float())
    return torch.softmax(logits, dim=-1).reshape(*x.shape[:-1], -1)


def top_k_gates(probs: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each token's top-k gates, renormalised to sum to 1, and experts
    ([..., k] each) of router probabilities [..., E]."""
    gates, experts = torch.topk(probs, k, dim=-1)
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), experts


def top_k_routes(params: dict, x: torch.Tensor, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`top_k_gates` of x [..., d]."""
    return top_k_gates(router_probs(params, x), cfg.top_k)


def _experts_ffn(params: dict, xe: torch.Tensor, e=slice(None)
                 ) -> torch.Tensor:
    """The SiLU-gated FFN of expert ``e`` (all experts, stacked on the
    leading axis of xe, by default)."""
    gate = torch.matmul(xe, params["w_gate"][e])
    up = torch.matmul(xe, params["w_up"][e])
    act = F.silu(gate.float()).to(xe.dtype)
    return torch.matmul(act * up, params["w_down"][e])


def group_size(s: int) -> int:
    """Tokens per dispatch group: MOE_GROUP, halved until it tiles S."""
    g_sz = min(MOE_GROUP, s)
    while s % g_sz != 0:
        g_sz //= 2
    return g_sz


def capacity(cfg: ModelConfig, g_sz: int) -> int:
    return int(max(cfg.top_k,
                   g_sz * cfg.capacity_factor * cfg.top_k / cfg.n_experts))


def moe_layer(params: dict, x: torch.Tensor, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,d] -> (output [B,S,d], aux load-balancing loss scalar), by
    the reference's group-limited capacity dispatch."""
    b_, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    g_sz = group_size(s)
    g = s // g_sz
    cap = capacity(cfg, g_sz)
    xg = x.reshape(b_, g, g_sz, d)
    probs = router_probs(params, xg)                       # [B,G,T,E] f32

    # -- load-balance aux loss (Switch): E * sum(frac_tokens * frac_probs)
    top1 = F.one_hot(probs.argmax(-1), e).float()
    frac_tokens = top1.mean(dim=(0, 1, 2))
    frac_probs = probs.mean(dim=(0, 1, 2))
    aux = e * (frac_tokens * frac_probs).sum()

    gate_vals, gate_idx = top_k_gates(probs, k)           # [B,G,T,k]

    # -- capacity: each token's position in its expert's queue, every
    # first choice of the group queued before any second choice
    slots = torch.arange(cap, device=x.device, dtype=torch.float32)
    combine = x.new_zeros((b_, g, g_sz, e, cap), dtype=torch.float32)
    dispatch = torch.zeros((b_, g, g_sz, e, cap), dtype=torch.bool,
                           device=x.device)
    used = x.new_zeros((b_, g, 1, e), dtype=torch.float32)
    for slot in range(k):
        onehot = F.one_hot(gate_idx[..., slot], e).float()  # [B,G,T,E]
        pos_e = torch.cumsum(onehot, dim=2) - onehot + used
        pos = (pos_e * onehot).sum(-1)                     # [B,G,T]
        sel = onehot * (pos < cap)[..., None]
        used = used + sel.sum(dim=2, keepdim=True)
        pos_oh = (pos[..., None] == slots).float()         # [B,G,T,C]
        placed = sel[..., None] * pos_oh[..., None, :]     # [B,G,T,E,C]
        dispatch = dispatch | placed.bool()
        combine = combine + gate_vals[..., slot, None, None] * placed

    expert_in = torch.einsum("bgtec,bgtd->ebgcd", dispatch.to(x.dtype), xg)
    expert_in = constrain(expert_in, ("experts", "batch", None, None, None))
    expert_out = _experts_ffn(
        params, expert_in.reshape(e, -1, d)).reshape(e, b_, g, cap, d)
    expert_out = constrain(expert_out,
                           ("experts", "batch", None, None, None))
    out = torch.einsum("bgtec,ebgcd->bgtd", combine.to(x.dtype), expert_out)
    return constrain(out.reshape(b_, s, d), ("batch", "seq", None)), aux


def moe_tokens(params: dict, x: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    """x [..., d] -> [..., d]: :func:`moe_layer` with every token a group of
    one (capacity k: a token's k experts are distinct, so none is dropped),
    computed expert by expert over the tokens routed to it.  Each token's
    expert outputs are weighted by its gates rounded to x's dtype and
    summed in f32, as moe_layer's combine contraction sums them."""
    shape, d = x.shape, x.shape[-1]
    x2 = x.reshape(-1, d)
    gates, experts = top_k_routes(params, x2, cfg)        # [N,k]
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    token = order // cfg.top_k                             # [N*k] sorted
    weight = gates.reshape(-1)[order].to(x.dtype).float()
    counts = torch.bincount(flat, minlength=cfg.n_experts).tolist()
    acc = torch.zeros(x2.shape, dtype=torch.float32, device=x.device)
    start = 0
    for e, n in enumerate(counts):
        if n:
            rows = token[start:start + n]
            y = _experts_ffn(params, x2[rows], e)
            # a token's k experts are distinct, so an expert's rows are too:
            # one add a row, as index_add_ makes it (which runs slowly on
            # small CPU tensors across threads)
            acc[rows] += y.float() * weight[start:start + n, None]
            start += n
    return acc.to(x.dtype).reshape(shape)
