"""Shared neural layers: RMSNorm, RoPE, embeddings, gated MLPs and the
cross-entropy loss."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import ParamBuilder
from repro_torch.sharding.partitioning import constrain, index_add, lookup

VOCAB_PAD_MULTIPLE = 256


def padded_vocab(cfg: ModelConfig) -> int:
    v = cfg.vocab
    m = VOCAB_PAD_MULTIPLE
    return (v + m - 1) // m * m


# -- RMSNorm -------------------------------------------------------------------

def init_rmsnorm(b: ParamBuilder, name: str, dim: int) -> None:
    b.add(name, (dim,), ("norm",), init="ones")


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Computed in f32, returned in x's dtype."""
    dtype = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


# -- RoPE ----------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | None = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, exps)  # f32 power of a scalar base


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq].  Rotates
    split halves (first half with second), computed in f32."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)      # [hd/2]
    angles = positions[..., :, None].float() * freqs          # [.., S, hd/2]
    angles = angles[..., None, :]                             # [.., S, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -- Embedding / unembedding ------------------------------------------------------

def init_embedding(b: ParamBuilder, cfg: ModelConfig) -> None:
    pv = padded_vocab(cfg)
    b.add("embedding", (pv, cfg.d_model), ("vocab", "embed"), scale=1.0)
    if not cfg.tie_embeddings:
        b.add("unembed", (cfg.d_model, pv), ("embed", "vocab"))


class _Lookup(torch.autograd.Function):
    """``table[tokens]`` whose backward sums each row's gradient in f32 and
    rounds it to the table's dtype once, as the reference's one-hot
    contraction does in its f32 accumulator.  Indexing's own backward
    accumulates in the table's dtype, so a token repeated across a bf16
    batch would collect one rounding per repeat."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, tokens: torch.Tensor):
        ctx.save_for_backward(table, tokens)
        return lookup(table, tokens)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        table, tokens = ctx.saved_tensors
        # zeros laid out as the table (sharded as it is, as a DTensor)
        acc = index_add(torch.zeros_like(table, dtype=torch.float32), 0,
                        tokens.reshape(-1),
                        grad.reshape(-1, grad.shape[-1]).float())
        return acc.to(table.dtype), None


def embed_tokens(params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Row lookup for both ``embed_impl`` values.

    The reference's ``onehot`` contracts a one-hot matrix with the table;
    each output element is then 1*x plus exact zeros, so the lookup gives
    the same bits without the [B, S, vocab] one-hot, and its gradient is
    summed in f32 as the contraction's is (:class:`_Lookup`).
    """
    table = params["embedding"]
    x = _Lookup.apply(table, tokens.long())
    if cfg.family in ("dense", "vlm"):  # gemma-style sqrt(d) scaling
        # the scale rounded to the table's dtype first, as the reference
        # does; a Python scalar keeps the multiply free of a host copy
        scale = torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype).item()
        x = x * scale
    return constrain(x, ("batch", "seq", None))


def unembed(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    table = (params["embedding"].T if cfg.tie_embeddings
             else params["unembed"])
    logits = torch.matmul(x, table.to(x.dtype))
    return constrain(logits, ("batch", "seq", "vocab"))


# -- Gated MLP ---------------------------------------------------------------------

def init_mlp(b: ParamBuilder, cfg: ModelConfig, d_ff: int | None = None,
             stacked: int | None = None) -> None:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    lead = (stacked,) if stacked else ()
    lax = ("layers",) if stacked else ()
    b.add("w_gate", lead + (d, f), lax + ("embed", "ffn"))
    b.add("w_up", lead + (d, f), lax + ("embed", "ffn"))
    b.add("w_down", lead + (f, d), lax + ("ffn", "embed"))


def mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    gate = torch.matmul(x, params["w_gate"])
    up = torch.matmul(x, params["w_up"])
    gate = constrain(gate, ("batch", "seq", "ffn"))
    if cfg.act == "swiglu":
        act = F.silu(gate.float()).to(x.dtype)
    else:  # geglu and gelu both gate with tanh-approximated gelu
        act = F.gelu(gate.float(), approximate="tanh").to(x.dtype)
    out = torch.matmul(act * up, params["w_down"])
    return constrain(out, ("batch", "seq", None))


# -- Loss --------------------------------------------------------------------------

def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       vocab: int) -> torch.Tensor:
    """Mean CE over valid (label >= 0) positions; padded vocab masked out.

    Computed in f32, the padded columns (>= ``vocab``) pushed down by 1e9
    as in the reference.  The gold logit is gathered where the reference
    contracts a one-hot (a form it keeps for SPMD partitioning); the sum of
    the one-hot products is that one logit plus exact zeros, so the values
    agree.  The gather needs whole vocab rows, so vocab-sharded logits (a
    DTensor in the dry run) are gathered over the vocab first: DTensor's
    vocab-parallel gather does not run on ``meta`` tensors.
    """
    logits = logits.float()
    pv = logits.shape[-1]
    if pv > vocab:
        vocab_ids = torch.arange(pv, device=logits.device)
        logits = logits + torch.where(vocab_ids >= vocab, -1e9, 0.0)
    valid = labels >= 0
    logz = torch.logsumexp(logits, dim=-1)
    gold = constrain(logits, ("batch", "seq", None)).gather(
        -1, labels.clamp(min=0).long()[..., None])[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / valid.sum().clamp(min=1)
