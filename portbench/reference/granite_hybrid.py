"""The plain reference of IBM Granite 4.0-H (Hugging Face transformers'
``granitemoehybrid``) in float32 PyTorch, and the work its served requests
ask for.

It reads the weights in the layout the served program takes them (nested
dicts of stacked tensors: ``mamba_layers``, ``attention_layers``,
``moe_layers``, ``shared_mlp``) and works out everything else itself: no
kernel, no cache, no batching trick, and it imports nothing of the
program.  Each row of tokens runs as one causal sequence; every layer is
computed over the whole row at once, its weights cast to float32 as the
layer is reached.  Vectors (norms, biases, the SSM's A, D and dt bias) and
the conv taps are always read exactly.  Every layer i computes, with r the
residual multiplier,

    x += r * mixer_i(rmsnorm(x));  h = rmsnorm(x);  x += r * (moe(h) + shared(h))

- mixer_i: for i in ``attn_layers``, grouped-query attention with no
  position embedding (NoPE) and the scores times ``attention_multiplier``;
  else the Mamba2 mixer (in_proj to z, xBC and dt; a causal conv with bias
  and SiLU over xBC; the SSD recurrence S_t = exp(dt_t a) S_{t-1} + dt_t
  x_t B_t^T, y_t = S_t C_t + D x_t, in chunks of ``SSD_CHUNK`` rows; y
  gated by SiLU(z), RMS-normed, out_proj), one group of B and C;
- moe: GraniteMoe's router, a softmax over each token's top-k logits, and
  every token's k experts (SiLU(x Wg) * x Wu) Wd weighted by it, computed
  expert by expert over the tokens routed to it (dropless);
- shared: the shared expert, the same SwiGLU of its own width.

The embedding is multiplied by ``embedding_multiplier``; the tied head's
logits are divided by ``logits_scaling``.  Departures from the published
equations: none in the arithmetic (float32 throughout where the published
model runs bfloat16); the weights are the benchmark's random draws.
``tests/plain_granite_hybrid.py`` is a copy of this file for the port's
own tests, which import nothing of the benchmark.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

Cast = Callable[[torch.Tensor], torch.Tensor]

SSD_CHUNK = 64


def exact(w: torch.Tensor) -> torch.Tensor:
    return w.float()


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def layer_kinds(m: dict) -> list[tuple[str, int]]:
    """Each layer's mixer ("attention" or "mamba") and its index in that
    mixer's stack of weights."""
    attention = set(m["attn_layers"])
    seen = {"attention": 0, "mamba": 0}
    out = []
    for i in range(m["n_layers"]):
        kind = "attention" if i in attention else "mamba"
        out.append((kind, seen[kind]))
        seen[kind] += 1
    return out


# -- the mixers --------------------------------------------------------------

def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
        b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x [R,T,H,P], dt [R,T,H], a [H], b/c [R,T,N] -> y [R,T,H,P] (no D)."""
    r, t, h, p = x.shape
    n = b.shape[-1]
    state = x.new_zeros((r, h, p, n))
    ys = []
    for lo in range(0, t, SSD_CHUNK):
        hi = min(lo + SSD_CHUNK, t)
        q = hi - lo
        u = dt[:, lo:hi, :, None] * x[:, lo:hi]               # [R,q,H,P]
        cs = torch.cumsum(dt[:, lo:hi] * a, dim=1)            # [R,q,H]
        seg = cs[:, :, None, :] - cs[:, None, :, :]           # [R,j,i,H]
        keep = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(torch.where(keep[None, :, :, None], seg,
                                      -torch.inf))
        scores = torch.einsum("rjn,rin->rji", c[:, lo:hi], b[:, lo:hi])
        y = torch.einsum("rjih,rihp->rjhp", scores[..., None] * decay, u)
        y = y + (torch.einsum("rjn,rhpn->rjhp", c[:, lo:hi], state)
                 * torch.exp(cs)[..., None])
        to_end = torch.exp(cs[:, -1:] - cs)                   # [R,q,H]
        state = (torch.exp(cs[:, -1])[..., None, None] * state
                 + torch.einsum("rihp,rin,rih->rhpn", u, b[:, lo:hi], to_end))
        ys.append(y)
    return torch.cat(ys, dim=1)


def mamba_mixer(lw: dict, h: torch.Tensor, m: dict, cast: Cast
                ) -> torch.Tensor:
    """One Mamba2 mixer over normed rows h [R,T,d]."""
    d_inner, heads, p, n = ssm_dims(m)
    r, t, _ = h.shape
    z, xbc, dt = torch.split(h @ cast(lw["in_proj"]),
                             [d_inner, d_inner + 2 * n, heads], dim=-1)
    w = lw["conv_w"].float()                                  # [W, ch]
    width = w.shape[0]
    padded = F.pad(xbc, (0, 0, width - 1, 0))
    conv = sum(padded[:, i:i + t] * w[i] for i in range(width))
    conv = F.silu(conv + lw["conv_b"].float())
    xs, b, c = torch.split(conv, [d_inner, n, n], dim=-1)
    dt = F.softplus(dt + lw["dt_bias"].float())
    a = -torch.exp(lw["A_log"].float())
    xh = xs.reshape(r, t, heads, p)
    y = ssd(xh, dt, a, b, c) + lw["D"].float()[:, None] * xh
    y = y.reshape(r, t, d_inner) * F.silu(z)
    return rmsnorm(y, lw["norm"], m["norm_eps"]) @ cast(lw["out_proj"])


def attention(lw: dict, h: torch.Tensor, m: dict, cast: Cast
              ) -> torch.Tensor:
    """Causal NoPE grouped-query attention over normed rows h [R,T,d], one
    row at a time."""
    r, t, d = h.shape
    nh, kh, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]

    def heads(name, n):
        return (h @ cast(lw[name]).reshape(d, n * hd)).reshape(r, t, n, hd)

    q = heads("wq", nh)
    k = heads("wk", kh).repeat_interleave(nh // kh, dim=2)
    v = heads("wv", kh).repeat_interleave(nh // kh, dim=2)
    hidden = torch.ones(t, t, dtype=torch.bool, device=h.device).tril() == 0
    out = []
    for i in range(r):
        s = torch.einsum("qhd,khd->hqk", q[i], k[i])
        s = s * m["attention_multiplier"]
        p = torch.softmax(s.masked_fill(hidden, -torch.inf), dim=-1)
        out.append(torch.einsum("hqk,khd->qhd", p, v[i]))
    o = torch.stack(out).reshape(r, t, nh * hd)
    return o @ cast(lw["wo"]).reshape(nh * hd, d)


# -- the feed-forward ----------------------------------------------------------

def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def moe(lw: dict, h: torch.Tensor, m: dict, cast: Cast) -> torch.Tensor:
    """The routed experts over normed rows h [..., d]: each token's top-k
    router logits, softmaxed, weight its k experts' outputs."""
    x = h.reshape(-1, h.shape[-1])
    top, experts = (x @ cast(lw["router"])).topk(m["top_k"], dim=-1)
    gates = torch.softmax(top, dim=-1)                        # [T,k]
    wg, wu, wd = (cast(lw[n]) for n in ("w_gate", "w_up", "w_down"))
    out = torch.zeros_like(x)
    for e in range(m["n_experts"]):
        token, slot = (experts == e).nonzero(as_tuple=True)
        if len(token):
            y = swiglu(x[token], wg[e], wu[e], wd[e])
            out[token] += y * gates[token, slot, None]   # rows unique
    return out.reshape(h.shape)


def shared(sw: dict, h: torch.Tensor, cast: Cast) -> torch.Tensor:
    return swiglu(h, cast(sw["w_gate"]), cast(sw["w_up"]),
                  cast(sw["w_down"]))


# -- the model -------------------------------------------------------------------

def hidden(w: dict, m: dict, tokens: torch.Tensor, cast: Cast = exact
           ) -> torch.Tensor:
    """The residual stream [R,T,d] after the last layer, before the final
    norm, of rows ``tokens`` [R,T]."""
    eps, r = m["norm_eps"], m["residual_multiplier"]
    x = cast(w["embedding"])[tokens] * m["embedding_multiplier"]
    stacks = {"mamba": w.get("mamba_layers"),
              "attention": w.get("attention_layers")}
    mixers = {"mamba": mamba_mixer, "attention": attention}
    for i, (kind, j) in enumerate(layer_kinds(m)):
        lw = {k: v[j] for k, v in stacks[kind].items()}
        x = x + r * mixers[kind](lw, rmsnorm(x, lw["norm1"], eps), m, cast)
        fw = {k: v[i] for k, v in w["moe_layers"].items()}
        sw = {k: v[i] for k, v in w["shared_mlp"].items()}
        h = rmsnorm(x, fw["norm2"], eps)
        x = x + r * (moe(fw, h, m, cast) + shared(sw, h, cast))
    return x


def logits(w: dict, m: dict, x: torch.Tensor, cast: Cast = exact
           ) -> torch.Tensor:
    """Logits [K,vocab] over the real vocabulary of hidden rows x [K,d]."""
    x = rmsnorm(x, w["final_norm"], m["norm_eps"])
    return x @ cast(w["embedding"][:m["vocab"]]).T / m["logits_scaling"]


# -- the work of a served request -------------------------------------------------

def ssm_dims(m: dict) -> tuple[int, int, int, int]:
    """(d_inner, heads, head dim P, state N)."""
    d_inner = m["ssm_expand"] * m["d_model"]
    return d_inner, m["ssm_heads"], d_inner // m["ssm_heads"], m["ssm_state"]


def layer_counts(m: dict) -> tuple[int, int]:
    """(Mamba2 layers, attention layers)."""
    kinds = [kind for kind, _ in layer_kinds(m)]
    return kinds.count("mamba"), kinds.count("attention")


def ssd_shape(m: dict) -> tuple[int, int, int, int]:
    """(SSD launches a batch: one a Mamba2 layer, heads, head dim P, state
    N)."""
    _, h, p, n = ssm_dims(m)
    return layer_counts(m)[0], h, p, n


def attention_shape(m: dict) -> tuple[int, int, int, int]:
    """(flash launches a batch: one an attention layer, heads, KV heads,
    head dim)."""
    return (layer_counts(m)[1], m["n_heads"], m["n_kv_heads"],
            m["head_dim"])


def parameters(m: dict) -> int:
    """The model's parameters, counted from the published architecture:
    the embedding (tied to the head), each Mamba2 layer's in_proj, conv
    taps and bias, A_log, D, dt bias, gated norm, out_proj and input norm,
    each attention layer's four projections and input norm, and every
    layer's router, experts, shared expert and second norm; the final
    norm."""
    d, (d_inner, h, _, n) = m["d_model"], ssm_dims(m)
    conv_ch = d_inner + 2 * n
    mamba = (d * (2 * d_inner + 2 * n + h) + m["conv_width"] * conv_ch
             + conv_ch + 3 * h + d_inner + d_inner * d + d)
    nh, kh, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    attention_layer = 2 * d * hd * (nh + kh) + d
    ffn = (d * m["n_experts"] + 3 * m["n_experts"] * d * m["d_ff"]
           + 3 * d * m["shared_ff"] + d)
    n_mamba, n_attn = layer_counts(m)
    return (m["vocab"] * d + n_mamba * mamba + n_attn * attention_layer
            + m["n_layers"] * ffn + d)


def token_flops(m: dict) -> int:
    """FLOPs of one token through every layer but its attention over the
    context: each matrix product (2 per weight), the SSD at its least work
    (the plain recurrence), the router, the k routed experts and the
    shared expert."""
    d, (d_inner, h, p, n) = m["d_model"], ssm_dims(m)
    mamba = (2 * (d * (2 * d_inner + 2 * n + h) + d_inner * d)
             + 2 * n + h * (2 * p + 4 * n * p))
    nh, kh, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    attention_proj = 2 * d * hd * (2 * nh + 2 * kh)
    ffn = 2 * d * (m["n_experts"] + 3 * m["top_k"] * m["d_ff"]
                   + 3 * m["shared_ff"])
    n_mamba, n_attn = layer_counts(m)
    return (n_mamba * mamba + n_attn * attention_proj
            + m["n_layers"] * ffn)


def head_flops(m: dict) -> int:
    """The output head's FLOPs for one set of logits."""
    return 2 * m["d_model"] * m["vocab"]


def request_flops(m: dict, prompt: int, generated: int) -> int:
    """The model FLOPs one request asked for: its prompt's tokens and the
    ``generated`` tokens fed back through the layers (the padding of its
    batch does not count), each attention layer's scores and sums over the
    positions up to each token's own (4 * head dim per head and visible
    pair), and ``generated + 1`` sets of logits."""
    fed = prompt + generated
    pairs = fed * (fed + 1) // 2
    attention_ctx = (layer_counts(m)[1] * 4 * m["head_dim"] * m["n_heads"]
                     * pairs)
    return (fed * token_flops(m) + attention_ctx
            + (generated + 1) * head_flops(m))
