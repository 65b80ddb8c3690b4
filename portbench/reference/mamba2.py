"""The plain reference of the Mamba2 language model (arXiv:2405.21060) in
float32 PyTorch, and the work its served requests ask for.

It reads the weights the benchmark made, in the layout the served program
takes them (nested dicts of stacked tensors), and works out everything
else itself: no kernel, no cache, no batching trick.  Each row of tokens
runs as one causal sequence; every layer is computed over the whole row at
once, the weights of a layer cast to float32 as the layer is reached, so
that the model's weights need not be held twice.  Vectors (norms, biases,
the SSM's A, D and dt bias) and the conv taps are always read exactly.

The SSD is the recurrence S_t = exp(dt_t a) S_{t-1} + dt_t x_t B_t^T,
y_t = S_t C_t + D x_t, computed in chunks of ``SSD_CHUNK`` rows (the sum
inside a chunk in closed form, the state carried from chunk to chunk).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import Cast, exact, rmsnorm

SSD_CHUNK = 64


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


def hidden(w: dict, m: dict, tokens: torch.Tensor, cast: Cast = exact
           ) -> torch.Tensor:
    """The residual stream [R,T,d] after the last layer, before the final
    norm, of rows ``tokens`` [R,T]."""
    x = cast(w["embedding"])[tokens]
    for i in range(m["n_layers"]):
        lw = {k: v[i] for k, v in w["layers"].items()}
        x = x + mamba_mixer(lw, rmsnorm(x, lw["norm1"], m["norm_eps"]), m,
                            cast)
    return x


def logits(w: dict, m: dict, x: torch.Tensor, cast: Cast = exact
           ) -> torch.Tensor:
    """Logits [K,vocab] over the real vocabulary of hidden rows x [K,d]."""
    x = rmsnorm(x, w["final_norm"], m["norm_eps"])
    if m["tie_embeddings"]:
        return x @ cast(w["embedding"][:m["vocab"]]).T
    return x @ cast(w["unembed"][:, :m["vocab"]])


# -- the work of a served request ---------------------------------------------

def ssm_dims(m: dict) -> tuple[int, int, int, int]:
    """(d_inner, heads, head dim P, state N)."""
    d_inner = m["ssm_expand"] * m["d_model"]
    return d_inner, m["ssm_heads"], d_inner // m["ssm_heads"], m["ssm_state"]


def ssd_shape(m: dict) -> tuple[int, int, int, int]:
    """(SSD launches a batch: one a layer, heads, head dim P, state N)."""
    _, h, p, n = ssm_dims(m)
    return m["n_layers"], h, p, n


def matmul_params(m: dict) -> int:
    """Weights of one layer's two matrix products."""
    d, (d_inner, h, _, n) = m["d_model"], ssm_dims(m)
    return d * (2 * d_inner + 2 * n + h) + d_inner * d


def token_flops(m: dict) -> int:
    """FLOPs of one token through every layer: each matrix product (2 per
    weight) and the SSD at its least work (the plain recurrence: 2 N P per
    head for the state update and as much for C . state, C B^T and the
    score times dt x at one pair)."""
    _, h, p, n = ssm_dims(m)
    ssd_flops = 2 * n + h * (2 * p + 4 * n * p)
    return m["n_layers"] * (2 * matmul_params(m) + ssd_flops)


def head_flops(m: dict) -> int:
    """The output head's FLOPs for one set of logits (the real vocabulary,
    not its padding)."""
    return 2 * m["d_model"] * m["vocab"]


def request_flops(m: dict, prompt: int, generated: int) -> int:
    """The model FLOPs one request asked for.  The engine takes the first
    token from the prefill's logits and then runs one decode step for each
    of the ``generated`` tokens it returns, so the prompt's tokens and
    ``generated`` more go through the layers (the padding of its batch
    does not count), and ``generated + 1`` sets of logits are used."""
    return ((prompt + generated) * token_flops(m)
            + (generated + 1) * head_flops(m))
