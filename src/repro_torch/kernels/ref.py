"""Plain PyTorch versions of the kernels (the allclose targets)."""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  kv_len: int | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """q: [B,H,Sq,D]; k/v: [B,KH,Sk,D].  Direct softmax attention in f32,
    the scores times ``scale`` (default 1/sqrt(D)).

    ``kv_len`` hides keys at positions >= kv_len (zero padding); None keeps
    every key, as the reference oracle does.  Fully masked rows give 0.
    """
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    g = h // kh
    k = torch.repeat_interleave(k, g, dim=1)
    v = torch.repeat_interleave(v, g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    s = s / math.sqrt(d) if scale is None else s * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    if kv_len is not None:
        mask &= k_pos < kv_len
    s = torch.where(mask, s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)  # fully-masked rows
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
            b_in: torch.Tensor, c_in: torch.Tensor,
            state0: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential (non-chunked) SSD recurrence, the exact oracle.

    x: [B,S,H,P]; dt: [B,S,H] (post-softplus); a: [H] (negative);
    b_in/c_in: [B,S,N].  Returns (y [B,S,H,P] in x's dtype, final_state
    [B,H,P,N] in f32).
    """
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if state0 is None
             else state0.float())
    dt = dt.float()
    ys = []
    for t in range(s):
        decay = torch.exp(dt[:, t] * a)                          # [B,H]
        inject = torch.einsum("bhp,bn->bhpn",
                              dt[:, t, :, None] * x[:, t].float(),
                              b_in[:, t].float())
        state = state * decay[..., None, None] + inject
        ys.append(torch.einsum("bhpn,bn->bhp", state, c_in[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), state
