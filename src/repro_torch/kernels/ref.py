"""Plain PyTorch versions of the kernels (the allclose targets)."""

from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  kv_len: int | None = None) -> torch.Tensor:
    """q: [B,H,Sq,D]; k/v: [B,KH,Sk,D].  Direct softmax attention in f32.

    ``kv_len`` hides keys at positions >= kv_len (zero padding); None keeps
    every key, as the reference oracle does.  Fully masked rows give 0.
    """
    b, h, sq, d = q.shape
    kh, sk = k.shape[1], k.shape[2]
    g = h // kh
    k = torch.repeat_interleave(k, g, dim=1)
    v = torch.repeat_interleave(v, g, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
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
