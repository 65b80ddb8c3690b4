"""Mamba2 (state-space duality) mixer: chunked SSD prefill and recurrent
decode (arXiv:2405.21060), with the hand-written SSD chunk-scan kernel for
the full-sequence path (``ssm_impl == 'pallas'``, kernels/ops.ssd_mixer)
and, on the same switch, the hand-written state-update kernel for the
decode step (kernels/ssm_state_update.py), which on the card updates the
state cache in place.

Shapes: d_inner = expand * d_model, H heads of dim P = d_inner/H, state N.
The SSD computation per chunk of length Q:

    dA      = a * dt                          (a = -exp(A_log) < 0)
    L[j,i]  = exp(csum[j] - csum[i])  (i<=j)  intra-chunk decay
    Y_intra = ((C Bᵀ) ⊙ L) @ (dt ⊙ x)
    S_chunk = Σ_i exp(csum[Q]-csum[i]) dt_i B_i ⊗ x_i
    Y_inter = exp(csum[j]) C_j · S_prev
    S_next  = exp(csum[Q]) S_prev + S_chunk

Each function keeps the reference's dtypes (``repro/models/ssm.py``): the
forward's conv multiplies and sums in the activation dtype, decode's conv
runs in f32 over the f32 cache, and the forward adds ``D * x`` after y is
cast to x's dtype where decode adds it in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ssm_state_update import (ssm_state_update,
                                                  ssm_state_update_ref)
from repro_torch.models.layers import rmsnorm
from repro_torch.models.module import ParamBuilder
from repro_torch.sharding.partitioning import constrain


def ssm_dims(cfg: ModelConfig) -> tuple[int, int, int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    nheads = cfg.ssm_heads or max(1, d_inner // 64)
    p = d_inner // nheads
    return d_inner, nheads, p, cfg.ssm_state


def init_ssm(b: ParamBuilder, cfg: ModelConfig,
             stacked: int | None = None) -> None:
    d = cfg.d_model
    d_inner, h, p, n = ssm_dims(cfg)
    conv_ch = d_inner + 2 * n
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    b.add("in_proj", lead + (d, 2 * d_inner + 2 * n + h),
          lx + ("embed", "ssm_inner"))
    b.add("conv_w", lead + (cfg.conv_width, conv_ch),
          lx + ("conv", "ssm_inner"))
    b.add("conv_b", lead + (conv_ch,), lx + ("ssm_inner",), init="zeros")
    b.add("A_log", lead + (h,), lx + ("norm",), init="zeros")
    b.add("D", lead + (h,), lx + ("norm",), init="ones")
    b.add("dt_bias", lead + (h,), lx + ("norm",), init="zeros")
    b.add("norm", lead + (d_inner,), lx + ("ssm_inner",), init="ones")
    b.add("out_proj", lead + (d_inner, d), lx + ("ssm_inner", "embed"))


def _split_proj(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """(z [..., d_inner], xbc [..., d_inner + 2N], dt [..., H])."""
    d_inner, h, p, n = ssm_dims(cfg)
    proj = torch.matmul(x, params["in_proj"])
    return torch.split(proj, [d_inner, d_inner + 2 * n, h], dim=-1)


def _causal_conv(xbc: torch.Tensor, params: dict,
                 cfg: ModelConfig) -> torch.Tensor:
    w = params["conv_w"]                                  # [W, ch]
    width = w.shape[0]
    s = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(width))
    return F.silu((out + params["conv_b"]).float()).to(xbc.dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                B_in: torch.Tensor, C_in: torch.Tensor, chunk: int,
                state0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Core SSD over a full sequence, in plain PyTorch.

    x: [B,S,H,P]; dt: [B,S,H] (post-softplus); a: [H] (negative);
    B_in/C_in: [B,S,N].  Returns (y [B,S,H,P], final_state [B,H,P,N]).
    The chunk is halved until it divides S, as in the reference.
    """
    b_, s, h, p = x.shape
    n = B_in.shape[-1]
    q = min(chunk, s)
    while s % q != 0:
        q //= 2
    nc = s // q

    xc = x.reshape(b_, nc, q, h, p)
    dtc = dt.reshape(b_, nc, q, h).float()
    bc = B_in.reshape(b_, nc, q, n).float()
    cc = C_in.reshape(b_, nc, q, n).float()
    a = a.float()
    state = (torch.zeros((b_, h, p, n), dtype=torch.float32,
                         device=x.device) if state0 is None else state0)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    ys = []
    for c in range(nc):
        xq, dtq, bq, cq = xc[:, c], dtc[:, c], bc[:, c], cc[:, c]
        da = dtq * a                                      # [B,q,H]
        csum = torch.cumsum(da, dim=1)                    # [B,q,H]
        total = csum[:, -1:, :]                           # [B,1,H]
        # intra-chunk: scores[j,i] = C_j.B_i * exp(csum_j - csum_i), i<=j
        seg = csum[:, :, None, :] - csum[:, None, :, :]   # [B,q,q,H]
        l_mat = torch.where(causal[None, :, :, None], torch.exp(seg), 0.0)
        cb = torch.einsum("bjn,bin->bji", cq, bq)         # [B,q,q]
        scores = cb[:, :, :, None] * l_mat                # [B,q(j),q(i),H]
        dx = dtq[..., None] * xq.float()                  # [B,q,H,P]
        y_intra = torch.einsum("bjih,bihp->bjhp", scores, dx)
        # inter-chunk: contribution of the carried state
        y_inter = (torch.einsum("bjn,bhpn->bjhp", cq, state)
                   * torch.exp(csum)[..., None])
        # state update
        decay_to_end = torch.exp(total - csum)            # [B,q,H]
        s_chunk = torch.einsum("bihp,bin,bih->bhpn", dx, bq, decay_to_end)
        state = torch.exp(total)[:, 0, :, None, None] * state + s_chunk
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(b_, s, h, p)
    return y, state


def _mix(params: dict, x: torch.Tensor, cfg: ModelConfig
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The full-sequence mixer: (out [B,S,d], pre-conv xbc [B,S,ch],
    final SSD state [B,H,P,N] f32)."""
    d_inner, h, p, n = ssm_dims(cfg)
    b_, s, _ = x.shape
    z, xbc, dt = _split_proj(params, x, cfg)
    conv = _causal_conv(xbc, params, cfg)
    x_ssm, b_ssm, c_ssm = torch.split(conv, [d_inner, n, n], dim=-1)
    x_heads = x_ssm.reshape(b_, s, h, p)
    x_heads = constrain(x_heads, ("batch", "seq", "ssm_inner", None))
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["A_log"].float())
    if cfg.ssm_impl == "pallas":
        y, state = ops.ssd_mixer(x_heads, dt, a, b_ssm.float(),
                                 c_ssm.float(), chunk=cfg.ssm_chunk)
    else:
        y, state = ssd_chunked(x_heads, dt, a, b_ssm, c_ssm, cfg.ssm_chunk)
    y = y + params["D"].to(y.dtype)[None, None, :, None] * x_heads
    y = y.reshape(b_, s, d_inner)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rmsnorm(y, params["norm"], cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"])
    return constrain(out, ("batch", "seq", None)), xbc, state


def ssm_forward(params: dict, x: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 mixer (training / prefill)."""
    return _mix(params, x, cfg)[0]


def ssm_prefill(params: dict, x: torch.Tensor, cfg: ModelConfig,
                conv_cache: torch.Tensor,
                state_cache: torch.Tensor) -> torch.Tensor:
    """:func:`ssm_forward` that also writes, in place, the caches a replay
    of the prompt through :func:`ssm_decode_step` would leave: the last
    ``conv_width - 1`` pre-conv rows (in the cache dtype, zero rows in
    front of a shorter prompt) and the SSD's final state."""
    out, xbc, state = _mix(params, x, cfg)
    keep = cfg.conv_width - 1
    tail = xbc[:, max(0, xbc.shape[1] - keep):]
    conv_cache.zero_()
    conv_cache[:, keep - tail.shape[1]:] = tail.to(conv_cache.dtype)
    state_cache.copy_(state)
    return out


# -- recurrent decode ----------------------------------------------------------

def init_ssm_cache(cfg: ModelConfig, n_layers: int, batch: int,
                   dtype: torch.dtype = torch.float32,
                   device: str | torch.device = "cpu") -> dict:
    d_inner, h, p, n = ssm_dims(cfg)
    conv_ch = d_inner + 2 * n
    return {
        "conv": torch.zeros((n_layers, batch, cfg.conv_width - 1, conv_ch),
                            dtype=dtype, device=device),
        "state": torch.zeros((n_layers, batch, h, p, n), dtype=dtype,
                             device=device),
    }


def ssm_decode_step(params: dict, x: torch.Tensor, cache_conv: torch.Tensor,
                    cache_state: torch.Tensor, cfg: ModelConfig):
    """One-token step. x:[B,1,d]; cache_conv:[B,W-1,ch];
    cache_state:[B,H,P,N].  Returns (y, cache_conv, cache_state): the conv
    window as a new tensor; the state, with ``ssm_impl == 'pallas'`` on
    the card, ``cache_state`` itself updated in place by the state-update
    kernel, else a new tensor from the plain version
    (:mod:`repro_torch.kernels.ssm_state_update`)."""
    d_inner, h, p, n = ssm_dims(cfg)
    b_ = x.shape[0]
    z, xbc, dt = _split_proj(params, x, cfg)
    xbc = xbc[:, 0]                                     # [B, ch]
    # conv over the cached window, in the cache's dtype (f32)
    w = params["conv_w"]
    window = torch.cat([cache_conv, xbc[:, None, :].to(cache_conv.dtype)],
                       dim=1)
    conv = (window * w[None]).sum(dim=1) + params["conv_b"]
    conv = F.silu(conv.float()).to(x.dtype)
    cache_conv = window[:, 1:, :]
    x_ssm, b_ssm, c_ssm = torch.split(conv, [d_inner, n, n], dim=-1)
    update = (ssm_state_update if cfg.ssm_impl == "pallas"
              else ssm_state_update_ref)
    y, state = update(cache_state, x_ssm.reshape(b_, h, p), dt[:, 0],
                      params["dt_bias"], params["A_log"], params["D"], b_ssm,
                      c_ssm)
    y = y.reshape(b_, 1, d_inner).to(x.dtype)
    y = y * F.silu(z.float()).to(y.dtype)
    y = rmsnorm(y, params["norm"], cfg.norm_eps)
    out = torch.matmul(y, params["out_proj"])
    return constrain(out, ("batch", "seq", None)), cache_conv, state
