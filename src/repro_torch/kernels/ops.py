"""Model-layout adapters around the kernels: the model code calls these.

They move the model layout ([B,S,H,D]) to the kernel layout where the
kernel needs another, pad ragged sequence lengths to the kernel's block or
chunk, and cut the pad off the result.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import BLOCK, flash_attention, route
from repro_torch.kernels.ssd_scan import ssd_scan


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None) -> torch.Tensor:
    """Model-layout flash attention, the scores times ``scale`` (default
    1/sqrt(hd)) before the softmax.

    q: [B,S,H,hd]; k/v: [B,S,KH,hd] -> [B,S,H,hd].  S is zero-padded up to
    a multiple of the kernel block; the kernel hides the padded keys
    (``kv_len=S``) whether or not the call is causal, and the padded query
    rows are cut off.  The sm90 route reads the [B,S,H,hd] tensors through
    transposed views and writes its output in [B,S,H,hd], so it copies
    nothing when S is a block multiple; the simt route takes contiguous
    [B,H,S,hd] copies.
    """
    s = q.shape[1]
    pad = (-s) % BLOCK
    strided = route(q.dtype, q.shape[-1]) == "sm90"

    def to_kernel(x: torch.Tensor) -> torch.Tensor:
        if pad:
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
        x = x.transpose(1, 2)
        return x if strided else x.contiguous()

    out = flash_attention(to_kernel(q), to_kernel(k), to_kernel(v),
                          causal=causal, window=window, kv_len=s,
                          scale=scale)
    return out.transpose(1, 2)[:, :s]


def ssd_mixer(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b_in: torch.Tensor, c_in: torch.Tensor, *, chunk: int = 128
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Model-layout SSD: x [B,S,H,P], dt [B,S,H], a [H], b/c [B,S,N] ->
    (y [B,S,H,P], final state [B,H,P,N]).

    Pads S to a chunk multiple with dt = 0 and zero x, b and c: a zero dt
    decays by exp(0) = 1 and injects nothing, so the pad is exact for y
    and for the final state.  The chunk is cut to the padded length.
    """
    s = x.shape[1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_in = F.pad(b_in, (0, 0, 0, pad))
        c_in = F.pad(c_in, (0, 0, 0, pad))
    y, state = ssd_scan(x.contiguous(), dt.contiguous(), a.contiguous(),
                        b_in.contiguous(), c_in.contiguous(),
                        chunk=min(chunk, x.shape[1]))
    return y[:, :s], state
