"""Model-layout adapters around the kernels: the model code calls these.

They move the model layout ([B,S,H,D]) to the kernel layout ([B,H,S,D]),
pad ragged sequence lengths to the kernel's block, and cut the pad off the
result.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import BLOCK, flash_attention


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None) -> torch.Tensor:
    """Model-layout flash attention.

    q: [B,S,H,hd]; k/v: [B,S,KH,hd] -> [B,S,H,hd].  S is zero-padded up to
    a multiple of the kernel block; the kernel hides the padded keys
    (``kv_len=S``) whether or not the call is causal, and the padded query
    rows are cut off.
    """
    s = q.shape[1]
    pad = (-s) % BLOCK

    def to_kernel(x: torch.Tensor) -> torch.Tensor:
        if pad:
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
        return x.transpose(1, 2).contiguous()

    out = flash_attention(to_kernel(q), to_kernel(k), to_kernel(v),
                          causal=causal, window=window, kv_len=s)
    return out.transpose(1, 2)[:, :s]
