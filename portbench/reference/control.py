"""The control: the reference with every weight matrix rounded to 8-bit
floating point (e4m3, one scale per tensor), the step below the bfloat16
that the configurations state.  A limit on the served tokens' logit gap
must fail it (see ``portbench/README.md``)."""

from __future__ import annotations

import torch

#: the largest finite e4m3 value
E4M3_MAX = 448.0


def fp8(w: torch.Tensor) -> torch.Tensor:
    """w rounded to e4m3 under a per-tensor scale, back in float32."""
    x = w.float()
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale
