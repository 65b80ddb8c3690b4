"""The benchmark's plain reference and its lower-precision control.

Each configuration file names its model module here (``"reference":
"<module>"``); the harness loads ``reference/<module>.py`` by that name.
A model module gives, in plain float32 PyTorch that imports nothing of
the program:

- ``hidden(weights, m, tokens, cast)``: the residual stream after the
  last layer of rows ``tokens`` [R,T];
- ``logits(weights, m, x, cast)``: the logits over the real vocabulary of
  hidden rows x [K,d];
- ``request_flops(m, prompt, generated)``: the model FLOPs one served
  request asked for (read by the ``mfu`` metric);
- where its layers launch the SSD kernel, ``ssd_shape(m)``: (layers a
  batch, heads, head dim P, state N) (read by ``ssd_scan_roofline``).

``m`` is the configuration's ``model`` block.  ``cast`` turns a weight
matrix into the float32 values its products use: :func:`exact` for the
reference, a lower precision for the control (:mod:`.control`).
"""

from __future__ import annotations

from typing import Callable

import torch

Cast = Callable[[torch.Tensor], torch.Tensor]


def exact(w: torch.Tensor) -> torch.Tensor:
    return w.float()


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()
