"""Third-party workspace estimation (paper §3.2.2); the port's copy of
``repro.core.memory.workspace``.

The paper discounts cuDNN/cuBLAS workspace buffers from the time-series fit
because they do not grow with context; it parses environment knobs (e.g.
``CUBLAS_WORKSPACE_CONFIG=:4096:8``) and walks model layers to aggregate
per-layer workspace.  Like the paper we treat it as a constant per
workload, estimated from the cuBLAS knob or a per-layer walk.  The
reference's third estimate, ``xla_scratch_bytes``, reads an XLA
executable's ``memory_analysis()``; its counterpart here,
:func:`scratch_bytes`, reads a step traced on ``meta`` by
:func:`repro_torch.launch.op_count.analyze`.
"""

from __future__ import annotations

import os
import re


def parse_cublas_workspace_config(value: str | None = None) -> int:
    """Parse ``:SIZE_KIB:COUNT[,:SIZE:COUNT...]`` -> total bytes (paper's
    exact mechanism, kept for the faithful A100 backend)."""
    if value is None:
        value = os.environ.get("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    total = 0
    for m in re.finditer(r":(\d+):(\d+)", value):
        size_kib, count = int(m.group(1)), int(m.group(2))
        total += size_kib * 1024 * count
    return total


def scratch_bytes(analysis: dict) -> int:
    """Working set of a traced step above its arguments: the peak of live
    bytes while it ran less the arguments' bytes (``analysis`` is what
    :func:`repro_torch.launch.op_count.analyze` returns).  It is the eager
    path's own working set (outputs live at the peak included), not XLA's
    buffer assignment."""
    return int(analysis["peak_bytes"] - analysis["argument_bytes"])


def per_layer_workspace_walk(n_layers: int, d_model: int,
                             bytes_per_unit: float = 2.0,
                             multiplier: float = 4.0) -> int:
    """Layer-walk fallback (paper: 'walks through model layers, estimates
    per-layer workspace sizes, and aggregates')."""
    return int(n_layers * multiplier * d_model * bytes_per_unit)


#: fixed CUDA-context / TPU-runtime overhead, constant per workload (§3.2.2)
RUNTIME_CONTEXT_BYTES = 600 * 1024 * 1024
