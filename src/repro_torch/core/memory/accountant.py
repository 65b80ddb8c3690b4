"""Allocator instrumentation (paper §3.2.2): per-iteration memory series.

The paper intercepts PyTorch's caching allocator to record every memory
request.  :class:`MemoryAccountant` tracks, per workload iteration,

* ``requested_bytes`` — cumulative bytes requested (every tensor the job
  reports, temporaries included), and
* ``in_use_bytes``    — peak live bytes this iteration,

and derives ``reuse_ratio = in_use / requested``.  Jobs (the serving
engine) call :meth:`note_alloc` / :meth:`note_live` per iteration.  The
semantics are the reference's (``repro.core.memory.accountant``); trees
here are nested dicts and lists of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


def pytree_nbytes(tree: Any) -> int:
    """Total bytes of all tensor leaves in nested dicts / lists / tuples."""
    if isinstance(tree, dict):
        return sum(pytree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(pytree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def spec_nbytes(tree: Any) -> int:
    """Bytes for a tree of ``meta`` tensors (no allocation): the same sum
    as :func:`pytree_nbytes`, which reads only shapes and dtypes."""
    return pytree_nbytes(tree)


@dataclasses.dataclass
class IterationStats:
    iteration: int
    requested_bytes: float
    in_use_bytes: float

    @property
    def reuse_ratio(self) -> float:
        return self.in_use_bytes / max(self.requested_bytes, 1.0)


class MemoryAccountant:
    """Per-job allocator statistics, one record per workload iteration."""

    def __init__(self) -> None:
        self.history: list[IterationStats] = []
        self._iter_requested = 0.0
        self._iter_peak_live = 0.0
        self._cum_requested = 0.0

    # -- per-iteration recording ----------------------------------------------

    def note_alloc(self, tree_or_bytes: Any) -> None:
        """Record a memory request (a tree of tensors, or raw bytes)."""
        n = (float(tree_or_bytes) if isinstance(tree_or_bytes, (int, float))
             else float(pytree_nbytes(tree_or_bytes)))
        self._iter_requested += n

    def note_live(self, tree_or_bytes: Any) -> None:
        """Record the current live working set; peak is kept per iteration."""
        n = (float(tree_or_bytes) if isinstance(tree_or_bytes, (int, float))
             else float(pytree_nbytes(tree_or_bytes)))
        self._iter_peak_live = max(self._iter_peak_live, n)

    def end_iteration(self) -> IterationStats:
        self._cum_requested += self._iter_requested
        stats = IterationStats(iteration=len(self.history),
                               requested_bytes=self._cum_requested,
                               in_use_bytes=self._iter_peak_live)
        self.history.append(stats)
        self._iter_requested = 0.0
        self._iter_peak_live = 0.0
        return stats

    # -- predictor feed ---------------------------------------------------------

    def series(self) -> tuple[list[float], list[float]]:
        req = [s.requested_bytes for s in self.history]
        reuse = [s.reuse_ratio for s in self.history]
        return req, reuse

    @property
    def peak_in_use(self) -> float:
        return max((s.in_use_bytes for s in self.history), default=0.0)
