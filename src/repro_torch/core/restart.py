"""Restart policies (paper §2.3, §4.3, §6), the port's copy.

* **OOM restart** — the job crashed; requeue it on the next-larger profile.
* **Early restart** — the time-series predictor's converged peak estimate
  exceeds the current partition; preempt now and requeue on the tightest
  profile that holds the predicted peak.

The two targets are the planner's restart rungs
(:mod:`repro_torch.core.planner.ladders`), as in the reference.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core.partition_state import (PartitionBackend,
                                              PartitionProfile)
from repro_torch.core.planner.ladders import predicted_rung, restart_rung
from repro_torch.models.module import tree_map


def oom_restart_target(backend: PartitionBackend,
                       current: PartitionProfile) -> PartitionProfile:
    """Next-larger slice after a crash; the largest profile stays itself."""
    return restart_rung(backend, current)


def early_restart_target(backend: PartitionBackend,
                         predicted_peak_gb: float,
                         headroom: float = 1.0) -> PartitionProfile | None:
    """Tightest slice that holds the predicted peak (+ optional headroom);
    None when nothing on this device fits."""
    return predicted_rung(backend, predicted_peak_gb, headroom)


def migrate_state(state: Any, device: str | torch.device) -> Any:
    """Move a job's tree of tensors to the new slice's device."""
    return tree_map(
        lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, state)


def with_oom_retry(run_step: Callable[..., Any], *,
                   backend: PartitionBackend,
                   profile: PartitionProfile,
                   max_retries: int = 4) -> Callable[..., Any]:
    """Wrap a step callable with grow-on-OOM semantics: a CUDA
    out-of-memory error becomes :class:`NeedsLargerPartition` carrying the
    next profile, which the scheduler handles as a requeue.
    ``max_retries`` is the reference's keyword, accepted and, as there,
    not read: the requeue loop belongs to the scheduler."""

    def wrapped(*args, **kwargs):
        try:
            return run_step(*args, **kwargs)
        except torch.cuda.OutOfMemoryError as e:
            raise NeedsLargerPartition(
                oom_restart_target(backend, profile)) from e

    return wrapped


class NeedsLargerPartition(RuntimeError):
    def __init__(self, profile: PartitionProfile | None = None) -> None:
        super().__init__(f"restart on "
                         f"{profile.name if profile else 'a larger slice'}")
        self.profile = profile
