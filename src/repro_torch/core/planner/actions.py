"""Typed candidate actions the partition planner enumerates and scores (the
port's copy of ``repro.core.planner.actions``).

One action = one concrete way of satisfying a partition request.  The
planner scores every feasible action with the shared cost model
(:mod:`repro_torch.core.planner.cost`) and commits exactly one — so every
placement decision in the repo is explainable as "these actions were
considered, with these costs, and this one won".
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.partition_manager import Partition
from repro_torch.core.partition_state import PartitionProfile, Placement


class Action:
    """Base of all planner actions."""

    def describe(self) -> str:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ReuseIdle(Action):
    """Bind to an existing idle partition of exactly the wanted profile —
    scheme B's first preference: no reconfiguration at all."""

    partition: Partition

    @property
    def profile(self) -> PartitionProfile:
        return self.partition.profile

    def describe(self) -> str:
        return f"reuse idle {self.profile.name}@{self.partition.handle!r}"


@dataclasses.dataclass(frozen=True)
class FreshAllocate(Action):
    """Carve a new partition at the argmax-|F_s| placement (Alg. 3)."""

    placement: Placement

    @property
    def profile(self) -> PartitionProfile:
        return self.placement.profile

    def describe(self) -> str:
        return f"allocate {self.profile.name}@{self.placement.handle!r}"


@dataclasses.dataclass(frozen=True)
class ReshapeFuseFission(Action):
    """Fuse the idle partitions' space back into the FSM and re-carve the
    wanted profile (scheme B's merge/split, paper §4.3) — busy partitions
    are never touched."""

    placement: Placement
    consumed: tuple[Partition, ...]

    @property
    def profile(self) -> PartitionProfile:
        return self.placement.profile

    def describe(self) -> str:
        return (f"fuse/fission {len(self.consumed)} idle -> "
                f"{self.profile.name}@{self.placement.handle!r}")


@dataclasses.dataclass(frozen=True)
class Grow(Action):
    """Release a live partition and re-place its workload on a larger slice
    (serving-engine migration, restart ladders)."""

    released: Partition
    inner: Action  # FreshAllocate or ReshapeFuseFission

    @property
    def profile(self) -> PartitionProfile:
        return self.inner.profile  # type: ignore[union-attr]

    def describe(self) -> str:
        return (f"grow {self.released.profile.name} -> "
                f"{self.inner.describe()}")


@dataclasses.dataclass(frozen=True)
class Shrink(Action):
    """Release a live partition and re-place its workload on a *smaller*
    slice — the symmetric trade to :class:`Grow` (serving-engine
    scale-down): the freed span fissions back into the FSM for neighbours
    to fuse, priced as Joules saved over the forecast-quiet horizon
    against the KV-rebuild cost if the headroom forecast is wrong."""

    released: Partition
    inner: Action  # FreshAllocate or ReshapeFuseFission

    @property
    def profile(self) -> PartitionProfile:
        return self.inner.profile  # type: ignore[union-attr]

    def describe(self) -> str:
        return (f"shrink {self.released.profile.name} -> "
                f"{self.inner.describe()}")


@dataclasses.dataclass(frozen=True)
class Migrate(Action):
    """Fleet level: a restarted job lands on a *different* device than its
    previous run (the A100 job that outgrows 40GB restarting on an H100).
    Cluster level: ``zone`` names the destination fleet and
    ``data_movement_s`` is the checkpoint transfer the move paid — the
    hierarchical router types every cross-zone move as one of these."""

    device: str
    inner: Action
    zone: str = ""
    data_movement_s: float = 0.0

    def describe(self) -> str:
        dest = self.device
        if self.zone and not dest.startswith(f"{self.zone}/"):
            dest = f"{self.zone}/{dest}"
        tail = (f" (+{self.data_movement_s:.1f}s checkpoint move)"
                if self.data_movement_s else "")
        return f"migrate to {dest}: {self.inner.describe()}{tail}"


@dataclasses.dataclass(frozen=True)
class Wait(Action):
    """Nothing feasible right now — sleep until a finish/reconfig event
    frees capacity (Alg. 5's SLEEP)."""

    reason: str = ""

    def describe(self) -> str:
        return f"wait ({self.reason})" if self.reason else "wait"
