"""Partition State Machine abstractions (paper §4.2).

The paper formalizes MIG management as an FSM  M = (S, Sigma, delta, s0, F):

* ``S``      — valid partition states of the device,
* ``Sigma``  — {alloc(x), free(x)} over valid partition sizes ``x``,
* ``delta``  — legal transitions,
* ``s0``     — the unpartitioned device,
* ``F``      — fully configured states.

The port's copy of ``repro.core.partition_state``, unchanged in behaviour.
Its backends are the MIG span FSMs of the two cards the paper uses, the
H100 (:mod:`repro_torch.core.mig_h100`), on which the port runs, and the
A100 (:mod:`repro_torch.core.mig_a100`).
"""

from __future__ import annotations

import dataclasses
from typing import Hashable, Sequence


@dataclasses.dataclass(frozen=True)
class PartitionProfile:
    """One allocatable partition size (paper: a MIG profile such as 1g.5gb)."""

    name: str
    mem_gb: float
    compute_fraction: float  # fraction of the device's compute
    # Backend-specific payload (e.g. GPC span for A100, chip count for TPU).
    extent: int = 1

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Profile({self.name}: {self.mem_gb}GB, {self.compute_fraction:.2f}c)"


@dataclasses.dataclass(frozen=True)
class Placement:
    """A concrete way of serving alloc(x) from a state: the successor state."""

    profile: PartitionProfile
    handle: Hashable  # backend-specific identifier of the placed partition
    next_state: Hashable


class PartitionBackend:
    """Interface every device backend implements."""

    #: Profiles in increasing memory order; schedulers rely on the ordering
    #: for tightest-fit and next-larger-on-OOM lookups (paper §2.3, §4.3).
    profiles: Sequence[PartitionProfile]

    #: True when the state space is small enough to intern as a compiled
    #: transition graph (:mod:`repro_torch.core.planner.graph`).
    supports_compiled_graph: bool = False

    def initial_state(self) -> Hashable:
        """s0 — the unpartitioned device."""
        raise NotImplementedError

    def enumerate_placements(self, state: Hashable, profile: PartitionProfile
                             ) -> list[Placement]:
        """All legal ways to serve alloc(profile) from ``state`` (Alg. 3's C)."""
        raise NotImplementedError

    def free(self, state: Hashable, handle: Hashable) -> Hashable:
        """delta(state, free(handle)) — deallocation (paper: 'trivial')."""
        raise NotImplementedError

    def reachability(self, state: Hashable) -> int:
        """|F_s| — number of fully configured states reachable from ``state``."""
        raise NotImplementedError

    def total_mem_gb(self) -> float:
        raise NotImplementedError

    def total_compute(self) -> float:
        return 1.0

    # -- helpers shared by schedulers -------------------------------------

    def tightest_profile(self, mem_gb: float, compute: float = 0.0
                         ) -> PartitionProfile | None:
        """Smallest profile meeting a memory (hard) + compute (soft) need.

        Compute is a *soft* constraint in the paper (§4.3 'warp folding'):
        we first try to satisfy both, then fall back to memory only.
        """
        for p in self.profiles:
            if p.mem_gb >= mem_gb and p.compute_fraction >= compute:
                return p
        for p in self.profiles:
            if p.mem_gb >= mem_gb:
                return p
        return None

    def next_larger_profile(self, profile: PartitionProfile
                            ) -> PartitionProfile | None:
        """The next-larger-memory profile — OOM restart target (paper §4.3)."""
        for p in self.profiles:
            if p.mem_gb > profile.mem_gb:
                return p
        return None


def saturated(backend: PartitionBackend, state: Hashable) -> bool:
    """True iff no further allocation is possible — ``state`` is in F."""
    return all(not backend.enumerate_placements(state, p)
               for p in backend.profiles)


def enumerate_states(backend: PartitionBackend,
                     max_states: int | None = None) -> set[Hashable]:
    """BFS over delta from s0 (used by Alg. 2 for small backends)."""
    seen: set[Hashable] = set()
    frontier: list[Hashable] = [backend.initial_state()]
    seen.add(backend.initial_state())
    while frontier:
        state = frontier.pop()
        for profile in backend.profiles:
            for placement in backend.enumerate_placements(state, profile):
                nxt = placement.next_state
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
                    if max_states is not None and len(seen) > max_states:
                        raise RuntimeError(
                            f"state space exceeded {max_states}; use a "
                            f"closed-form reachability backend instead")
    return seen
