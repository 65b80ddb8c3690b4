"""Dynamic partition manager (paper §4.2, Algorithm 3), the port's copy of
``repro.core.partition_manager``.

    function ALLOCATE_PARTITION(s, x, fcr)
        C <- ENUMERATE_PLACEMENTS(s, x)
        if C = empty: return FAIL
        s* <- ARGMAX(t in C, fcr[t])
        return s*

The manager owns the live FSM state, serves tight partitions to the
schedulers, and implements partition *fusion* and *fission* (scheme B's
merge/split path).  It is backend-agnostic: the H100's MIG FSM, which the
port's multi-tenant launcher leases from, or the A100's.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Hashable

from repro_torch.core.partition_state import (PartitionBackend,
                                              PartitionProfile, Placement)

_UNSET = object()   # lazy transition-graph sentinel


@dataclasses.dataclass
class Partition:
    """A live partition leased to a job."""

    pid: int
    profile: PartitionProfile
    handle: Hashable
    busy: bool = False


class PartitionManager:
    """Owns the device FSM state; allocation maximizes |F_s| (Alg. 3)."""

    def __init__(self, backend: PartitionBackend,
                 use_compiled_graph: bool = True) -> None:
        self.backend = backend
        self.state: Hashable = backend.initial_state()
        self.live: dict[int, Partition] = {}
        self._pid = itertools.count()
        self.n_reconfigs = 0  # fission/fusion + fresh allocations (metric)
        self._graph = _UNSET if use_compiled_graph else None

    @property
    def graph(self):
        """The backend's compiled transition graph (None for backends whose
        state space cannot be enumerated); compiled lazily, cached per
        device table process-wide."""
        if self._graph is _UNSET:
            from repro_torch.core.planner.graph import \
                compile_transition_graph
            self._graph = compile_transition_graph(self.backend)
        return self._graph

    # -- queries -------------------------------------------------------------

    def idle_partition_with(self, profile: PartitionProfile) -> Partition | None:
        """An existing idle partition of exactly this profile (tight fit
        without touching the FSM — scheme B's first preference)."""
        for part in self.live.values():
            if not part.busy and part.profile.name == profile.name:
                return part
        return None

    def idle_partitions(self) -> list[Partition]:
        return [p for p in self.live.values() if not p.busy]

    # -- Algorithm 3 -----------------------------------------------------------

    def best_placement(self, state: Hashable, profile: PartitionProfile
                       ) -> Placement | None:
        """Alg. 3's argmax-|F_s| placement for a *hypothetical* state —
        one dict lookup on compiled backends, direct enumeration otherwise.
        Evaluation only: nothing is committed."""
        graph = self.graph
        if graph is not None:
            return graph.best_placement(state, profile)
        placements = self.backend.enumerate_placements(state, profile)
        if not placements:
            return None
        return max(placements, key=lambda pl: self.backend.reachability(
            pl.next_state))

    def reach(self, state: Hashable) -> int:
        """|F_s| of a (possibly hypothetical) state, via the graph when
        compiled."""
        graph = self.graph
        if graph is not None:
            return graph.reach(state)
        return self.backend.reachability(state)

    def allocate(self, profile: PartitionProfile) -> Partition | None:
        """alloc(x): argmax-reachability placement, or None (FAIL)."""
        best = self.best_placement(self.state, profile)
        if best is None:
            return None
        return self._commit(best)

    def _commit(self, placement: Placement) -> Partition:
        self.state = placement.next_state
        part = Partition(pid=next(self._pid), profile=placement.profile,
                         handle=placement.handle)
        self.live[part.pid] = part
        self.n_reconfigs += 1
        return part

    def commit_placement(self, placement: Placement) -> Partition:
        """Commit an externally-chosen :class:`Placement` — the public hook
        the planner's ``execute`` and the look-ahead carve go through.
        Accounting matches ``allocate`` exactly: one reconfiguration per
        committed slice."""
        return self._commit(placement)

    def release(self, part: Partition) -> None:
        """free(x) — trivial online deallocation (paper §4.2)."""
        self.state = self.backend.free(self.state, part.handle)
        del self.live[part.pid]

    # -- fusion / fission (scheme B merge/split, paper §4.3) -------------------

    def allocate_with_reshape(self, profile: PartitionProfile
                              ) -> Partition | None:
        """Try plain allocation; failing that, merge/split idle partitions
        until a ``profile`` placement exists.  Busy partitions are never
        touched (MIGM never disturbs running jobs — unlike MISO's
        checkpoint/restore, §6)."""
        part = self.allocate(profile)
        if part is not None:
            return part

        # Fission/fusion: free all idle partitions (merging their space back
        # into the FSM) and retry.  Feasibility is evaluated on the
        # *hypothetical* idle-freed state first — a failed reshape is a true
        # no-op (exact FSM state, live Partition objects and n_reconfigs all
        # untouched), so probing it from routers/planners is free.  On
        # success the idle partitions are consumed — their space now backs
        # the new placement.  This realizes "merge neighboring small
        # partitions or split bigger partitions" in FSM terms: releasing
        # idle space coalesces buddies / frees GPC spans, and the argmax
        # re-placement splits as needed.
        idle = self.idle_partitions()
        if not idle:
            return None
        state_free: Hashable = self.state
        for p in idle:
            state_free = self.backend.free(state_free, p.handle)
        best = self.best_placement(state_free, profile)
        if best is None:
            return None
        for p in idle:
            self.release(p)
        part = self._commit(best)
        self.n_reconfigs += len(idle)
        return part

    # -- reporting -------------------------------------------------------------

    def describe(self) -> str:
        try:
            return self.backend.describe(self.state)  # type: ignore[attr-defined]
        except AttributeError:  # pragma: no cover
            return repr(self.state)
