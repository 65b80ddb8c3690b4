"""Compiled FSM transition graph — the planner's O(1) hot path, the port's
copy of ``repro.core.planner.graph``.

Algorithm 3 enumerates every legal span placement and its reachability on
each ``allocate`` call.  The MIG FSMs are small (A100: 308 states / 1,040
transitions, H100: 1,076 states / 4,193 transitions), so the graph is
interned once per device table, alongside the Algorithm 2 reachability
precompute:

* every valid state gets an integer id,
* every ``(state, profile)`` pair gets its placement list, and
* the argmax-|F_s| placement (the exact ``max`` Alg. 3 computes online)
  is precomputed per pair,

turning ``PartitionManager.allocate`` / ``enumerate_placements`` into
dictionary lookups.  A backend whose state space cannot be enumerated opts
out via ``supports_compiled_graph = False`` and keeps the direct path.

The compiled graphs share the bounded cache machinery of
:mod:`repro_torch.core.reachability` — one entry per device table, cleared
by ``clear_reachability_cache()``.
"""

from __future__ import annotations

import time
from typing import Hashable

from repro_torch.core.partition_state import (PartitionBackend,
                                              PartitionProfile, Placement)
from repro_torch.core.reachability import (bounded_cache_insert,
                                           precompute_reachability,
                                           reachability_cache_key,
                                           register_backend_cache)

#: key -> (pinned backend, TransitionGraph); bounded + cleared together
#: with the reachability cache.
_GRAPH_CACHE: dict[Hashable, tuple[PartitionBackend, "TransitionGraph"]] = (
    register_backend_cache({}))

_EMPTY: tuple[Placement, ...] = ()


class TransitionGraph:
    """Indexed FSM of one backend: state ids, per-(state, profile) placement
    lists and the precomputed argmax-|F_s| placement per pair."""

    def __init__(self, backend: PartitionBackend,
                 fcr: dict[Hashable, int]) -> None:
        t0 = time.perf_counter()
        self.backend = backend
        self.states: list[Hashable] = list(fcr)
        self.index: dict[Hashable, int] = {s: i
                                           for i, s in enumerate(self.states)}
        self._fcr: list[int] = [fcr[s] for s in self.states]
        # per state id: profile name -> placements / argmax placement.  The
        # argmax uses the same ``max`` (first of equal maxima in enumeration
        # order) as the online Algorithm 3, so lookups are bit-for-bit.
        self._placements: list[dict[str, tuple[Placement, ...]]] = []
        self._best: list[dict[str, Placement]] = []
        self.n_transitions = 0
        for state in self.states:
            by_profile: dict[str, tuple[Placement, ...]] = {}
            best: dict[str, Placement] = {}
            for profile in backend.profiles:
                placements = tuple(backend.enumerate_placements(state,
                                                                profile))
                if not placements:
                    continue
                by_profile[profile.name] = placements
                best[profile.name] = max(
                    placements, key=lambda pl: fcr[pl.next_state])
                self.n_transitions += len(placements)
            self._placements.append(by_profile)
            self._best.append(best)
        self.build_seconds = time.perf_counter() - t0

    @property
    def n_states(self) -> int:
        return len(self.states)

    def reach(self, state: Hashable) -> int:
        """|F_s| — precomputed; falls back to the backend for a state the
        graph has never seen (defensive: should not happen for states
        reached through the FSM itself)."""
        sid = self.index.get(state)
        if sid is None:  # pragma: no cover - defensive
            return self.backend.reachability(state)
        return self._fcr[sid]

    def placements(self, state: Hashable,
                   profile: PartitionProfile) -> tuple[Placement, ...]:
        """Cached ``enumerate_placements(state, profile)``."""
        sid = self.index.get(state)
        if sid is None:  # pragma: no cover - defensive
            return tuple(self.backend.enumerate_placements(state, profile))
        return self._placements[sid].get(profile.name, _EMPTY)

    def best_placement(self, state: Hashable,
                       profile: PartitionProfile) -> Placement | None:
        """Algorithm 3's ``argmax |F_s|`` placement as one dict lookup."""
        sid = self.index.get(state)
        if sid is None:  # pragma: no cover - defensive
            placements = self.backend.enumerate_placements(state, profile)
            if not placements:
                return None
            return max(placements,
                       key=lambda pl: self.backend.reachability(pl.next_state))
        return self._best[sid].get(profile.name)


def compile_transition_graph(backend: PartitionBackend,
                             max_states: int = 2_000_000
                             ) -> TransitionGraph | None:
    """The cached compiled graph for ``backend``, or None when the backend's
    state space cannot be enumerated (``supports_compiled_graph`` False)."""
    if not getattr(backend, "supports_compiled_graph", False):
        return None
    key = reachability_cache_key(backend)
    hit = _GRAPH_CACHE.get(key)
    if hit is not None:
        return hit[1]
    # warms the shared reachability cache too (the graph is built alongside
    # Algorithm 2 — same enumeration, same cache identity)
    fcr = precompute_reachability(backend, max_states=max_states)
    graph = TransitionGraph(backend, fcr)
    bounded_cache_insert(_GRAPH_CACHE, key, (backend, graph))
    return graph
