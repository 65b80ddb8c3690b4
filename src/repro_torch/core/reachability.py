"""Future-configuration reachability (paper §4.2, Algorithm 2).

    function PRECOMPUTE_REACHABILITY
        Enumerate all valid partition states S.
        for each valid partition state s:
            Compute all reachable fully configured states F_s
            fcr(s) <- |F_s|
        return fcr

The port's copy of ``repro.core.reachability`` for the MIG span FSMs, whose
state spaces are small enough to run the algorithm literally.
"""

from __future__ import annotations

from typing import Hashable

from repro_torch.core.partition_state import (PartitionBackend,
                                              enumerate_states)

#: Most device tables a process ever touches.  Beyond this, the oldest
#: entries are evicted so per-test backends cannot grow the cache unbounded.
MAX_CACHED_BACKENDS = 8

#: key -> (pinned backend, fcr).  Pinning the backend keeps id()-keyed
#: entries valid (a collected backend's id could be reused); value-keyed
#: backends (``reachability_cache_key``) share one entry per device table.
_CACHE: dict[Hashable, tuple[PartitionBackend, dict[Hashable, int]]] = {}


def reachability_cache_key(backend: PartitionBackend) -> Hashable:
    """Value-based when the backend provides it, ``id()`` otherwise."""
    key_fn = getattr(backend, "reachability_cache_key", None)
    return key_fn() if key_fn is not None else id(backend)


def precompute_reachability(backend: PartitionBackend,
                            max_states: int = 2_000_000
                            ) -> dict[Hashable, int]:
    """Algorithm 2 — offline |F_s| for every valid state of ``backend``."""
    key = reachability_cache_key(backend)
    if key in _CACHE:
        return _CACHE[key][1]

    states = enumerate_states(backend, max_states=max_states)

    # Memoized DFS over successors, propagating the sets of distinct
    # saturated states each state can reach.
    finals: dict[Hashable, frozenset] = {}

    def final_set(state: Hashable) -> frozenset:
        if state in finals:
            return finals[state]
        acc: set = set()
        is_final = True
        for profile in backend.profiles:
            for placement in backend.enumerate_placements(state, profile):
                is_final = False
                acc |= final_set(placement.next_state)
        if is_final:
            acc = {state}
        out = frozenset(acc)
        finals[state] = out
        return out

    fcr = {s: len(final_set(s)) for s in states}
    _CACHE[key] = (backend, fcr)
    while len(_CACHE) > MAX_CACHED_BACKENDS:
        _CACHE.pop(next(iter(_CACHE)))
    return fcr
