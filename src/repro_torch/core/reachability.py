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
                                              enumerate_states, saturated)

#: Most device tables a process ever touches.  Beyond this, the oldest
#: entries are evicted so per-test backends cannot grow the cache unbounded.
MAX_CACHED_BACKENDS = 8

#: key -> (pinned backend, fcr).  Pinning the backend keeps id()-keyed
#: entries valid (a collected backend's id could be reused); value-keyed
#: backends (``reachability_cache_key``) share one entry per device table.
_CACHE: dict[Hashable, tuple[PartitionBackend, dict[Hashable, int]]] = {}

#: every per-backend table cache in the process (this one, the compiled
#: transition graphs of :mod:`repro_torch.core.planner.graph` and the cost
#: model's normalizers) registers here so one clear empties them together.
_REGISTERED_CACHES: list[dict] = [_CACHE]


def register_backend_cache(cache: dict) -> dict:
    """Register another per-backend cache for shared clearing/bounding."""
    _REGISTERED_CACHES.append(cache)
    return cache


def bounded_cache_insert(cache: dict, key: Hashable, value) -> None:
    """Insert, then evict oldest entries past :data:`MAX_CACHED_BACKENDS`."""
    cache[key] = value
    while len(cache) > MAX_CACHED_BACKENDS:
        cache.pop(next(iter(cache)))


def clear_reachability_cache() -> None:
    """Drop every cached per-backend table (reachability and transition
    graphs), so per-test backend tables cannot leak across a test run."""
    for cache in _REGISTERED_CACHES:
        cache.clear()


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
    bounded_cache_insert(_CACHE, key, (backend, fcr))
    return fcr


def fully_configured_states(backend: PartitionBackend) -> list[Hashable]:
    """F — all saturated states (the paper's Fig. 3 rows for the A100)."""
    return [s for s in enumerate_states(backend) if saturated(backend, s)]
