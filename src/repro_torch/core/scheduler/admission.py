"""Graph-backed admission control — reject-or-queue before reach collapses;
the port's copy of ``repro.core.scheduler.admission``.

The fleet used to admit every feasible job: the router picked a device,
the planner carved a slice, and the FSM's future-configuration count
|F_s| (Algorithm 2) fell where it fell.  Under bursty arrivals that is
exactly backwards — a placement that is locally fine can strand the
*next* arrivals, because a fragmented state may retain plenty of memory
yet no legal placement sequence (MISO, arXiv:2207.11428, schedules MIG
jobs against predicted demand, not just present demand).

This module closes the loop with three pieces:

* :class:`ArrivalForecast` — EWMA arrival rate + typical memory demand,
  decaying while the queue is quiet, so "what the near future needs" is
  a number: expected arrivals over a horizon,
* :func:`reach_floor` — the *guarantee threshold* computed from the
  compiled :class:`~repro_torch.core.planner.graph.TransitionGraph`: the
  smallest |F_s| such that **every** FSM state at or above it can still
  host ``k`` sequential placements of the forecast's typical profile
  (a DP over the graph's cached placement lists; exact, not heuristic),
* :class:`AdmissionController` — admit a planned placement iff the
  post-action |F_s| (already computed by the planner as the candidate's
  ``reach`` term) stays at or above the floor for the forecast arrivals.

A rejected job is *queued, not dropped*: the fleet policy re-evaluates
it on the next finish event or on a scheduled admission tick, by which
time the forecast has decayed or capacity has freed.  Backends whose
state space cannot be compiled (the TPU pod) opt out and admit freely.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Hashable

from repro_torch.core.partition_state import PartitionProfile
from repro_torch.core.planner.graph import TransitionGraph
from repro_torch.core.reachability import (reachability_cache_key,
                                           register_backend_cache)

#: (device-table key, profile name, k) -> floor; cleared with the
#: reachability/graph caches so per-test backends cannot leak.
_FLOOR_CACHE: dict[Hashable, int] = register_backend_cache({})


def hosting_states(graph: TransitionGraph, profile: PartitionProfile,
                   k: int) -> list[bool]:
    """Per state id: can ``k`` sequential ``profile`` placements start
    here?  DP over the compiled placement lists — ``hosts_k[s]`` is true
    when some placement's successor hosts ``k - 1``."""
    hosts = [True] * graph.n_states
    for _ in range(k):
        prev = hosts
        hosts = []
        for state in graph.states:
            ok = False
            for pl in graph.placements(state, profile):
                nxt = graph.index.get(pl.next_state)
                if nxt is not None and prev[nxt]:
                    ok = True
                    break
            hosts.append(ok)
    return hosts


def reach_floor(graph: TransitionGraph, profile: PartitionProfile,
                k: int) -> int:
    """The smallest |F_s| that *guarantees* ``k`` more ``profile``
    placements: one above the largest |F_s| among states that cannot host
    them (0 when every state can).  ``reach >= floor`` is therefore a
    sufficient condition — the admission rule errs on the side of
    admitting only provably safe placements, which is what makes the
    property test's brute-force cross-check exact."""
    if k <= 0:
        return 0
    key = (reachability_cache_key(graph.backend), profile.name, k)
    hit = _FLOOR_CACHE.get(key)
    if hit is not None:
        return hit
    hosts = hosting_states(graph, profile, k)
    floor = 0
    for sid, ok in enumerate(hosts):
        if not ok:
            floor = max(floor, graph.reach(graph.states[sid]) + 1)
    _FLOOR_CACHE[key] = floor
    return floor


class ArrivalForecast:
    """EWMA arrival-rate + typical-demand estimator.

    ``observe`` per arrival; ``rate_per_s(t)`` decays as the quiet time
    since the last arrival grows (the effective gap is at least the
    elapsed silence), so a burst that ended stops demanding headroom."""

    def __init__(self, alpha: float = 0.3) -> None:
        self.alpha = alpha
        self._last_t: float | None = None
        self._ewma_gap: float | None = None
        self._ewma_mem: float | None = None

    def observe(self, t: float, est_mem_gb: float | None = None) -> None:
        if self._last_t is not None:
            gap = max(t - self._last_t, 1e-9)
            if self._ewma_gap is None:
                self._ewma_gap = gap
            else:
                self._ewma_gap += self.alpha * (gap - self._ewma_gap)
        self._last_t = t
        if est_mem_gb is not None and est_mem_gb > 0.0:
            if self._ewma_mem is None:
                self._ewma_mem = float(est_mem_gb)
            else:
                self._ewma_mem += self.alpha * (est_mem_gb - self._ewma_mem)

    def rate_per_s(self, t: float) -> float:
        if self._ewma_gap is None:
            return 0.0
        gap = self._ewma_gap
        if self._last_t is not None:
            gap = max(gap, t - self._last_t)
        return 1.0 / gap

    def expected_arrivals(self, t: float, horizon_s: float) -> float:
        return self.rate_per_s(t) * horizon_s

    @property
    def typical_mem_gb(self) -> float:
        """EWMA memory demand of recent arrivals (0 until observed)."""
        return self._ewma_mem or 0.0


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    admit: bool
    reach_after: int       # |F_s| the planned action would leave
    floor: int             # the guarantee threshold for the forecast
    expected_arrivals: float
    reason: str

    def describe(self) -> str:
        verdict = "admit" if self.admit else "defer"
        return (f"{verdict}: reach_after={self.reach_after} "
                f"floor={self.floor} "
                f"expect={self.expected_arrivals:.2f} ({self.reason})")


class AdmissionController:
    """Admit a planned placement only while the post-action |F_s| keeps
    the forecast arrivals hostable.

    ``horizon_s`` is how far ahead the forecast looks; ``max_lookahead``
    caps the DP depth (k beyond a handful of placements stops being
    informative — the floor saturates at the near-empty states).
    ``retry_s`` is the admission-tick period the fleet schedules for
    deferred jobs, re-evaluating them after the forecast has decayed.
    """

    def __init__(self, horizon_s: float = 30.0, max_lookahead: int = 4,
                 alpha: float = 0.3, retry_s: float | None = 5.0) -> None:
        self.horizon_s = horizon_s
        self.max_lookahead = max_lookahead
        self.retry_s = retry_s
        self.forecast = ArrivalForecast(alpha)

    def note_arrival(self, t: float, job) -> None:
        self.forecast.observe(t, getattr(job, "est_mem_gb", None))

    def required_placements(self, t: float, shares: int = 1) -> int:
        """Forecast arrivals this device must stay able to host: the
        fleet-wide expectation split over ``shares`` devices, rounded to
        the nearest whole placement, capped at the DP depth.  Rounding
        (not ceiling) matters: the decayed rate never reaches exactly
        zero, and demanding a guaranteed slot for 0.001 expected arrivals
        would defer the last job of a burst forever."""
        expect = self.forecast.expected_arrivals(t, self.horizon_s)
        return min(self.max_lookahead,
                   math.floor(expect / max(shares, 1) + 0.5))

    def typical_profile(self, backend) -> PartitionProfile:
        """The forecast's demand as a profile of ``backend`` (smallest
        profile until any arrival carried an estimate)."""
        mem = self.forecast.typical_mem_gb
        if mem > 0.0:
            prof = backend.tightest_profile(mem)
            if prof is not None:
                return prof
        return backend.profiles[0]

    def decide(self, pm, plan, t: float, shares: int = 1
               ) -> AdmissionDecision:
        """Gate one planned placement (``plan.chosen`` must be set; its
        ``reach`` term is the post-action |F_s| the planner already
        computed through the graph)."""
        expect = self.forecast.expected_arrivals(t, self.horizon_s)
        graph = pm.graph
        if graph is None:
            return AdmissionDecision(True, 0, 0, expect,
                                     "backend has no compiled graph")
        k = self.required_placements(t, shares)
        reach_after = int(plan.chosen.terms.reach)
        if k <= 0:
            return AdmissionDecision(True, reach_after, 0, expect,
                                     "no forecast arrivals in horizon")
        profile = self.typical_profile(pm.backend)
        floor = reach_floor(graph, profile, k)
        admit = reach_after >= floor
        return AdmissionDecision(
            admit, reach_after, floor, expect,
            f"needs {k} x {profile.name} placements")
