"""Pluggable fleet routing policies; the port's copy of
``repro.fleet.router``.

A router orders the feasible devices for one job; the orchestrator commits
to the first device whose partition plan succeeds.  Routing is where
fleet-level throughput/energy headroom lives (MISO schedules MIG jobs
across a cluster; arXiv:2409.06646 shows placement *across* devices is the
remaining optimization surface):

* :class:`RoundRobinRouter` / :class:`RandomRouter` — order-only baselines,
* :class:`BestFitRouter` / :class:`EnergyAwareRouter` — *cost-model
  routers*: each is nothing but a set of lexicographic weights
  (:data:`~repro_torch.core.planner.cost.BEST_FIT_DEVICE_COST` /
  :data:`~repro_torch.core.planner.cost.ENERGY_AWARE_DEVICE_COST`) over the
  same per-device features the partition planner scores (memory waste, free
  capacity, normalized reachability, load, wake latency, idle power) —
  device choice and on-device placement share one cost vocabulary.
"""

from __future__ import annotations

import random
from typing import Iterator, Sequence

from repro_torch.core.planner.cost import (BEST_FIT_DEVICE_COST, CostModel,
                                           CostTerms, ENERGY_AWARE_DEVICE_COST,
                                           normalized_reachability)
from repro_torch.core.scheduler.events import DeviceSim
from repro_torch.core.scheduler.job import Job
from repro_torch.fleet.devices import WAKE_LATENCY_S


class Router:
    """Order feasible devices for ``job``, most preferred first."""

    name = "router"
    #: consolidation routers ask the orchestrator to gate idle devices
    consolidates = False
    #: True when ``rank`` is a pure function of (job, device states) — no
    #: internal counter or RNG advanced per call.  Only then may the
    #: orchestrator *skip* redundant rank calls (the queue-rescan
    #: fast-path): skipping a stateful rank would desync its rotation or
    #: random stream and change placements, not just speed
    stateless_rank = False

    def rank(self, job: Job, devices: Sequence[DeviceSim]
             ) -> list[DeviceSim]:
        raise NotImplementedError

    @staticmethod
    def feasible(job: Job, devices: Sequence[DeviceSim]) -> list[DeviceSim]:
        return [d for d in devices if d.fits(job)]


class RoundRobinRouter(Router):
    name = "round_robin"

    def __init__(self) -> None:
        self._next = 0

    def rank(self, job: Job, devices: Sequence[DeviceSim]
             ) -> list[DeviceSim]:
        feas = self.feasible(job, devices)
        if not feas:
            return []
        start = self._next % len(feas)
        self._next += 1
        return feas[start:] + feas[:start]


class RandomRouter(Router):
    name = "random"

    def __init__(self, seed: int = 0) -> None:
        self._rng = random.Random(seed)

    def rank(self, job: Job, devices: Sequence[DeviceSim]
             ) -> list[DeviceSim]:
        feas = self.feasible(job, devices)
        self._rng.shuffle(feas)
        return feas


def device_cost_terms(job: Job, dev: DeviceSim,
                      wake_s: float = WAKE_LATENCY_S,
                      price_per_j: float = 0.0) -> CostTerms:
    """The planner cost features of routing ``job`` to ``dev``.

    ``price_per_j`` ($/J, the hosting zone's current tariff) feeds the
    ``energy_price`` feature — the dollars per second this device's idle
    floor burns — so a cost model can prefer the device generation that is
    cheap to keep awake *here and now* (an A100's 55W beats an H100's 75W
    when the local tariff is at its peak).
    """
    est = job.est_mem_gb if job.est_mem_gb is not None else 0.0
    prof = (dev.backend.tightest_profile(est, job.compute_demand)
            or dev.backend.profiles[-1])
    return CostTerms(
        wake_s=wake_s if dev.gated else 0.0,
        mem_waste_gb=prof.mem_gb - est,
        free_after_gb=dev.free_mem_gb() - prof.mem_gb,
        reach_norm=normalized_reachability(dev.backend, dev.pm.state,
                                           reach=dev.pm.reach(dev.pm.state)),
        compute_deficit=max(0.0, job.compute_demand - prof.compute_fraction),
        load=dev.load_fraction(),
        idle_power_w=dev.energy.model.p_idle_w,
        energy_price=price_per_j * dev.energy.model.p_idle_w)


class CostRouter(Router):
    """A router that is purely a cost model over device features: rank is
    a stable sort by the weighted lexicographic cost vector.

    ``price_per_j`` is the hosting zone's tariff at the decision instant;
    the cluster policy refreshes it before each dispatch round so models
    that weight ``energy_price`` stay tariff-aware.  It defaults to 0.0 and
    no built-in device model weights the feature, so standalone fleet
    behaviour is unchanged.
    """

    cost_model: CostModel
    price_per_j: float = 0.0
    stateless_rank = True
    #: a :class:`repro_torch.fleet.index.RoutingIndex` bound by the fleet
    #: policy
    #: once the kernel is known; None ranks via the seed full-sort below
    index = None
    #: escape hatch: False forces the seed path even with an index bound —
    #: the pre-index baseline arm of ``benchmarks/bench_router.py``
    use_index = True

    def rank(self, job: Job, devices: Sequence[DeviceSim]
             ) -> list[DeviceSim] | Iterator[DeviceSim]:
        if self.index is not None and self.use_index:
            ranked = self.index.rank(self, job, devices)
            if ranked is not None:  # None: a pool the index's kernel
                return ranked       # doesn't know — the sort handles any
        # -- the seed full-sort path, preserved verbatim: unbound routers
        #    (plain lists of devices, no kernel) rank through it, and the
        #    router benchmark pins the index's speedup against it --
        feas = self.feasible(job, devices)
        if len(feas) <= 1:
            # ordering a singleton is free — and the changed-device retry
            # path hands the router one-device pools constantly, so the
            # cost evaluation here would dominate a backlogged drain
            return feas
        return sorted(feas,
                      key=lambda d: self.cost_model.cost(
                          device_cost_terms(job, d,
                                            price_per_j=self.price_per_j)))


class BestFitRouter(CostRouter):
    """Tightest profile first, then fill the fullest device, tie-broken by
    the post-placement reachability score (Algorithm 3's |F_s| lifted to
    device choice)."""

    name = "best_fit"
    cost_model = BEST_FIT_DEVICE_COST


class EnergyAwareRouter(CostRouter):
    """Consolidation: pack the busiest awake device so idle devices can be
    power-gated; wake the cheapest gated device only when no awake device
    can host."""

    name = "energy_aware"
    consolidates = True
    cost_model = ENERGY_AWARE_DEVICE_COST


def make_router(name: str, seed: int = 0) -> Router:
    routers = {
        "round_robin": RoundRobinRouter,
        "random": lambda: RandomRouter(seed),
        "best_fit": BestFitRouter,
        "energy_aware": EnergyAwareRouter,
    }
    try:
        return routers[name]()
    except KeyError:
        raise ValueError(f"unknown router {name!r}; "
                         f"known: {sorted(routers)}") from None
