"""Hierarchical routing policies: rank zones with the planner's cost model;
the port's copy of ``repro.cluster.policies``.

The partition planner collapsed every placement ladder onto one ``CostTerms`` vocabulary;
this module lifts the same device-cost ranking one level up.  A zone
router is — exactly like the fleet's cost routers — nothing but a set of
lexicographic weights over measurable features, here the two cluster-level
ones: ``energy_price`` (the zone's tariff weighting its idle wattage, $/s)
and ``data_movement_s`` (the checkpoint transfer a cross-zone move pays,
arXiv:2409.06646's placement-vs-movement tension).

* :class:`SingleZoneRouter` — everything to one home zone (the baseline),
* :class:`PriceGreedyZoneRouter` — chase the instantaneous tariff,
* :class:`FollowTheSunZoneRouter` — score the tariff's mean over the job's
  predicted run window, so work flows into whichever zone's night covers
  the job.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.cluster.zones import CROSS_ZONE_GBPS, Zone, checkpoint_movement_s
from repro_torch.core.planner.cost import (
    FOLLOW_THE_SUN_ZONE_COST,
    PRICE_GREEDY_ZONE_COST,
    CostModel,
    CostTerms,
)
from repro_torch.core.scheduler.job import Job
from repro_torch.fleet.router import CostRouter


def refresh_zone_prices(zones: Sequence[Zone], t: float) -> None:
    """Push each zone's instantaneous tariff into its device router before
    a dispatch round, so cost models weighing ``energy_price`` stay
    tariff-aware.

    Deliberately cheap to call every round: the fleet's routing index
    factors ``price_per_j`` out of its cached device terms (the tariff
    scales the ``energy_price`` feature at rank time), so this cluster-wide
    refresh invalidates nothing — only real device-state changes (start /
    finish / gate, via the kernel epoch) do.
    """
    for zone in zones:
        router = zone.router
        if isinstance(router, CostRouter):
            router.price_per_j = zone.tariff.price_at(t)


def zone_cost_terms(
    job: Job,
    zone: Zone,
    t: float,
    from_zone: str | None = None,
    gbps: float = CROSS_ZONE_GBPS,
    horizon_s: float | None = None,
) -> CostTerms:
    """The cluster-level cost features of routing ``job`` to ``zone`` at
    sim time ``t``.

    ``energy_price`` is the tariff-weighted idle wattage ($/s of keeping
    this zone's mean device awake): instantaneous when ``horizon_s`` is
    None, else the tariff's mean over the job's predicted run window,
    shifted by the transfer the move would pay first.
    """
    move_s = checkpoint_movement_s(job, from_zone, zone.name, gbps)
    if horizon_s is None:
        price = zone.tariff.price_at(t)
    else:
        price = zone.tariff.mean_price(t + move_s, t + move_s + horizon_s)
    return CostTerms(
        energy_price=price * zone.idle_power_w(),
        data_movement_s=move_s,
        load=zone.load_fraction(),
    )


class ZoneRouter:
    """Order feasible zones for ``job``, most preferred first."""

    name = "zone_router"
    cross_zone_gbps = CROSS_ZONE_GBPS

    def rank(
        self, job: Job, zones: Sequence[Zone], t: float, from_zone: str | None = None
    ) -> list[Zone]:
        raise NotImplementedError

    @staticmethod
    def feasible(job: Job, zones: Sequence[Zone]) -> list[Zone]:
        return [z for z in zones if z.feasible(job)]


class SingleZoneRouter(ZoneRouter):
    """The baseline: every job runs in the home zone.  Other zones are
    offered only as a feasibility escape hatch — a job *no* home device
    could ever hold (not merely a busy home) may overflow."""

    name = "single_zone"

    def __init__(self, home: int = 0) -> None:
        self.home = home

    def rank(
        self, job: Job, zones: Sequence[Zone], t: float, from_zone: str | None = None
    ) -> list[Zone]:
        home = zones[self.home]
        if home.feasible(job):
            return [home]
        return [z for z in self.feasible(job, zones) if z is not home]


class CostZoneRouter(ZoneRouter):
    """A zone router that is purely a cost model over zone features."""

    cost_model: CostModel

    def __init__(self, cross_zone_gbps: float = CROSS_ZONE_GBPS) -> None:
        self.cross_zone_gbps = cross_zone_gbps

    def _horizon_s(self, job: Job) -> float | None:
        return None  # instantaneous pricing unless a subclass forecasts

    def rank(
        self, job: Job, zones: Sequence[Zone], t: float, from_zone: str | None = None
    ) -> list[Zone]:
        horizon = self._horizon_s(job)

        def cost(zone: Zone) -> tuple[float, ...]:
            terms = zone_cost_terms(
                job,
                zone,
                t,
                from_zone=from_zone,
                gbps=self.cross_zone_gbps,
                horizon_s=horizon,
            )
            return self.cost_model.cost(terms)

        return sorted(self.feasible(job, zones), key=cost)


class PriceGreedyZoneRouter(CostZoneRouter):
    """Chase the cheapest instantaneous tariff; movement and load only
    break ties.  Myopic by design — the foil for follow-the-sun."""

    name = "price_greedy"
    cost_model = PRICE_GREEDY_ZONE_COST


class FollowTheSunZoneRouter(CostZoneRouter):
    """Score each zone by the tariff's *mean over the job's predicted run
    window* (full-slice runtime estimate, shifted by the cross-zone
    transfer), so long jobs land where the night lasts long enough."""

    name = "follow_the_sun"
    cost_model = FOLLOW_THE_SUN_ZONE_COST

    def _horizon_s(self, job: Job) -> float | None:
        return job.runtime_on(1.0)


def make_zone_router(name: str, **kwargs) -> ZoneRouter:
    routers = {
        "single_zone": SingleZoneRouter,
        "price_greedy": PriceGreedyZoneRouter,
        "follow_the_sun": FollowTheSunZoneRouter,
    }
    try:
        return routers[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown zone router {name!r}; known: {sorted(routers)}"
        ) from None
