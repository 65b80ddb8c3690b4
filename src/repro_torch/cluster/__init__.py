"""Cluster-of-fleets: hierarchical planning across energy zones; the
port's copy of ``repro.cluster``.  Host code that models the devices;
nothing here launches work on a card.

The layer above :mod:`repro_torch.fleet` — N zones, each a fleet with its own
device catalogue, time-of-day energy tariff ($/J) and diurnal arrival
phase, behind one global admission queue.  Zone choice is the same
cost-model ranking the partition planner and the fleet routers use
(the planner's ``CostTerms``), extended with two cluster features:
``energy_price`` (tariff-weighted idle wattage) and ``data_movement_s``
(checkpoint-proportional cross-zone transfer).  Cross-zone moves are
typed :class:`~repro_torch.core.planner.actions.Migrate` actions counted in
:class:`~repro_torch.core.scheduler.metrics.ClusterMetrics`.
"""

from repro_torch.cluster.orchestrator import (
    ClusterOrchestrator,
    ClusterPolicy,
    run_cluster,
)
from repro_torch.cluster.policies import (
    CostZoneRouter,
    FollowTheSunZoneRouter,
    PriceGreedyZoneRouter,
    SingleZoneRouter,
    ZoneRouter,
    make_zone_router,
    zone_cost_terms,
)
from repro_torch.cluster.tariff import ZoneTariff
from repro_torch.cluster.workload import cluster_workload
from repro_torch.cluster.zones import (
    CROSS_ZONE_GBPS,
    CROSS_ZONE_SETUP_S,
    Zone,
    checkpoint_movement_s,
    make_zone,
)
from repro_torch.core.scheduler.metrics import ClusterMetrics, ZoneMetrics

__all__ = [
    "CROSS_ZONE_GBPS",
    "CROSS_ZONE_SETUP_S",
    "ClusterMetrics",
    "ClusterOrchestrator",
    "ClusterPolicy",
    "CostZoneRouter",
    "FollowTheSunZoneRouter",
    "PriceGreedyZoneRouter",
    "SingleZoneRouter",
    "Zone",
    "ZoneMetrics",
    "ZoneRouter",
    "ZoneTariff",
    "checkpoint_movement_s",
    "cluster_workload",
    "make_zone",
    "make_zone_router",
    "run_cluster",
    "zone_cost_terms",
]
