"""Cluster workloads: each zone's users submit on their own local clock;
the port's copy of ``repro.cluster.workload``.

Every zone gets a Rodinia-style mix under diurnal arrivals phase-shifted
by the zone's offset, so the zones' "days" interleave around the globe —
at any instant some zone is at peak submission (and peak tariff) while
another sleeps.  That stagger is precisely the arbitrage follow-the-sun
routing monetizes.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.cluster.zones import Zone
from repro_torch.core.scheduler.job import Job, rodinia_job
from repro_torch.fleet.arrivals import diurnal_arrivals

DEFAULT_POOL = [
    "myocyte",
    "gaussian",
    "srad",
    "euler3d",
    "particlefilter",
    "nw",
    "lavamd",
    "hotspot3d",
    "cfd_full",
]


def cluster_workload(
    zones: Sequence[Zone],
    jobs_per_zone: int,
    period_s: float,
    peak_rate: float,
    trough_rate: float,
    seed: int = 0,
    pool: Sequence[str] | None = None,
) -> tuple[list[Job], dict[str, str]]:
    """Build ``(jobs, origin)``: per-zone diurnal submissions plus the map
    from job name to the zone whose users submitted it (where its input
    data lives — routing it elsewhere pays the cross-zone transfer).

    Job names are prefixed with the zone so the one global kernel sees a
    unique namespace; arrivals are seeded per zone, so the same seed gives
    the same cluster-wide workload.
    """
    pool = list(pool or DEFAULT_POOL)
    jobs: list[Job] = []
    origin: dict[str, str] = {}
    for zi, zone in enumerate(zones):
        zone_jobs = []
        for i in range(jobs_per_zone):
            job = rodinia_job(pool[i % len(pool)], i)
            job.name = f"{zone.name}/{job.name}"
            zone_jobs.append(job)
        diurnal_arrivals(
            zone_jobs,
            period_s=period_s,
            peak_rate=peak_rate,
            trough_rate=trough_rate,
            seed=seed + zi,
            phase_s=zone.phase_s,
        )
        for job in zone_jobs:
            origin[job.name] = zone.name
        jobs.extend(zone_jobs)
    jobs.sort(key=lambda j: (j.arrival, j.name))
    return jobs, origin
