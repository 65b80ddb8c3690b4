"""Shared metrics for every simulation layer; the port's copy of
``repro.core.scheduler.metrics``.

One module holds the result records of every simulation surface —
per-device batch metrics (:class:`Metrics`), fleet aggregates
(:class:`FleetMetrics`), cluster-of-fleets aggregates
(:class:`ClusterMetrics` over per-zone :class:`ZoneMetrics`) and the
helpers the request-level serving layer builds its SLO metrics from — so a
new policy or workload never grows its own bookkeeping variant.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence


@dataclasses.dataclass
class RunRecord:
    job: str
    profile: str
    start: float
    end: float
    outcome: str
    compute_fraction: float
    mem_gb: float
    wasted_seconds: float = 0.0


@dataclasses.dataclass
class Metrics:
    """One device's batch-scheduling outcome (paper Fig. 4 axes)."""

    policy: str
    n_jobs: int
    makespan: float
    energy_j: float
    mem_util: float            # time-averaged used-mem / device-mem
    mean_turnaround: float
    n_oom: int
    n_early_restarts: int
    n_reconfigs: int
    wasted_seconds: float
    records: list[RunRecord]
    device: str = ""
    #: streamed P² estimate over completed-job turnarounds (0.0 when no
    #: job finished); exact mean stays in ``mean_turnaround``
    p99_turnaround: float = 0.0

    @property
    def throughput(self) -> float:
        return self.n_jobs / max(self.makespan, 1e-9)

    @property
    def energy_per_job(self) -> float:
        return self.energy_j / max(self.n_jobs, 1)

    def summary(self) -> str:
        return (f"{self.policy}: jobs={self.n_jobs} makespan={self.makespan:.1f}s "
                f"thpt={self.throughput:.4f}/s energy={self.energy_j / 1e3:.1f}kJ "
                f"mem_util={self.mem_util:.2%} turnaround={self.mean_turnaround:.1f}s "
                f"oom={self.n_oom} early={self.n_early_restarts} "
                f"reconf={self.n_reconfigs}")


@dataclasses.dataclass
class FleetMetrics:
    policy: str
    fleet: str
    n_jobs: int
    makespan: float
    energy_j: float
    gated_seconds: float
    idle_joules_avoided: float
    mean_jct: float            # completion - arrival, averaged
    n_oom: int
    n_early_restarts: int
    n_reconfigs: int
    wasted_seconds: float
    per_device: list[Metrics]
    records: list[tuple[str, RunRecord]]   # (device, record)
    n_migrations: int = 0      # cross-device restarts (planner Migrate)
    n_admission_deferrals: int = 0   # jobs the reach floor held back
    n_admission_overrides: int = 0   # stall-escape admissions past the floor
    p99_jct: float = 0.0       # streamed P² estimate over completion - arrival

    @property
    def throughput(self) -> float:
        return self.n_jobs / max(self.makespan, 1e-9)

    @property
    def energy_per_job(self) -> float:
        return self.energy_j / max(self.n_jobs, 1)

    def summary(self) -> str:
        return (f"{self.policy} on [{self.fleet}]: jobs={self.n_jobs} "
                f"makespan={self.makespan:.1f}s "
                f"thpt={self.throughput:.4f}/s "
                f"energy={self.energy_j / 1e3:.1f}kJ "
                f"({self.energy_per_job:.0f}J/job) "
                f"gated={self.gated_seconds:.0f}s "
                f"jct={self.mean_jct:.1f}s oom={self.n_oom} "
                f"early={self.n_early_restarts} reconf={self.n_reconfigs} "
                f"migr={self.n_migrations} "
                f"defer={self.n_admission_deferrals}")


@dataclasses.dataclass
class ZoneMetrics:
    """One energy zone's share of a cluster run (a fleet + its tariff)."""

    zone: str
    tariff: str
    energy_j: float
    dollars: float             # tariff-integrated: sum over time of P * $/J
    gated_seconds: float
    idle_joules_avoided: float
    n_finished: int
    n_migrations: int          # intra-zone cross-device restarts only
    per_device: list[Metrics]

    def summary(self) -> str:
        return (f"{self.zone} [{self.tariff}]: done={self.n_finished} "
                f"energy={self.energy_j / 1e3:.1f}kJ "
                f"cost=${self.dollars:.4f} gated={self.gated_seconds:.0f}s "
                f"migr={self.n_migrations}")


@dataclasses.dataclass
class ClusterMetrics:
    """A cluster-of-fleets run: per-zone Joules and dollars plus the
    cross-zone movement the hierarchical router paid for them."""

    policy: str
    zones: str
    n_jobs: int
    makespan: float
    energy_j: float
    dollars: float
    gated_seconds: float
    mean_jct: float
    n_oom: int
    n_early_restarts: int
    n_reconfigs: int
    n_migrations: int              # intra-zone (fleet-level Migrate)
    n_cross_zone_migrations: int   # cluster-level Migrate, counted once
    data_movement_s: float         # total checkpoint-transfer seconds paid
    per_zone: list[ZoneMetrics]
    migrations: list[str]          # describe() of each cluster-level Migrate
    p99_jct: float = 0.0           # streamed P² estimate, cluster-wide

    @property
    def throughput(self) -> float:
        return self.n_jobs / max(self.makespan, 1e-9)

    @property
    def dollars_per_job(self) -> float:
        return self.dollars / max(self.n_jobs, 1)

    def summary(self) -> str:
        return (f"{self.policy} over [{self.zones}]: jobs={self.n_jobs} "
                f"makespan={self.makespan:.1f}s "
                f"thpt={self.throughput:.4f}/s "
                f"energy={self.energy_j / 1e3:.1f}kJ "
                f"cost=${self.dollars:.4f} "
                f"(${1e3 * self.dollars_per_job:.2f}m/job) "
                f"jct={self.mean_jct:.1f}s oom={self.n_oom} "
                f"migr={self.n_migrations} "
                f"xzone={self.n_cross_zone_migrations} "
                f"moved={self.data_movement_s:.1f}s")


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (numpy's default), dependency-free so
    the serving SLO metrics stay importable without the array stack."""
    if not values:
        return math.nan
    xs = sorted(values)
    if len(xs) == 1:
        return xs[0]
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = math.ceil(pos)
    if lo == hi:
        return xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
