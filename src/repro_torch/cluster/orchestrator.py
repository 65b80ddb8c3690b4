"""The cluster orchestrator: one event kernel over every zone's devices;
the port's copy of ``repro.cluster.orchestrator``.

The hierarchy reuses each layer below it wholesale — no fifth bespoke
ladder:

1. the cluster policy ranks *zones* with a planner cost model
   (``energy_price`` / ``data_movement_s`` / ``load``),
2. the chosen zone's own :class:`~repro_torch.fleet.orchestrator.FleetPolicy`
   ranks *devices* and commits through the partition planner
   (``dispatch_job`` — the fleet accepting externally-routed work),
3. the device's planner picks the *partition action* exactly as in the
   single-GPU paper.

Every device across every zone hangs off one
:class:`~repro_torch.core.scheduler.kernel.EventKernel`, so the global clock,
per-zone tariff integration (joules -> dollars) and cross-zone moves are
all well-defined on a single timeline.  A job that restarts in a different
zone than its previous run is typed as a cluster-level
:class:`~repro_torch.core.planner.actions.Migrate` (zone + checkpoint transfer
seconds) and counted once in ``ClusterMetrics.n_cross_zone_migrations`` —
never also in the source fleet's ``n_migrations``.
"""

from __future__ import annotations

import functools
from typing import Iterable, Mapping, Sequence

from repro_torch.cluster.policies import ZoneRouter, refresh_zone_prices
from repro_torch.cluster.zones import Zone, checkpoint_movement_s
from repro_torch.core.planner import Migrate
from repro_torch.core.scheduler.events import EARLY_RESTART, OOM, DeviceSim
from repro_torch.core.scheduler.job import Job
from repro_torch.core.scheduler.kernel import EventKernel, SchedulingPolicy
from repro_torch.core.scheduler.metrics import ClusterMetrics, ZoneMetrics
from repro_torch.fleet.devices import WAKE_LATENCY_S
from repro_torch.fleet.energy import PricedEnergyIntegrator
from repro_torch.fleet.orchestrator import FleetPolicy, drain_queue, gate_idle_devices
from repro_torch.obs.counters import TailStats


class ClusterPolicy(SchedulingPolicy):
    """Zone-router-driven dispatch over N fleets, as one kernel policy."""

    online = True

    def __init__(
        self,
        zones: Sequence[Zone],
        router: ZoneRouter,
        wake_latency_s: float = WAKE_LATENCY_S,
        origin: Mapping[str, str] | None = None,
    ) -> None:
        names = [z.name for z in zones]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate zone names: {names}")
        self.zones = list(zones)
        self.router = router
        self.name = router.name
        self.origin = dict(origin or {})
        self._fleets: dict[str, FleetPolicy] = {}
        self._meters: dict[str, PricedEnergyIntegrator] = {}
        for zone in self.zones:
            self._fleets[zone.name] = FleetPolicy(zone.router, wake_latency_s)
            self._meters[zone.name] = PricedEnergyIntegrator(
                zone.devices, zone.tariff.price_at
            )
        self._last_zone: dict[str, str] = {}  # job name -> zone name
        self.n_cross_zone_migrations = 0
        self.data_movement_s_total = 0.0
        self.migrations: list[str] = []
        self.jct_tail = TailStats("jct_s")
        # queue-rescan fast-path (mirrors FleetPolicy.dispatch): a job that
        # failed every zone fails again until some device's state moves —
        # zone *ranking* shifts with the tariff clock, but ranking only
        # reorders successes, never turns an everywhere-infeasible job
        # placeable, so the epoch alone keys the skip
        self._drain_epoch = None
        self._fresh: list[Job] = []

    # -- dispatch ----------------------------------------------------------

    def _from_zone(self, job: Job) -> str | None:
        return self._last_zone.get(job.name, self.origin.get(job.name))

    def _dispatch_one(self, kernel: EventKernel, job: Job) -> bool:
        from_zone = self._from_zone(job)
        ranked = self.router.rank(job, self.zones, kernel.t, from_zone)
        for zone in ranked:
            move_s = checkpoint_movement_s(
                job, from_zone, zone.name, self.router.cross_zone_gbps
            )
            placed = self._fleets[zone.name].dispatch_job(
                kernel, job, devices=zone.devices, extra_setup_s=move_s
            )
            if placed is None:
                continue
            dev, action = placed
            prev = self._last_zone.get(job.name)
            if prev is not None and prev != zone.name:
                # a checkpointed restart landing in another zone: typed as
                # a cluster-level Migrate, counted here exactly once — the
                # source fleet forgets the job so its n_migrations never
                # also counts this move
                action = Migrate(
                    device=dev.name,
                    inner=action,
                    zone=zone.name,
                    data_movement_s=move_s,
                )
                self.n_cross_zone_migrations += 1
                self._fleets[prev].forget(job.name)
                self.migrations.append(action.describe())
                if kernel.tracer is not None:
                    kernel.tracer.instant(
                        "migrate.xzone", device=dev.name, lane="router",
                        cat="migrate", job=job.name, source_zone=prev,
                        target_zone=zone.name, data_movement_s=move_s)
            self.data_movement_s_total += move_s
            self._last_zone[job.name] = zone.name
            return True
        return False

    def dispatch(self, kernel: EventKernel) -> bool:
        epoch = kernel.capacity_epoch
        attempt = functools.partial(self._dispatch_one, kernel)
        if epoch != self._drain_epoch or self._fresh:
            refresh_zone_prices(self.zones, kernel.t)
            if epoch != self._drain_epoch:
                self._drain_epoch = epoch
                self._fresh.clear()
                placed = drain_queue(kernel, attempt)
            else:
                fresh, self._fresh = self._fresh, []
                placed = drain_queue(kernel, attempt, candidates=fresh)
            for zone in self.zones:
                if zone.router.consolidates:
                    gate_idle_devices(kernel, zone.devices)
        else:
            placed = False
        # tariff metering integrates at every event boundary regardless —
        # the dollars integral is golden-pinned at event-time granularity
        for meter in self._meters.values():
            meter.observe(kernel.t)
        return placed

    # -- events ------------------------------------------------------------

    def on_arrival(self, kernel: EventKernel, job) -> None:
        kernel.queue.append(job)
        self._fresh.append(job)

    def on_finish(self, kernel: EventKernel, dev: DeviceSim, run) -> None:
        if run.plan.outcome in (OOM, EARLY_RESTART):
            run.job.est_mem_gb = run.plan.new_est_mem_gb
            kernel.queue.insert(0, run.job)  # restart: earliest arrival
        else:
            self.jct_tail.observe(run.t_end - run.job.arrival)

    def on_stall(self, kernel: EventKernel) -> None:
        if kernel.has_events():
            return  # a future arrival (or reconfig) may unblock the queue
        worst = kernel.queue[0]
        raise RuntimeError(
            f"deadlock: {worst.name} (est {worst.est_mem_gb}GB) fits no "
            f"zone in [{', '.join(z.name for z in self.zones)}]"
        )

    # -- reporting ---------------------------------------------------------

    def result(self, kernel: EventKernel, jobs: list) -> ClusterMetrics:
        for meter in self._meters.values():
            meter.observe(kernel.t)
        arrival_of = {j.name: j.arrival for j in jobs}
        completions: dict[str, float] = {}
        per_zone = []
        for zone in self.zones:
            meter = self._meters[zone.name]
            for dev in zone.devices:
                completions.update(dev.finished)
            per_zone.append(
                ZoneMetrics(
                    zone=zone.name,
                    tariff=zone.tariff.name,
                    energy_j=meter.joules,
                    dollars=meter.dollars,
                    gated_seconds=meter.gated_seconds,
                    idle_joules_avoided=meter.idle_joules_avoided,
                    n_finished=sum(len(d.finished) for d in zone.devices),
                    n_migrations=self._fleets[zone.name].n_migrations,
                    per_device=[d.metrics(len(d.finished)) for d in zone.devices],
                )
            )
        jcts = [completions[name] - arrival_of[name] for name in completions]
        devices = kernel.devices
        return ClusterMetrics(
            policy=self.router.name,
            zones=", ".join(z.name for z in self.zones),
            n_jobs=len(jobs),
            makespan=max(kernel.t, 1e-9),
            energy_j=sum(z.energy_j for z in per_zone),
            dollars=sum(z.dollars for z in per_zone),
            gated_seconds=sum(z.gated_seconds for z in per_zone),
            mean_jct=sum(jcts) / max(len(jcts), 1),
            n_oom=sum(d.n_oom for d in devices),
            n_early_restarts=sum(d.n_early for d in devices),
            n_reconfigs=sum(d.pm.n_reconfigs for d in devices),
            n_migrations=sum(f.n_migrations for f in self._fleets.values()),
            n_cross_zone_migrations=self.n_cross_zone_migrations,
            data_movement_s=self.data_movement_s_total,
            per_zone=per_zone,
            migrations=self.migrations,
            p99_jct=(self.jct_tail.percentile(99)
                     if self.jct_tail.count else 0.0),
        )


class ClusterOrchestrator:
    """Owns the zones; ``run`` is a thin kernel invocation with a
    :class:`ClusterPolicy` over every zone's devices."""

    def __init__(
        self,
        zones: Sequence[Zone],
        router: ZoneRouter,
        wake_latency_s: float = WAKE_LATENCY_S,
    ) -> None:
        self.zones = list(zones)
        self.router = router
        self.wake_latency_s = wake_latency_s

    def run(
        self,
        jobs: Iterable[Job],
        origin: Mapping[str, str] | None = None,
        tracer=None,
    ) -> ClusterMetrics:
        """Thin shim over :func:`repro_torch.api.simulate` (kind ``"cluster"``)."""
        from repro_torch.api import RunSpec, simulate
        return simulate(RunSpec(kind="cluster", zones=self.zones,
                                router=self.router, jobs=jobs,
                                origin=origin,
                                wake_latency_s=self.wake_latency_s,
                                tracer=tracer))


def run_cluster(
    zones: Sequence[Zone],
    router: ZoneRouter,
    jobs: Iterable[Job],
    origin: Mapping[str, str] | None = None,
    wake_latency_s: float = WAKE_LATENCY_S,
    tracer=None,
) -> ClusterMetrics:
    """Thin shim over :func:`repro_torch.api.simulate` (kind ``"cluster"``)."""
    orch = ClusterOrchestrator(zones, router, wake_latency_s=wake_latency_s)
    return orch.run(jobs, origin=origin, tracer=tracer)
