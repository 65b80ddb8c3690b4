"""The fleet orchestrator: one admission queue over N device simulators;
the port's copy of ``repro.fleet.orchestrator``.

The fleet is a :class:`~repro_torch.core.scheduler.kernel.EventKernel`
policy — the same event heap that drives the single-device batch
schedulers also drives N devices here:

1. ARRIVAL events admit jobs into the global FIFO queue,
2. dispatch: for each queued job, ask the router to rank the feasible
   devices and commit to the first whose placement ladder succeeds
   (waking a power-gated device costs ``wake_latency_s``); FIFO with
   backfill — an unplaceable head must not starve jobs behind it,
3. for consolidation routers, power-gate devices left fully idle,
4. FINISH events advance the fleet clock; OOM/early-restart outcomes
   update the job's memory estimate and requeue it at the front —
   possibly migrating it to a bigger device (an A100 job that outgrows
   40GB restarts on an H100).

Every device keeps its own clock, reconfiguration cost and energy
integral; the kernel only ever moves them forward together, so fleet
totals (makespan, Joules) are well-defined.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, Sequence

from repro_torch.core.planner import Migrate
from repro_torch.core.scheduler.admission import AdmissionController
from repro_torch.core.scheduler.events import EARLY_RESTART, OOM, DeviceSim
from repro_torch.core.scheduler.job import Job
from repro_torch.core.scheduler.kernel import (ARRIVAL, FINISH, RECONFIG,
                                               EventKernel, SchedulingPolicy)
from repro_torch.core.scheduler.metrics import FleetMetrics
from repro_torch.fleet.devices import WAKE_LATENCY_S
from repro_torch.fleet.energy import FleetEnergyIntegrator
from repro_torch.fleet.index import RoutingIndex
from repro_torch.fleet.router import Router
from repro_torch.obs.counters import TailStats


def drain_queue(kernel: EventKernel,
                try_dispatch: Callable[[Job], bool],
                candidates: Sequence[Job] | None = None) -> bool:
    """FIFO-with-backfill drain of the kernel's admission queue: try every
    queued job (an unplaceable head must not starve jobs behind it) and
    drop the placed ones.  Filter by identity: Job is a value-equality
    dataclass, so ``list.remove`` could drop an equal-but-different job.
    ``candidates`` restricts the attempt to a sub-list (the incremental
    fresh-arrivals fast-path) while removal still runs against the real
    queue.  Shared by the fleet and cluster policies."""
    placed: set[int] = set()
    for job in kernel.queue if candidates is None else candidates:
        if try_dispatch(job):
            placed.add(id(job))
    if placed:
        kernel.queue[:] = [j for j in kernel.queue
                           if id(j) not in placed]
    return bool(placed)


def gate_idle_devices(kernel: EventKernel,
                      devices: Sequence[DeviceSim]) -> None:
    """Consolidation step: power-gate every device left fully idle.

    The kernel maintains ``awake_idle`` — the indices of ungated, fully
    idle devices, updated on every start/finish — so each pass visits only
    the gateable devices instead of rescanning the fleet on every dispatch
    round.  Iteration runs in ascending kernel index, which is the seed
    scan order both for the full fleet and for the cluster's contiguous
    zone pools.  Each device is synced to the kernel clock first (lazy
    advancement would otherwise bill the un-replayed interval at the gated
    floor), and each gate bumps the placement epoch — gating changes the
    wake-latency term in every subsequent placement's cost.  Kernels
    without the set (the legacy benchmark kernel) take the seed full scan.
    """
    idle = getattr(kernel, "awake_idle", None)
    if idle is None:
        for dev in devices:   # the seed scan, verbatim
            if not dev.gated and not dev.has_running:
                kernel.sync(dev)
                dev.gate()
                kernel.bump_epoch(dev)
        return
    if not idle:
        return
    if devices is kernel.devices:
        candidates = sorted(idle)
    else:
        candidates = sorted(idle & kernel.pool_indices(devices))
    fleet = kernel.devices
    for i in candidates:
        idle.discard(i)
        dev = fleet[i]
        if dev.gated or dev.has_running:
            continue   # stale entry: gated outside the kernel's hooks
        kernel.sync(dev)
        dev.gate()
        kernel.bump_epoch(dev)


class FleetPolicy(SchedulingPolicy):
    """Router-driven dispatch over N devices, as a kernel policy.

    With an :class:`AdmissionController`, each planned placement is gated
    on the post-action |F_s| staying above the graph-computed floor for
    the forecast arrivals: a blocked job is *deferred* (left in the
    queue, re-evaluated on the next finish or on a scheduled admission
    tick), never dropped — and if the fleet would otherwise deadlock, the
    floor is overridden so deferral can only delay, not starve.
    """

    online = True
    #: the fleet's hooks never read device clocks off-schedule: arrivals
    #: only queue, ticks only re-arm — so the kernel may defer the
    #: N-device advance sweep and replay it on sync (bit-for-bit; see
    #: EventKernel.sync)
    lazy_advance = True

    def __init__(self, router: Router, wake_latency_s: float = WAKE_LATENCY_S,
                 energy: FleetEnergyIntegrator | None = None,
                 admission: AdmissionController | None = None) -> None:
        self.router = router
        self.wake_latency_s = wake_latency_s
        self.energy = energy
        self.admission = admission
        self.name = router.name
        self.n_dispatch_calls = 0   # dispatch_job invocations (bench unit)
        self.n_migrations = 0
        self.n_admission_overrides = 0
        self.jct_tail = TailStats("jct_s")
        self._deferred_names: set[str] = set()
        self._force_admit = False
        self._recheck_tick = None                # live admission-recheck Event
        self._last_device: dict[str, str] = {}   # job name -> device name
        # -- queue-rescan fast-path state (see dispatch) --
        self._can_skip = router.stateless_rank   # else: seed rescan path
        self._drain_key = None                   # state key of last full scan
        self._fresh: list[Job] = []              # arrivals since that scan
        self._arrival_rev = 0                    # admission forecast revision
        self._fail_snap: dict[str, tuple] = {}   # job name -> device epochs

    # -- dispatch ----------------------------------------------------------

    def dispatch_job(self, kernel: EventKernel, job: Job,
                     devices: Sequence[DeviceSim] | None = None,
                     extra_setup_s: float = 0.0,
                     changed: frozenset[int] | None = None):
        """Route one job over ``devices`` (default: every kernel device) and
        commit to the first whose placement ladder succeeds AND whose
        post-placement reachability passes admission (when controlled).

        This is the entry point for an *external* router — the cluster
        layer hands each fleet jobs restricted to that fleet's devices,
        with ``extra_setup_s`` carrying the cross-zone data-movement cost.
        ``changed`` (kernel device indices) restricts the planner search to
        devices whose state moved since the job last failed everywhere —
        an unchanged device reproduces the same failed search, so skipping
        it cannot alter the outcome.  Returns ``(device, committed
        action)`` or ``None``.
        """
        self.n_dispatch_calls += 1
        router = self.router
        if router.stateless_rank and getattr(router, "use_index", False):
            # bind (or rebind — routers survive across runs) the routing
            # index lazily, here where the kernel is first known.  Only a
            # stateless cost rank may be index-served, and only a kernel
            # with real epochs may back one: the legacy benchmark kernel
            # advertises no support, so its runs keep the seed path.
            idx = router.index
            if idx is None or idx.kernel is not kernel:
                router.index = (
                    RoutingIndex(kernel)
                    if getattr(kernel, "supports_routing_index", False)
                    else None)
        pool = kernel.devices if devices is None else devices
        if changed is not None:
            # filter BEFORE ranking: the router's cost model is the
            # expensive part of a retry, and an unchanged device's failure
            # is already proven — ranking only the changed subset keeps
            # their relative order, and none of the skipped devices could
            # have admitted the job anyway
            pool = [d for d in pool
                    if kernel._dev_index[id(d)] in changed]
            if not pool:
                return None
        blocked = False
        for dev in self.router.rank(job, pool):
            plan = dev.plan_place(job)
            if plan.chosen is None:
                continue
            if self.admission is not None:
                decision = self.admission.decide(dev.pm, plan, kernel.t,
                                                 shares=len(pool))
                if not decision.admit:
                    if not self._force_admit:
                        blocked = True
                        continue
                    # stall escape: this job is placed BELOW the floor —
                    # count every such admission, not each escape round
                    self.n_admission_overrides += 1
                    if kernel.tracer is not None:
                        kernel.tracer.instant(
                            "admission.override", device=dev.name,
                            lane="admission", cat="admission",
                            job=job.name, reason=decision.reason)
            result = dev.planner.execute(plan)
            if result is None:      # pragma: no cover - chosen was checked
                continue
            action = result.action
            prev = self._last_device.get(job.name)
            if prev is not None and prev != dev.name:
                # cross-device restart: the A100 job that outgrew 40GB
                # landing on an H100 (paper §4.3 lifted to the fleet)
                action = Migrate(device=dev.name, inner=action)
                self.n_migrations += 1
                if kernel.tracer is not None:
                    kernel.tracer.instant(
                        "migrate.device", device=dev.name, lane="router",
                        cat="migrate", job=job.name, source=prev)
            self._last_device[job.name] = dev.name
            setup = result.setup_s + extra_setup_s
            kernel.sync(dev)   # lazy advancement: bill wake/setup from now
            if dev.gated:
                dev.ungate()
                setup += self.wake_latency_s
            kernel.start(dev, job, result.partition, setup_s=setup)
            return dev, action
        if blocked:
            self._note_deferral(kernel, job)
        return None

    def _note_deferral(self, kernel: EventKernel, job: Job) -> None:
        """Every placeable device failed admission: the job stays queued.
        Schedule an admission tick so the decision is revisited even if no
        finish event arrives first (the forecast decays in the meantime)."""
        if kernel.tracer is not None:
            kernel.tracer.instant("admission.defer", lane="admission",
                                  cat="admission", job=job.name)
        self._deferred_names.add(job.name)
        retry = self.admission.retry_s
        if retry is not None and self._recheck_tick is None:
            self._recheck_tick = kernel.schedule_tick(kernel.t + retry, self)

    def on_tick(self, kernel: EventKernel, payload) -> None:
        # admission recheck: the kernel loop re-runs dispatch after every
        # event; the tick only needs to exist (and re-arm on re-deferral)
        self._recheck_tick = None

    def forget(self, job_name: str) -> None:
        """Drop ALL of the job's per-name state: placement history (it
        moved to another fleet — a later return must not double-count as
        an intra-fleet migration; the cluster layer counts the cross-zone
        move instead), its failure snapshot, and its open deferral.
        Called on cross-zone moves and on control-plane lease release, so
        repeated provision→release cycles stay leak-free: before this
        audit only ``_last_device`` was dropped, and ``_fail_snap`` was
        keyed by ``id(job)`` — a recycled object id could alias a new
        job onto a dead job's epoch snapshot and silently skip its first
        retry."""
        self._last_device.pop(job_name, None)
        self._fail_snap.pop(job_name, None)
        self._deferred_names.discard(job_name)

    def _dispatch_one(self, kernel: EventKernel, job: Job) -> bool:
        changed = None
        track = (self._can_skip and self.admission is None
                 and not self._force_admit)
        if track:
            snap = self._fail_snap.get(job.name)
            if snap is not None:
                epochs = kernel.device_epoch
                if snap == tuple(epochs):
                    return False   # nothing changed anywhere: same failure
                changed = frozenset(
                    i for i, (then, now) in enumerate(zip(snap, epochs))
                    if then != now)
        placed = self.dispatch_job(kernel, job, changed=changed)
        if placed is not None:
            self._fail_snap.pop(job.name, None)
            return True
        if track:
            self._fail_snap[job.name] = tuple(kernel.device_epoch)
        return False

    def _scan_key(self, kernel: EventKernel):
        """State fingerprint for queue rescans.  Placement outcomes depend
        only on device/partition state (the epoch) — plus, under admission
        control, the clock and the arrival forecast, which the decision
        reads directly."""
        if self.admission is not None:
            return (kernel.capacity_epoch, kernel.t, self._arrival_rev)
        return (kernel.capacity_epoch,)

    def dispatch(self, kernel: EventKernel) -> bool:
        """Drain the queue — skipping provably-redundant rescans.

        The kernel calls dispatch after every event; the seed re-tried
        every queued job each time, an O(events x queue x devices) planner
        storm on a backlogged trace.  A failed placement can only flip if
        something changed, so: a full scan runs when the state key moved
        (captured *before* the scan — placements inside it bump the epoch
        and force the follow-up rescan the eager loop also did); when the
        key is unchanged, only arrivals admitted since the last scan are
        tried; with neither, dispatch is O(1).  Per-job failure snapshots
        of the per-device epochs then narrow each full-scan retry to the
        devices that actually changed.  Every skip suppresses a search
        whose outcome is proven identical, which is why the golden parity
        suite pins this path bit-for-bit against the eager seed."""
        key = self._scan_key(kernel)
        attempt = functools.partial(self._dispatch_one, kernel)
        if self._force_admit or not self._can_skip:
            # stall escape (retry everything below the admission floor,
            # leaving the key stale so the normal path rescans afterwards)
            # — or a stateful router, which must see the seed's exact
            # rank-call sequence
            placed = drain_queue(kernel, attempt)
            self._fresh.clear()
        elif key != self._drain_key:
            self._drain_key = key
            self._fresh.clear()
            placed = drain_queue(kernel, attempt)
        elif self._fresh:
            fresh, self._fresh = self._fresh, []
            placed = drain_queue(kernel, attempt, candidates=fresh)
        else:
            placed = False
        if not kernel.queue and self._recheck_tick is not None:
            # every deferred job found a home via an earlier event: a live
            # recheck tick would only stretch the run (and its idle-energy
            # integral) past the real last finish
            kernel.cancel(self._recheck_tick)
            self._recheck_tick = None
        if self.router.consolidates:
            gate_idle_devices(kernel, kernel.devices)
        return placed

    # -- events ------------------------------------------------------------

    def on_arrival(self, kernel: EventKernel, job) -> None:
        if self.admission is not None:
            self.admission.note_arrival(kernel.t, job)
            self._arrival_rev += 1   # the forecast moved: rescans may flip
        kernel.queue.append(job)
        self._fresh.append(job)

    def on_finish(self, kernel: EventKernel, dev: DeviceSim, run) -> None:
        if run.plan.outcome in (OOM, EARLY_RESTART):
            run.job.est_mem_gb = run.plan.new_est_mem_gb
            kernel.queue.insert(0, run.job)   # restart: earliest arrival
        else:
            self.jct_tail.observe(run.t_end - run.job.arrival)

    def on_stall(self, kernel: EventKernel) -> None:
        # an *external* event (arrival, finish, reconfig) may genuinely
        # unblock the queue; our own admission-recheck ticks do not count —
        # if they were all that remains, waiting would spin forever
        if any(kernel.has_events(k) for k in (FINISH, RECONFIG, ARRIVAL)):
            return
        if self.admission is None and kernel.has_events():
            return   # no admission ticks exist; preserve legacy behaviour
        if self.admission is not None and not self._force_admit:
            # nothing running, nothing coming, and the queue is (at least
            # partly) admission-deferred: the floor must yield — deferral
            # may delay work, never starve it (dispatch_job counts each
            # job it places past the floor in n_admission_overrides)
            self._force_admit = True
            try:
                placed = self.dispatch(kernel)
            finally:
                self._force_admit = False
            if placed:
                return
        worst = kernel.queue[0]
        raise RuntimeError(
            f"deadlock: {worst.name} "
            f"(est {worst.est_mem_gb}GB) fits no device in "
            f"[{', '.join(d.name for d in kernel.devices)}]")

    # -- reporting ---------------------------------------------------------

    def result(self, kernel: EventKernel, jobs: list) -> FleetMetrics:
        energy = self.energy or FleetEnergyIntegrator(kernel.devices)
        arrival_of = {j.name: j.arrival for j in jobs}
        if not arrival_of:
            # streamed run: no jobs list survives the loop — the devices'
            # own arrival stamps carry the same facts
            for dev in kernel.devices:
                arrival_of.update(dev.arrivals)
        completions: dict[str, float] = {}
        for dev in kernel.devices:
            completions.update(dev.finished)
        jcts = [completions[name] - arrival_of[name]
                for name in completions]
        per_device = [dev.metrics(len(dev.finished))
                      for dev in kernel.devices]
        records = [(dev.name, rec) for dev in kernel.devices
                   for rec in dev.records]
        records.sort(key=lambda dr: dr[1].start)
        return FleetMetrics(
            policy=self.router.name,
            fleet=", ".join(d.name for d in kernel.devices),
            n_jobs=len(jobs) or kernel.n_jobs_seen,
            makespan=max(kernel.t, 1e-9),
            energy_j=energy.joules,
            gated_seconds=energy.gated_seconds,
            idle_joules_avoided=energy.idle_joules_avoided,
            mean_jct=sum(jcts) / max(len(jcts), 1),
            n_oom=sum(d.n_oom for d in kernel.devices),
            n_early_restarts=sum(d.n_early for d in kernel.devices),
            n_reconfigs=sum(d.pm.n_reconfigs for d in kernel.devices),
            wasted_seconds=sum(d.wasted for d in kernel.devices),
            per_device=per_device, records=records,
            n_migrations=self.n_migrations,
            n_admission_deferrals=len(self._deferred_names),
            n_admission_overrides=self.n_admission_overrides,
            p99_jct=(self.jct_tail.percentile(99)
                     if self.jct_tail.count else 0.0))


class FleetOrchestrator:
    """Owns the devices and the fleet-wide energy aggregation; ``run`` is a
    thin kernel invocation with a :class:`FleetPolicy`."""

    def __init__(self, devices: Sequence[DeviceSim], router: Router,
                 wake_latency_s: float = WAKE_LATENCY_S,
                 admission: AdmissionController | None = None) -> None:
        # device validation (non-empty, unique names) happens in
        # EventKernel.__init__ when run() builds the kernel
        self.devices = list(devices)
        self.router = router
        self.wake_latency_s = wake_latency_s
        self.admission = admission
        self.energy = FleetEnergyIntegrator(self.devices)

    def run(self, jobs: Iterable[Job], tracer=None) -> FleetMetrics:
        """Thin shim over :func:`repro_torch.api.simulate` (kind ``"fleet"``);
        the orchestrator's own energy integrator is passed through so
        repeated ``run`` calls keep accumulating fleet Joules."""
        from repro_torch.api import RunSpec, simulate
        return simulate(RunSpec(kind="fleet", devices=self.devices,
                                router=self.router, jobs=jobs,
                                wake_latency_s=self.wake_latency_s,
                                admission=self.admission,
                                energy=self.energy, tracer=tracer))


def run_fleet(devices: Sequence[DeviceSim], router: Router,
              jobs: Iterable[Job],
              wake_latency_s: float = WAKE_LATENCY_S,
              admission: AdmissionController | None = None,
              tracer=None) -> FleetMetrics:
    """Thin shim over :func:`repro_torch.api.simulate` (kind ``"fleet"``)."""
    return FleetOrchestrator(devices, router,
                             wake_latency_s=wake_latency_s,
                             admission=admission).run(jobs, tracer=tracer)
