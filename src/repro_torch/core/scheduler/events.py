"""Device mechanism for the discrete-event simulators; the port's copy of
``repro.core.scheduler.events``.

The paper evaluates on a real A100 polled via nvidia-smi; this module is
the *device model* of the same experiment — runtime stretch, IO
contention, power and memory integrals, the OOM/early-restart execution
plans — calibrated to the paper's Tables 3-4.  It is host code: it
launches nothing on a device.  The *policies* (the paper's Algorithms 4
and 5) live in :mod:`repro_torch.core.scheduler.policies`, driving this
mechanism through the unified event kernel
(:mod:`repro_torch.core.scheduler.kernel`).
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools

from repro_torch.core.partition_manager import Partition, PartitionManager
from repro_torch.core.partition_state import (PartitionBackend,
                                              PartitionProfile)
from repro_torch.core.planner import (SCHEME_B_COST, PartitionPlanner, Plan,
                                      place_request)
from repro_torch.core.scheduler.energy import (DevicePowerModel,
                                               EnergyIntegrator)
from repro_torch.core.scheduler.job import GB, Job
from repro_torch.core.scheduler.metrics import Metrics, RunRecord
from repro_torch.core.memory.timeseries import PeakMemoryPredictor
from repro_torch.obs.counters import TailStats

DONE = "done"
OOM = "oom"
EARLY_RESTART = "early_restart"

#: time to create/destroy a MIG instance (nvidia-smi mig operations are
#: hundreds of ms) — the cost scheme A's group batching amortizes and
#: scheme B pays per reconfiguration (paper §4.3: A "minimizes the number
#: of dynamic reconfigurations").
RECONFIG_COST_S = 0.3


@dataclasses.dataclass
class ExecutionPlan:
    duration: float
    outcome: str
    new_est_mem_gb: float | None = None   # updated estimate on oom/early
    iterations_run: int = 0
    wasted_seconds: float = 0.0


def _plan_dynamic(job: Job, profile: PartitionProfile, use_prediction: bool,
                  backend: PartitionBackend) -> ExecutionPlan:
    """The trajectory replay — O(n_iters); results are cached per
    (backend, profile, predict) on the job since they depend on nothing
    else (IO stretch never enters the iterative path)."""
    c = profile.compute_fraction
    part_bytes = profile.mem_gb * GB
    traj = job.trajectory
    stretch = max(1.0, job.compute_demand / max(c, 1e-6))
    t_iter = traj.t_per_iter * stretch
    oom_it = traj.oom_iteration(part_bytes)

    if use_prediction:
        predictor = PeakMemoryPredictor(max_iter=traj.n_iters)
        for i, (m, r) in enumerate(zip(traj.req_mem, traj.reuse_ratio)):
            pred = predictor.observe(m, r)
            if predictor.will_oom(part_bytes, pred):
                # early restart BEFORE the crash (paper §2.3/§5.2.2)
                dur = job.t_fixed + (i + 1) * t_iter
                return ExecutionPlan(
                    duration=dur, outcome=EARLY_RESTART,
                    new_est_mem_gb=pred.peak_mem_bytes / GB,
                    iterations_run=i + 1, wasted_seconds=dur)
            if oom_it is not None and i >= oom_it:
                break  # crash arrives before the predictor fires
    if oom_it is not None:
        dur = job.t_fixed + (oom_it + 1) * t_iter
        bigger = backend.next_larger_profile(profile)
        new_est = bigger.mem_gb if bigger else traj.peak_phys / GB
        return ExecutionPlan(duration=dur, outcome=OOM,
                             new_est_mem_gb=new_est,
                             iterations_run=oom_it + 1, wasted_seconds=dur)
    return ExecutionPlan(duration=job.t_fixed + traj.n_iters * t_iter,
                         outcome=DONE, iterations_run=traj.n_iters)


def plan_execution(job: Job, profile: PartitionProfile, io_stretch: float,
                   use_prediction: bool,
                   backend: PartitionBackend) -> ExecutionPlan:
    """Decide how a run of ``job`` on ``profile`` terminates."""
    if not job.is_dynamic:
        c = profile.compute_fraction
        full = job.runtime_on(c, io_stretch)
        if job.mem_gb > profile.mem_gb:
            # static job with an under-estimate: OOM once allocation happens
            fail_at = job.t_fixed + 0.1 * (full - job.t_fixed)
            bigger = backend.next_larger_profile(profile)
            new_est = bigger.mem_gb if bigger else job.mem_gb
            return ExecutionPlan(duration=fail_at, outcome=OOM,
                                 new_est_mem_gb=new_est,
                                 wasted_seconds=fail_at)
        return ExecutionPlan(duration=full, outcome=DONE)

    # the dynamic path replays the whole trajectory through the predictor —
    # memoize it so repeated placements/restart probes stay O(1).  The key
    # captures every input _plan_dynamic reads from the profile/backend
    # (slice size, compute, the next-larger OOM rung) rather than the
    # backend class: two differently-parameterized instances of the same
    # backend class may share profile names but not profile tables.
    bigger = backend.next_larger_profile(profile)
    key = (profile.name, profile.mem_gb, profile.compute_fraction,
           bigger.mem_gb if bigger else None, use_prediction)
    plan = job.plan_cache.get(key)
    if plan is None:
        plan = _plan_dynamic(job, profile, use_prediction, backend)
        job.plan_cache[key] = plan
    # callers mutate ``duration`` (setup seconds); hand out a copy
    return dataclasses.replace(plan)


@dataclasses.dataclass(order=True)
class _Running:
    t_end: float
    seq: int
    job: Job = dataclasses.field(compare=False)
    partition: Partition = dataclasses.field(compare=False)
    plan: ExecutionPlan = dataclasses.field(compare=False)
    t_start: float = dataclasses.field(compare=False, default=0.0)
    avg_util: float = dataclasses.field(compare=False, default=0.0)


class DeviceSim:
    """One device's simulator mechanism: clock, running set, energy + memory
    integrals, reconfiguration costs and the OOM/early-restart paths.

    Instantiable — a single-device experiment drives one of these through
    the event kernel with a batch policy
    (:mod:`repro_torch.core.scheduler.policies`); the reference's fleet
    orchestrator owns N of them, each with its own clock, behind one global
    admission queue.
    """

    #: flight recorder (repro_torch.obs.Tracer); instance-assigned by the event
    #: kernel when a run is traced, class-default None otherwise
    tracer = None

    def __init__(self, backend: PartitionBackend, power: DevicePowerModel,
                 use_prediction: bool = True, policy: str = "",
                 name: str = "dev0",
                 reconfig_cost_s: float = RECONFIG_COST_S,
                 record_runs: bool = True) -> None:
        self.backend = backend
        self.pm = PartitionManager(backend)
        self.planner = PartitionPlanner(self.pm, SCHEME_B_COST)
        self.energy = EnergyIntegrator(power)
        self.use_prediction = use_prediction
        self.policy = policy
        self.name = name
        self.reconfig_cost_s = reconfig_cost_s
        #: per-run RunRecord retention — disable for million-event trace
        #: replays, where a stored per-run list is exactly the memory
        #: cliff the streaming tail estimators were built to avoid
        self.record_runs = record_runs
        self.t = 0.0
        self._heap: list[_Running] = []
        self._seq = itertools.count()
        self.records: list[RunRecord] = []
        self.finished: dict[str, float] = {}
        self.arrivals: dict[str, float] = {}
        self.n_oom = 0
        self.n_early = 0
        self.wasted = 0.0
        self.turnaround_tail = TailStats("turnaround_s")
        self._mem_integral = 0.0
        self._live_mem_gb = 0.0

    # -- integrals ---------------------------------------------------------

    def _advance_time(self, t: float) -> None:
        self._mem_integral += self._live_mem_gb * (t - self.t)
        self.energy.advance(t, self._active_compute())
        self.t = t

    def _active_compute(self) -> float:
        # Dynamic power is charged over *kernel* time, not IO-wait time —
        # each run contributes its time-averaged utilization so total dynamic
        # energy is work-conserving across schedulers; energy differences
        # then come from the idle floor x makespan (paper: energy tracks
        # throughput).
        return sum(r.avg_util for r in self._heap)

    def _io_stretch(self) -> float:
        demand = sum(r.job.io_bw_demand for r in self._heap)
        return max(1.0, demand)

    # -- run control ---------------------------------------------------------

    def start(self, job: Job, partition: Partition,
              setup_s: float = 0.0) -> _Running:
        if self.gated:
            # starting work implies the device is powered: without this a
            # direct caller would bill the whole run at the gated floor
            # (the orchestrator ungates earlier to charge wake latency)
            self.ungate()
        io_stretch = max(1.0, self._io_stretch() + job.io_bw_demand)
        plan = plan_execution(job, partition.profile, io_stretch,
                              self.use_prediction, self.backend)
        plan.duration += setup_s  # partition-creation latency, if any
        partition.busy = True
        c = partition.profile.compute_fraction
        busy_util = min(c, job.compute_demand)
        if job.is_dynamic:
            avg_util = busy_util  # iterative decode/train: compute-bound
        else:
            avg_util = busy_util * (job.kernel_seconds_on(c)
                                    / max(plan.duration, 1e-9))
        run = _Running(t_end=self.t + plan.duration, seq=next(self._seq),
                       job=job, partition=partition, plan=plan,
                       t_start=self.t, avg_util=avg_util)
        self.arrivals[job.name] = job.arrival
        # re-integrate with the new running set
        self._advance_time(self.t)
        heapq.heappush(self._heap, run)
        self._live_mem_gb += min(job.mem_gb, partition.profile.mem_gb)
        self.energy.advance(self.t, self._active_compute())
        return run

    def pop_next_finish(self) -> _Running:
        run = heapq.heappop(self._heap)
        # integrate the interval [self.t, run.t_end] *including* this run
        self._mem_integral += self._live_mem_gb * (run.t_end - self.t)
        self.energy.advance(run.t_end, self._active_compute())
        self.t = run.t_end
        self._live_mem_gb -= min(run.job.mem_gb,
                                 run.partition.profile.mem_gb)
        run.partition.busy = False
        if self.record_runs:
            self.records.append(RunRecord(
                job=run.job.name, profile=run.partition.profile.name,
                start=run.t_start, end=run.t_end, outcome=run.plan.outcome,
                compute_fraction=run.partition.profile.compute_fraction,
                mem_gb=run.job.mem_gb,
                wasted_seconds=run.plan.wasted_seconds))
        if run.plan.outcome == OOM:
            self.n_oom += 1
            self.wasted += run.plan.wasted_seconds
            if self.tracer is not None:
                self.tracer.instant("oom", t=run.t_end, device=self.name,
                                    job=run.job.name,
                                    profile=run.partition.profile.name)
        elif run.plan.outcome == EARLY_RESTART:
            self.n_early += 1
            self.wasted += run.plan.wasted_seconds
            if self.tracer is not None:
                self.tracer.instant("early_restart", t=run.t_end,
                                    device=self.name, job=run.job.name,
                                    profile=run.partition.profile.name)
        else:
            self.finished[run.job.name] = run.t_end
            self.turnaround_tail.observe(
                run.t_end - self.arrivals[run.job.name])
        return run

    @property
    def has_running(self) -> bool:
        return bool(self._heap)

    @property
    def next_finish_time(self) -> float | None:
        return self._heap[0].t_end if self._heap else None

    def advance_to(self, t: float) -> None:
        """Idle until ``t`` (online mode: waiting for the next arrival)."""
        if t > self.t:
            self._advance_time(t)

    # -- power gating (fleet consolidation) --------------------------------

    @property
    def gated(self) -> bool:
        return self.energy.gated

    def gate(self) -> None:
        """Drop to the gated power floor; only legal while fully idle."""
        if self._heap:
            raise ValueError(f"{self.name}: cannot gate with running jobs")
        self._advance_time(self.t)
        self.energy.set_gated(True)
        if self.tracer is not None:
            self.tracer.instant("power.gate", t=self.t, device=self.name,
                                cat="power")

    def ungate(self) -> None:
        was_gated = self.energy.gated
        self._advance_time(self.t)
        self.energy.set_gated(False)
        if was_gated and self.tracer is not None:
            self.tracer.instant("power.ungate", t=self.t, device=self.name,
                                cat="power")

    # -- placement (scheme B's step, reusable by the fleet router) ---------

    def plan_place(self, job: Job) -> Plan:
        """Scored-candidate placement search for ``job`` under the scheme-B
        cost weights (tight idle reuse > fresh carve > fusion/fission, each
        at argmax reachability) — one pass, nothing committed."""
        return self.planner.plan(place_request(
            self.backend, job.est_mem_gb, job.compute_demand,
            reconfig_cost_s=self.reconfig_cost_s))

    def try_place(self, job: Job) -> tuple[Partition, float] | None:
        """Plan + commit a placement.  Returns (partition, setup seconds)
        or None when the device cannot host the job right now."""
        result = self.planner.execute(self.plan_place(job))
        if result is None:
            return None
        return result.partition, result.setup_s

    # -- routing scores (fleet) --------------------------------------------

    def busy_mem_gb(self) -> float:
        return sum(p.profile.mem_gb for p in self.pm.live.values() if p.busy)

    def free_mem_gb(self) -> float:
        """Memory not pinned under a running job (idle partitions count as
        free: they can be reshaped)."""
        return self.backend.total_mem_gb() - self.busy_mem_gb()

    def load_fraction(self) -> float:
        return self.busy_mem_gb() / self.backend.total_mem_gb()

    def fits(self, job: Job) -> bool:
        """Whether ``job`` can EVER run here (largest profile covers its
        current memory estimate) — feasibility, not availability."""
        est = job.est_mem_gb if job.est_mem_gb is not None else 0.0
        return est <= self.backend.profiles[-1].mem_gb

    def metrics(self, n_jobs: int) -> Metrics:
        makespan = max(self.t, 1e-9)
        return Metrics(
            policy=self.policy, n_jobs=n_jobs, makespan=makespan,
            energy_j=self.energy.joules, device=self.name,
            mem_util=self._mem_integral / (makespan
                                           * self.backend.total_mem_gb()),
            mean_turnaround=(sum(t_end - self.arrivals[name]
                                 for name, t_end in self.finished.items())
                             / max(len(self.finished), 1)),
            n_oom=self.n_oom, n_early_restarts=self.n_early,
            n_reconfigs=self.pm.n_reconfigs, wasted_seconds=self.wasted,
            records=self.records,
            p99_turnaround=(self.turnaround_tail.percentile(99)
                            if self.turnaround_tail.count else 0.0))
