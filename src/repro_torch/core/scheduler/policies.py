"""The paper's scheduling policies as thin plug-ins over the event kernel;
the port's copy of ``repro.core.scheduler.policies``.

Algorithms 4 and 5 (scheme A's SCHEDULE_BY_GROUP, scheme B's
SCHEDULE_DYN_RECONFIG) and the sequential baseline are ~60-line policies
over :class:`~repro_torch.core.scheduler.kernel.EventKernel`.  The port's
tests hold their metrics bit for bit to the reference's on the seeded
Fig. 4 mixes, on both MIG cards.
"""

from __future__ import annotations

from typing import Iterable

from repro_torch.core.partition_manager import Partition
from repro_torch.core.partition_state import PartitionBackend
from repro_torch.core.planner.ladders import tight_profile
from repro_torch.core.planner.lookahead import carve_homogeneous
from repro_torch.core.scheduler.energy import DevicePowerModel
from repro_torch.core.scheduler.events import (EARLY_RESTART, OOM,
                                               RECONFIG_COST_S, DeviceSim)
from repro_torch.core.scheduler.job import Job
from repro_torch.core.scheduler.kernel import EventKernel, SchedulingPolicy
from repro_torch.core.scheduler.metrics import Metrics


class _SingleDevicePolicy(SchedulingPolicy):
    """Shared result shape for the single-device batch policies."""

    def result(self, kernel: EventKernel, jobs: list) -> Metrics:
        return kernel.devices[0].metrics(len(jobs))


class BaselinePolicy(_SingleDevicePolicy):
    """The paper's baseline: a non-partitioned device runs the batch
    sequentially (§5: 'the batch executing sequentially on the GPU')."""

    name = "baseline"
    online = False

    def dispatch(self, kernel: EventKernel) -> bool:
        dev = kernel.devices[0]
        if dev.has_running or not kernel.queue:
            return False
        part = dev.pm.allocate(dev.backend.profiles[-1])
        assert part is not None
        kernel.start(dev, kernel.queue.pop(0), part)
        return True

    def on_finish(self, kernel: EventKernel, dev: DeviceSim, run) -> None:
        dev.pm.release(run.partition)


class SchemeAPolicy(_SingleDevicePolicy):
    """Algorithm 4 — SCHEDULE_BY_GROUP: sort by MIG group, configure
    homogeneous slices per group, schedule the group, reconfigure, repeat.

    ``work_steal=False`` reproduces the paper's static equal division of a
    group across its partitions (the Ml3 corner case); ``True`` is the
    beyond-paper fix (pull-based dispatch).
    """

    online = False

    def __init__(self, use_prediction: bool = True,
                 work_steal: bool = False, plan_ahead: int = 0) -> None:
        self.use_prediction = use_prediction
        self.work_steal = work_steal
        #: beam width for k-step plan-ahead carving over the compiled
        #: transition graph (repro_torch.core.planner.lookahead); 0 keeps the
        #: seed's greedy per-slice ``pm.allocate`` loop bit-for-bit.  The
        #: beam always scores the greedy chain as a candidate, so
        #: enabling it can reorder/improve a group's slices but never
        #: carve fewer or weaker ones.
        self.plan_ahead = plan_ahead
        self.name = ("scheme_a" + ("+pred" if use_prediction else "")
                     + ("+steal" if work_steal else "")
                     + ("+plan" if plan_ahead else ""))

    def on_init(self, kernel: EventKernel, jobs: list) -> None:
        backend = kernel.devices[0].backend
        # SORTED_BY_MIG_GROUP: map each job to its tightest profile
        self.groups: dict[str, list[Job]] = {}
        for job in kernel.queue:
            self.groups.setdefault(
                tight_profile(backend, job.est_mem_gb).name, []).append(job)
        self.order = sorted(self.groups, key=lambda n: next(
            p.mem_gb for p in backend.profiles if p.name == n))
        self.gi = 0
        self.pending_larger: list[Job] = []  # OOM/early spill to later groups
        self.parts: list[Partition] = []     # the active group's partitions
        self.steal_queue: list[Job] = []
        self.by_part: dict[int, list[Job]] = {}
        kernel.queue = []   # consumed into groups

    def dispatch(self, kernel: EventKernel) -> bool:
        dev = kernel.devices[0]
        if dev.has_running:
            return False
        if self.parts:      # the group just drained: tear its slices down
            for part in self.parts:
                dev.pm.release(part)
            self.parts = []
        if self.gi >= len(self.order) and not self.pending_larger:
            return False
        self._open_group(kernel, dev)
        return True

    def _open_group(self, kernel: EventKernel, dev: DeviceSim) -> None:
        backend = dev.backend
        if self.gi < len(self.order):
            pname = self.order[self.gi]
            group = self.groups[pname]
            self.gi += 1
        else:
            # leftover restarts larger than every original group
            group = self.pending_larger
            self.pending_larger = []
            pname = tight_profile(backend, group[0].est_mem_gb).name
        # pull in restarts that now fit this group's profile
        profile = next(p for p in backend.profiles if p.name == pname)
        still_larger = []
        for j in self.pending_larger:
            if tight_profile(backend, j.est_mem_gb).name == pname:
                group.append(j)
            else:
                still_larger.append(j)
        self.pending_larger = still_larger

        # SET_HOMOGENEOUS_SLICES: carve as many slices of this memory size
        # as possible, preferring the compute-maximal profile first — on the
        # A100 this yields 4g.20gb + 3g.20gb (the paper's §5.2.1 pair whose
        # 4/7 vs 3/7 compute asymmetry causes the Ml3 corner case).
        same_mem = sorted(
            [p for p in backend.profiles if p.mem_gb == profile.mem_gb],
            key=lambda p: -p.compute_fraction)
        if self.plan_ahead > 0:
            # k-step lookahead over the compiled graph: score whole carve
            # chains instead of committing slice-by-slice (greedy is still
            # a candidate, so this is never worse)
            parts = carve_homogeneous(dev.pm, same_mem,
                                      beam_width=self.plan_ahead)
        else:
            parts = []
            while True:
                part = None
                for prof_try in same_mem:
                    part = dev.pm.allocate(prof_try)
                    if part is not None:
                        break
                if part is None:
                    break
                parts.append(part)
        assert parts, f"cannot create any {profile.name} partition"
        self.parts = parts

        # SCHEDULE(group)
        setup = RECONFIG_COST_S
        if self.work_steal:
            self.steal_queue = list(group)
            for part in parts:
                if self.steal_queue:
                    kernel.start(dev, self.steal_queue.pop(0), part,
                                 setup_s=setup)
                    setup = 0.0
        else:
            # paper-faithful: equal static division across partitions
            queues: list[list[Job]] = [[] for _ in parts]
            for i, j in enumerate(group):
                queues[i % len(parts)].append(j)
            self.by_part = {p.pid: q for p, q in zip(parts, queues)}
            for part in parts:
                if self.by_part[part.pid]:
                    kernel.start(dev, self.by_part[part.pid].pop(0), part,
                                 setup_s=setup)
                    setup = 0.0

    def on_finish(self, kernel: EventKernel, dev: DeviceSim, run) -> None:
        if run.plan.outcome in (OOM, EARLY_RESTART):
            run.job.est_mem_gb = run.plan.new_est_mem_gb
            self.pending_larger.append(run.job)
        if self.work_steal:
            if self.steal_queue:
                kernel.start(dev, self.steal_queue.pop(0), run.partition)
        else:
            q = self.by_part[run.partition.pid]
            if q:
                kernel.start(dev, q.pop(0), run.partition)


class SchemeBPolicy(_SingleDevicePolicy):
    """Algorithm 5 — SCHEDULE_DYN_RECONFIG: FIFO order; tight idle partition,
    else create, else merge/split (fusion/fission), else SLEEP until a
    running job finishes.  The preference order lives in the unified
    partition planner (``SCHEME_B_COST`` weights) behind
    :meth:`DeviceSim.try_place`, not in this policy.

    Supports ONLINE arrivals: jobs with ``arrival > 0`` join the queue when
    their time comes (the paper's "scheduler receives incoming workloads");
    a batch is simply the all-arrive-at-zero special case."""

    online = True

    def __init__(self, use_prediction: bool = True) -> None:
        self.use_prediction = use_prediction
        self.name = "scheme_b" + ("+pred" if use_prediction else "")

    def dispatch(self, kernel: EventKernel) -> bool:
        dev = kernel.devices[0]
        scheduled_any = False
        while kernel.queue:
            placed = dev.try_place(kernel.queue[0])
            if placed is None:
                break   # SLEEP: wait for a finish event
            part, setup = placed
            kernel.start(dev, kernel.queue.pop(0), part, setup_s=setup)
            scheduled_any = True
        return scheduled_any

    def on_finish(self, kernel: EventKernel, dev: DeviceSim, run) -> None:
        if run.plan.outcome in (OOM, EARLY_RESTART):
            run.job.est_mem_gb = run.plan.new_est_mem_gb
            kernel.queue.insert(0, run.job)  # restart: it arrived earliest

    def on_stall(self, kernel: EventKernel) -> None:
        job = kernel.queue[0]
        raise RuntimeError(
            f"deadlock: cannot place {job.name} "
            f"(est {job.est_mem_gb}GB) on an empty device")


# ---------------------------------------------------------------------------
# Entry points — one DeviceSim, one policy, one kernel
# ---------------------------------------------------------------------------

def run_baseline(jobs: Iterable[Job], backend: PartitionBackend,
                 power: DevicePowerModel, tracer=None) -> Metrics:
    """Thin shim over :func:`repro_torch.api.simulate`
    (kind ``"baseline"``)."""
    from repro_torch.api import RunSpec, simulate
    return simulate(RunSpec(kind="baseline", jobs=list(jobs),
                            backend=backend, power=power, tracer=tracer))


def run_scheme_a(jobs: Iterable[Job], backend: PartitionBackend,
                 power: DevicePowerModel, use_prediction: bool = True,
                 work_steal: bool = False, plan_ahead: int = 0,
                 tracer=None) -> Metrics:
    """Thin shim over :func:`repro_torch.api.simulate`
    (kind ``"scheme_a"``)."""
    from repro_torch.api import RunSpec, simulate
    return simulate(RunSpec(kind="scheme_a", jobs=list(jobs),
                            backend=backend, power=power,
                            use_prediction=use_prediction,
                            work_steal=work_steal, plan_ahead=plan_ahead,
                            tracer=tracer))


def run_scheme_b(jobs: Iterable[Job], backend: PartitionBackend,
                 power: DevicePowerModel, use_prediction: bool = True,
                 tracer=None) -> Metrics:
    """Thin shim over :func:`repro_torch.api.simulate`
    (kind ``"scheme_b"``)."""
    from repro_torch.api import RunSpec, simulate
    return simulate(RunSpec(kind="scheme_b", jobs=list(jobs),
                            backend=backend, power=power,
                            use_prediction=use_prediction, tracer=tracer))
