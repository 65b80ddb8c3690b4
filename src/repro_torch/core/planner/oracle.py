"""Offline regret oracle: an exact DP optimum over the compiled FSM; the
port's copy of ``repro.core.planner.oracle``.

"Optimal Workload Placement on Multi-Instance GPUs" (arXiv:2409.06646)
computes exact offline optima over the MIG partition space; this module is
that yardstick for the repo's policies.  A policy change reports a number
against ground truth instead of wins-vs-each-other.

The relaxed clairvoyant model (why ``regret >= 0`` is structural)
-----------------------------------------------------------------
The oracle schedules each batch job under three documented relaxations of
the simulator's execution model:

* **clairvoyant memory** — the true peak physical memory is known up
  front, so the oracle never OOMs, never early-restarts, and never pays a
  wasted partial run (the schemes' estimators only converge toward this);
* **no IO contention** — ``io_stretch`` is pinned to 1.0 (concurrent
  transfers never slow each other down);
* **free reconfiguration** — partition carves cost zero setup seconds,
  and idle slices can be fissioned back at any instant.

Under these, a job's duration on a slice with compute fraction ``c`` is
``t_fixed + t_kernel * max(1, demand / c) + t_io`` — pointwise less than
or equal to any duration the simulator can produce for the same (job,
profile).  Any *real* executed schedule therefore induces a feasible
relaxed schedule (keep each job's final successful run's slice and start
order; every run only gets shorter, every partition the real schedule
carved was FSM-feasible), so the relaxed optimum is a true lower bound on
every policy's makespan: ``regret = makespan_policy - T_opt >= 0``, for
baseline, scheme A/B and the fleet routers alike.  Durations are floored
to integer microseconds (rounding *down*, preserving the bound) so the
DP's arithmetic is exact integer math.

Exact DP over the transition graph
----------------------------------
A DP node is ``(fsm_state, pending, running)``: the compiled FSM state
holding exactly the running slices, the pending multiset collapsed to
per-job-class counts, and the running multiset of ``(remaining_us,
class, handle)``.  Actions are *start* (place a pending job's class on a
feasible profile, one placement per distinct successor state — the
compiled :class:`~repro_torch.core.planner.graph.TransitionGraph` makes this a
dict lookup) and *advance* (jump to the earliest completion, freeing
every slice that finishes there).  Starts never increase remaining work
and advances strictly decrease it, so the node space is a finite DAG;
:meth:`BatchOracle.value` memoizes over it, which *is* the exhaustive
enumeration of the reachable (state, pending-set) space — when the memo
completes within ``node_budget``, the optimum is exact by construction.
When the budget trips (the fine-grained-duration heterogeneous mixes),
the caller falls back to :func:`admissible_lower_bound_s` — a
work-area / critical-path bound that is still a valid lower bound, just
not tight — and reports ``exact=False``.

The same memo answers per-decision continuation queries: replaying a
flight-recorder audit (see :mod:`repro_torch.obs.replay`) reconstructs the
decision point's node, and ``Q(audited action) - V(node)`` is that
decision's regret, attributed alongside the recorded deciding tier.

Serving grow/wait sequences (:func:`grow_wait_sequence_bound`) get the
documented *bounded/beam relaxation* instead of the exact DP: a beam DP
over the audited candidate lattice whose per-step cost is optimistically
zero wherever the trace recorded no candidates for the hypothetical
engine profile — a lower bound on the audited trade cost by
construction, not an exact optimum.

Energy: dynamic energy in the simulator is work-conserving (each
completed run contributes exactly ``demand * t_kernel`` busy-utilization
seconds regardless of slice size), so ``E >= p_idle * T_opt +
sum_j demand_j * t_kernel_j * (p_peak - p_idle)`` — see
:func:`energy_lower_bound_j`.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any, Hashable, Iterable, Mapping, Sequence

from repro_torch.core.partition_state import PartitionBackend, PartitionProfile

_US = 1_000_000   # integer microseconds per simulated second

#: default memo-size cap; well past the homogeneous fig4 mixes' reachable
#: node counts, well short of pathological heterogeneous blowups
DEFAULT_NODE_BUDGET = 400_000


class OracleBudgetExceeded(RuntimeError):
    """The DP's reachable node space outgrew ``node_budget`` — the caller
    should fall back to the admissible closed-form bound."""


# ---------------------------------------------------------------------------
# job classes


@dataclasses.dataclass(frozen=True)
class OracleClass:
    """One equivalence class of jobs (identical relaxed-duration spec)."""

    key: tuple
    names: tuple[str, ...]      # member job names (reporting)
    count: int
    peak_gb: float              # true peak physical memory
    t_fixed: float
    t_kernel_s: float           # full-demand kernel seconds
    t_io_s: float
    demand: float               # compute fraction the kernel can use

    def duration_us(self, profile: PartitionProfile) -> int:
        """Relaxed duration on ``profile``, floored to integer µs."""
        c = max(min(profile.compute_fraction, 1.0), 1e-6)
        stretch = max(1.0, self.demand / c)
        d = self.t_fixed + self.t_kernel_s * stretch + self.t_io_s
        return int(d * _US)

    def fits(self, profile: PartitionProfile) -> bool:
        return profile.mem_gb >= self.peak_gb - 1e-9


def _class_spec(job) -> tuple[float, float, float, float, float]:
    """(peak_gb, t_fixed, t_kernel_s, t_io_s, demand) of a scheduler Job —
    dynamic jobs collapse to their trajectory's iteration total and true
    physical peak (the clairvoyant relaxation)."""
    traj = getattr(job, "trajectory", None)
    if traj is not None:
        return (traj.peak_phys / 1024 ** 3, job.t_fixed,
                traj.n_iters * traj.t_per_iter, 0.0, job.compute_demand)
    return (job.mem_gb, job.t_fixed, job.t_kernel, job.t_io,
            job.compute_demand)


def classes_from_jobs(jobs: Iterable) -> list[OracleClass]:
    """Collapse scheduler Jobs into :class:`OracleClass` groups."""
    groups: dict[tuple, list[str]] = {}
    for job in jobs:
        groups.setdefault(_class_spec(job), []).append(job.name)
    return [OracleClass(key=spec, names=tuple(names), count=len(names),
                        peak_gb=spec[0], t_fixed=spec[1],
                        t_kernel_s=spec[2], t_io_s=spec[3], demand=spec[4])
            for spec, names in sorted(groups.items())]


def classes_from_specs(specs: Iterable[Mapping[str, Any]]
                       ) -> list[OracleClass]:
    """Same, from a trace's ``{"type": "job", ...}`` records (the shape
    :meth:`repro_torch.core.scheduler.kernel.EventKernel._trace_job` emits)."""
    groups: dict[tuple, list[str]] = {}
    for rec in specs:
        spec = (float(rec["mem_gb"]), float(rec["t_fixed"]),
                float(rec["t_kernel_s"]), float(rec["t_io_s"]),
                float(rec["compute_demand"]))
        groups.setdefault(spec, []).append(rec["name"])
    return [OracleClass(key=spec, names=tuple(names), count=len(names),
                        peak_gb=spec[0], t_fixed=spec[1],
                        t_kernel_s=spec[2], t_io_s=spec[3], demand=spec[4])
            for spec, names in sorted(groups.items())]


# ---------------------------------------------------------------------------
# admissible closed-form bounds


def admissible_lower_bound_s(backend: PartitionBackend,
                             classes: Sequence[OracleClass],
                             n_devices: int = 1) -> float:
    """Closed-form lower bound on the relaxed optimum: the largest of two
    per-resource work-area bounds and the critical-path bound.

    A resource (compute fraction, or memory share) has capacity 1.0 per
    second, and concurrent slices can be binding on *different* resources
    — so the only admissible area form bounds each resource separately,
    letting every job pick its cheapest profile per resource
    independently (a further relaxation):
    ``T >= max_r sum_j min_p d(j, p) * share_r(p)``.  The critical-path
    term adds that some job must run start to finish on its fastest
    feasible slice.  All three relax the DP, so ``bound <= T_opt``.

    ``n_devices > 1`` divides the area terms by the fleet size (the
    critical path is per-job and does not divide) — the fleet-router
    arms' lower bound, with every device assumed identical to
    ``backend``."""
    total_mem = backend.total_mem_gb()
    area_compute_us = 0.0
    area_mem_us = 0.0
    longest_us = 0.0
    for cls in classes:
        best_c = math.inf
        best_m = math.inf
        best_d = math.inf
        for profile in backend.profiles:
            if not cls.fits(profile):
                continue
            d = cls.duration_us(profile)
            best_d = min(best_d, d)
            best_c = min(best_c, d * profile.compute_fraction)
            best_m = min(best_m, d * profile.mem_gb / total_mem)
        if not math.isfinite(best_d):
            raise ValueError(
                f"jobs {cls.names[:3]} (peak {cls.peak_gb:.1f}GB) fit no "
                f"profile of {type(backend).__name__}")
        area_compute_us += cls.count * best_c
        area_mem_us += cls.count * best_m
        longest_us = max(longest_us, best_d)
    return max(area_compute_us / n_devices, area_mem_us / n_devices,
               longest_us) / _US


def energy_lower_bound_j(power, classes: Sequence[OracleClass],
                         makespan_s: float) -> float:
    """Admissible Joules bound: the idle floor over the makespan bound
    plus the work-conserving dynamic energy.  A run's dynamic charge is
    ``busy_util * kernel_seconds * (p_peak - p_idle)`` and
    ``busy_util * kernel_seconds == demand * t_kernel`` on every slice
    size, so completed work costs the same dynamic Joules under any
    policy; policies only differ by the idle floor x makespan (and by
    wasted restart runs, which only add)."""
    span_w = power.p_peak_w - power.p_idle_w
    dyn = sum(cls.count * cls.demand * cls.t_kernel_s * span_w
              for cls in classes)
    return power.p_idle_w * makespan_s + dyn


# ---------------------------------------------------------------------------
# the exact DP


@dataclasses.dataclass
class OracleResult:
    """Outcome of one batch-oracle solve."""

    makespan_s: float        # the valid lower bound (exact when exact=True)
    exact: bool              # memo drained within budget -> provably optimal
    bound_s: float           # closed-form admissible bound (<= makespan_s)
    nodes: int               # memoized DP nodes (the enumerated space)
    n_jobs: int
    n_classes: int


class BatchOracle:
    """Memoized value iteration over (state, pending-counts, running).

    ``value(node)`` is the minimum remaining µs to drain the node; the
    memo doubles as the continuation-query cache for per-decision regret
    attribution (every audit replay shares it)."""

    def __init__(self, backend: PartitionBackend,
                 classes: Sequence[OracleClass], *,
                 node_budget: int = DEFAULT_NODE_BUDGET) -> None:
        self.backend = backend
        self.classes = list(classes)
        self.node_budget = node_budget
        self._memo: dict[tuple, tuple[int, tuple | None]] = {}
        self._profiles = {p.name: p for p in backend.profiles}
        #: per class: {profile_name: duration_us}, feasible profiles only
        self.durations: list[dict[str, int]] = []
        for cls in self.classes:
            feas = {p.name: cls.duration_us(p)
                    for p in backend.profiles if cls.fits(p)}
            if not feas:
                raise ValueError(
                    f"jobs {cls.names[:3]} (peak {cls.peak_gb:.1f}GB) fit "
                    f"no profile of {type(backend).__name__}")
            self.durations.append(feas)
        self._graph = None
        if getattr(backend, "supports_compiled_graph", False):
            from repro_torch.core.planner.graph import compile_transition_graph
            self._graph = compile_transition_graph(backend)

    # -- node construction -------------------------------------------------

    def initial_node(self) -> tuple:
        return (self.backend.initial_state(),
                tuple(cls.count for cls in self.classes), ())

    def make_node(self, state: Hashable, pending: Sequence[int],
                  running: Iterable[tuple[int, int, Hashable]]) -> tuple:
        """Normalize an externally-reconstructed decision point into a DP
        node (running entries: ``(remaining_us, class_idx, handle)``)."""
        return (state, tuple(pending), tuple(sorted(running)))

    def class_index_of(self, job_name: str) -> int | None:
        for i, cls in enumerate(self.classes):
            if job_name in cls.names:
                return i
        return None

    # -- transitions -------------------------------------------------------

    def _placements(self, state: Hashable, profile: PartitionProfile):
        if self._graph is not None:
            return self._graph.placements(state, profile)
        return self.backend.enumerate_placements(state, profile)

    def start_child(self, node: tuple, class_idx: int,
                    placement) -> tuple:
        state, pending, running = node
        d = self.durations[class_idx][placement.profile.name]
        new_pending = list(pending)
        new_pending[class_idx] -= 1
        assert new_pending[class_idx] >= 0
        entry = (d, class_idx, placement.handle)
        return (placement.next_state, tuple(new_pending),
                tuple(sorted(running + (entry,))))

    def advance_child(self, node: tuple) -> tuple[int, tuple]:
        """Jump to the earliest completion: ``(dt_us, successor node)``.
        Every slice finishing at that instant is freed."""
        state, pending, running = node
        dt = running[0][0]
        keep = []
        for rem, ci, handle in running:
            if rem == dt:
                state = self.backend.free(state, handle)
            else:
                keep.append((rem - dt, ci, handle))
        return dt, (state, pending, tuple(keep))

    # -- the DP ------------------------------------------------------------

    def value(self, node: tuple) -> int:
        """Minimum remaining µs from ``node`` (memoized exact DP)."""
        hit = self._memo.get(node)
        if hit is not None:
            return hit[0]
        if len(self._memo) >= self.node_budget:
            raise OracleBudgetExceeded(
                f"regret oracle: > {self.node_budget} reachable DP nodes; "
                f"falling back to the admissible closed-form bound")
        state, pending, running = node
        if not running and not any(pending):
            self._memo[node] = (0, None)
            return 0
        best = -1
        best_action: tuple | None = None
        for ci, n_pending in enumerate(pending):
            if not n_pending:
                continue
            for pname in self.durations[ci]:
                seen_states = set()
                for pl in self._placements(state, self._profiles[pname]):
                    ns = pl.next_state
                    if ns in seen_states:
                        continue   # same successor, same value
                    seen_states.add(ns)
                    v = self.value(self.start_child(node, ci, pl))
                    if best < 0 or v < best:
                        best = v
                        best_action = ("start", ci, pname, pl.handle)
        if running:
            dt, child = self.advance_child(node)
            v = dt + self.value(child)
            if best < 0 or v < best:
                best = v
                best_action = ("advance", dt)
        if best < 0:
            raise RuntimeError(
                f"stuck oracle node: pending {pending} with no feasible "
                f"placement and nothing running (state {state!r})")
        self._memo[node] = (best, best_action)
        return best

    def best_action(self, node: tuple) -> tuple | None:
        self.value(node)
        return self._memo[node][1]

    def describe_action(self, action: tuple | None) -> str:
        if action is None:
            return "done"
        if action[0] == "advance":
            return f"wait {action[1] / _US:.3f}s for a completion"
        _, ci, pname, handle = action
        example = self.classes[ci].names[0].split(":")[0]
        return f"start {example} on {pname}@{handle!r}"

    def solve(self) -> OracleResult:
        """Exact optimum when the reachable space drains within budget,
        else the closed-form admissible bound (still valid, not tight)."""
        bound_s = admissible_lower_bound_s(self.backend, self.classes)
        n_jobs = sum(cls.count for cls in self.classes)
        depth_cap = max(10_000, sys.getrecursionlimit())
        old_limit = sys.getrecursionlimit()
        sys.setrecursionlimit(depth_cap)
        try:
            opt_us = self.value(self.initial_node())
            makespan = opt_us / _US
            assert makespan >= bound_s - 1e-9, \
                f"DP optimum {makespan} below admissible bound {bound_s}"
            return OracleResult(makespan_s=makespan, exact=True,
                                bound_s=bound_s, nodes=len(self._memo),
                                n_jobs=n_jobs,
                                n_classes=len(self.classes))
        except OracleBudgetExceeded:
            return OracleResult(makespan_s=bound_s, exact=False,
                                bound_s=bound_s, nodes=len(self._memo),
                                n_jobs=n_jobs,
                                n_classes=len(self.classes))
        finally:
            sys.setrecursionlimit(old_limit)


def solve_batch_oracle(backend: PartitionBackend, jobs: Iterable, *,
                       node_budget: int = DEFAULT_NODE_BUDGET
                       ) -> OracleResult:
    """One-call batch oracle over scheduler Jobs."""
    return BatchOracle(backend, classes_from_jobs(jobs),
                       node_budget=node_budget).solve()


# ---------------------------------------------------------------------------
# per-decision regret attribution (audit replay)


@dataclasses.dataclass
class DecisionRegret:
    """One audited plan search graded against the oracle's continuation."""

    t: float
    device: str
    audited: str             # the recorded action description
    optimal: str             # the oracle's best action at the same node
    regret_s: float | None   # Q(audited) - V(node); None when ungradeable
    deciding_tier_label: str | None

    @property
    def diverged(self) -> bool:
        return self.regret_s is not None and self.regret_s > 1e-9


def attribute_decisions(oracle: BatchOracle, decisions: Sequence,
                        limit: int | None = None) -> list[DecisionRegret]:
    """Grade replayed decision points (see
    :func:`repro_torch.obs.replay.decision_points`) against the oracle.

    Each decision point is rebuilt as a DP node under the oracle's own
    relaxations — idle slices freed, doomed runs (slices too small for the
    job's true peak) returned to pending, remaining work clipped to the
    relaxed durations — so ``Q(audited) - V(node) >= 0`` holds by
    construction: the audited action is one of the node's actions."""
    out: list[DecisionRegret] = []
    for dp in decisions[:limit] if limit else decisions:
        rec = dp.record
        label = rec.get("deciding_tier_label")
        audited = rec.get("action", "?")
        node = _decision_node(oracle, dp)
        if node is None:
            out.append(DecisionRegret(dp.t, dp.device, audited,
                                      "(not replayable)", None, label))
            continue
        try:
            v = oracle.value(node)
            optimal = oracle.describe_action(oracle.best_action(node))
            q = _audited_value(oracle, node, dp)
        except OracleBudgetExceeded:
            out.append(DecisionRegret(dp.t, dp.device, audited,
                                      "(budget exceeded)", None, label))
            continue
        regret = (q - v) / _US if q is not None else None
        out.append(DecisionRegret(dp.t, dp.device, audited, optimal,
                                  regret, label))
    return out


def _decision_node(oracle: BatchOracle, dp) -> tuple | None:
    """Rebuild a replayed decision point as an oracle node, or None when
    the trace's state encoding is not replayable (repr-fallback states)."""
    state = dp.state
    if not isinstance(state, frozenset):
        return None
    backend = oracle.backend
    t_us = int(dp.t * _US)
    pending = [0] * len(oracle.classes)
    for name in dp.pending:
        ci = oracle.class_index_of(name)
        if ci is None:
            return None
        pending[ci] += 1
    running = []
    live_state = state
    # free every handle the open runs do not hold (idle slices and the
    # slices of doomed runs — both a pure relaxation, see module docstring)
    held = set()
    for run in dp.running:
        ci = oracle.class_index_of(run.job)
        if ci is None:
            return None
        d_us = oracle.durations[ci].get(run.profile)
        if d_us is None:
            # doomed run (slice below the true peak): free the slice and
            # put the job back on the pending queue
            pending[ci] += 1
            continue
        elapsed = max(0, t_us - int(run.t0 * _US))
        running.append((max(0, d_us - elapsed), ci, run.handle))
        held.add(run.handle)
    for handle in state:
        if handle not in held:
            live_state = backend.free(live_state, handle)
    return oracle.make_node(live_state, pending, running)


def _audited_value(oracle: BatchOracle, node: tuple, dp) -> int | None:
    """Q of the audited action at the reconstructed node, in µs."""
    rec = dp.record
    chosen = rec.get("chosen")
    cand = (rec["candidates"][chosen] if chosen is not None else None)
    if cand is None or cand.get("kind") == "wait":
        _state, _pending, running = node
        if not running:
            return None   # waiting with nothing running: ungradeable stall
        dt, child = oracle.advance_child(node)
        return dt + oracle.value(child)
    pname = cand.get("profile")
    handle = dp.chosen_handle
    job = dp.started_job or (dp.pending[0] if dp.pending else None)
    ci = oracle.class_index_of(job) if job is not None else None
    if ci is None or pname not in oracle.durations[ci]:
        return None
    state = node[0]
    for pl in oracle._placements(state, oracle._profiles[pname]):
        if pl.handle == handle:
            return oracle.value(oracle.start_child(node, ci, pl))
    return None


# ---------------------------------------------------------------------------
# serving grow/wait sequence: the bounded/beam relaxation


@dataclasses.dataclass
class GrowWaitBound:
    """Beam-DP lower bound on a serving engine-growth audit sequence."""

    audited_cost: float      # sum of the chosen candidates' trade tiers
    bound: float             # beam-DP lower bound (0 <= bound <= audited)
    n_decisions: int
    beam_width: int

    @property
    def regret(self) -> float:
        return self.audited_cost - self.bound


def grow_wait_sequence_bound(audits: Sequence[Mapping[str, Any]],
                             beam_width: int = 8) -> GrowWaitBound | None:
    """Bounded relaxation for the serving grow/wait sequence.

    The exact serving optimum would need the full request-arrival process;
    what the trace *does* carry is, per decision, every candidate's
    top-tier trade value (penalty-priced p99-miss probability + the
    reconfiguration it buys, ``serving_grow_cost``).  This DP walks the
    audit sequence keeping a beam of hypothetical engine profiles: where
    the trace audited the hypothetical profile (the record's ``release``
    matches), the step pays the cheapest candidate's trade tier; where it
    did not, the step optimistically pays zero (the relaxation — costs for
    counterfactual states were never measured).  Both choices only lower
    the total, and every per-step cost is >= 0, so ``0 <= bound <=
    audited_cost`` and the sequence regret is a valid (not tight) gap.
    Returns None when the trace has no grow-model audits."""
    seq = [a for a in audits if a.get("model") == "serving_grow"]
    if not seq:
        return None
    audited = 0.0
    for a in seq:
        chosen = a.get("chosen")
        if chosen is not None:
            audited += float(a["candidates"][chosen]["cost"][0])
    # beam over hypothetical current profiles; None = unknown/initial
    beam: dict[Any, float] = {seq[0].get("release"): 0.0}
    for a in seq:
        release = a.get("release")
        nxt: dict[Any, float] = {}
        for prof, cost in beam.items():
            if prof == release:
                for cand in a["candidates"]:
                    step = max(0.0, float(cand["cost"][0]))
                    to = (prof if cand.get("kind") == "wait"
                          else cand.get("profile", prof))
                    new = cost + step
                    if to not in nxt or new < nxt[to]:
                        nxt[to] = new
            else:
                # counterfactual profile: no audited candidates -> free step
                if prof not in nxt or cost < nxt[prof]:
                    nxt[prof] = cost
        beam = dict(sorted(nxt.items(), key=lambda kv: kv[1])[:beam_width])
    bound = min(beam.values())
    return GrowWaitBound(audited_cost=audited, bound=min(bound, audited),
                         n_decisions=len(seq), beam_width=beam_width)
