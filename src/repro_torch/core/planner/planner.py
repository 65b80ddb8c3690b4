"""The partition planner: one scored-candidate search over partition
actions (MISO, arXiv:2207.11428; optimal MIG placement, arXiv:2409.06646),
the port's copy of ``repro.core.planner.planner``.

``PartitionPlanner.plan`` enumerates every feasible typed action for a
:class:`PlanRequest` — reuse an idle slice, carve a fresh one at the
argmax-|F_s| placement, fuse/fission idle space, or wait — scores them
with one :class:`~repro_torch.core.planner.cost.CostModel`, and returns an
explainable :class:`Plan`.  ``execute`` commits the winning action to the
:class:`~repro_torch.core.partition_manager.PartitionManager`.

Planning never mutates the FSM: feasibility (including fusion/fission) is
evaluated on hypothetical successor states through the compiled transition
graph, so a plan that ends in :class:`~repro_torch.core.planner.actions.Wait`
is a true no-op on the device.

With a flight recorder set (``tracer``), ``plan`` files an audit record of
every search and ``execute`` an instant of every committed partition, the
reference's records.
"""

from __future__ import annotations

import dataclasses
from typing import Hashable, Mapping, Sequence

from repro_torch.core.partition_manager import Partition, PartitionManager
from repro_torch.core.partition_state import PartitionProfile
from repro_torch.core.planner.actions import (Action, FreshAllocate,
                                              Grow, ReshapeFuseFission,
                                              ReuseIdle, Shrink, Wait)
from repro_torch.core.planner.cost import CostModel, CostTerms


@dataclasses.dataclass
class PlanRequest:
    """What a policy wants from the partition FSM."""

    ladder: Sequence[PartitionProfile]  # candidate profiles, preferred first
    need_gb: float = 0.0                # stated memory need (cost feature)
    compute_demand: float = 0.0         # soft compute need (cost feature)
    reuse_idle: bool = True             # may bind to an idle partition
    allow_reshape: bool = True          # may fuse/fission idle partitions
    reconfig_cost_s: float = 0.0        # setup seconds a new carve costs
    release: Partition | None = None    # Grow: free this partition first
    # -- SLO pressure (serving growth; see cost.serving_grow_cost) --------
    queue_depth: float = 0.0            # waiting requests per batch slot
    slo_violation_prob: float = 0.0     # predicted p99 miss prob. if we stay
    #: residual violation probability fraction an action leaves: None
    #: derives it per candidate (see ``_relief``), a number applies
    #: uniformly (0.0 = any growth fully cures — the queue-tick
    #: emulation's step semantics)
    slo_relief: float | None = None
    #: compute fraction the pressure gauge forecasts as sufficient —
    #: candidates at/above it relieve fully, so the ladder's tightest
    #: sufficient rung wins instead of the biggest slice; 0 falls back to
    #: the plain compute ratio
    needed_compute: float = 0.0
    #: score staying put (a Wait carrying the uncured violation
    #: probability) as a real candidate, so growth happens exactly when
    #: the predicted miss outweighs the reconfiguration
    allow_stay: bool = False
    # -- scale-down (serving shrink; see cost.serving_shrink_cost) --------
    #: type the committed action as a :class:`Shrink` instead of a
    #: :class:`Grow` — the release-and-recarve mechanics are identical,
    #: the direction (and the cost model trading it) differs
    shrink: bool = False
    #: per-profile-name dynamic watts the candidate stops burning
    #: (``power_saved_w`` cost feature); absent names score 0 — the stay
    #: candidate always does
    power_saved_w_by: Mapping[str, float] | None = None
    #: per-profile-name forecast-wrong probability, overriding the
    #: relief-scaled ``slo_violation_prob`` (shrink risk *rises* down the
    #: ladder where growth risk falls, so the relief machinery cannot
    #: express it)
    profile_risk: Mapping[str, float] | None = None


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One feasible action with its cost-model evaluation."""

    action: Action
    terms: CostTerms
    cost: tuple[float, ...]


@dataclasses.dataclass
class Plan:
    """The full, explainable outcome of one plan search."""

    request: PlanRequest
    model: CostModel
    candidates: list[Candidate]
    chosen: Candidate | None            # None => Wait

    @property
    def action(self) -> Action:
        if self.chosen is None:
            return Wait("no feasible placement")
        act = self.chosen.action
        if isinstance(act, Wait):
            return act                  # stay put: nothing is released
        if self.request.release is not None:
            wrap = Shrink if self.request.shrink else Grow
            return wrap(self.request.release, act)
        return act

    def explain(self) -> str:
        lines = [f"plan[{self.model.name}] over "
                 f"{[p.name for p in self.request.ladder]}:"]
        for cand in self.candidates:
            mark = ">>" if cand is self.chosen else "  "
            lines.append(f"{mark} {cand.action.describe():45s} "
                         f"{self.model.explain(cand.terms)}")
        if self.chosen is None:
            lines.append(">> wait (no feasible action)")
        return "\n".join(lines)


@dataclasses.dataclass
class PlanResult:
    """What executing a plan did to the device."""

    partition: Partition | None
    setup_s: float
    action: Action


class PartitionPlanner:
    """Plan/execute partition actions against one PartitionManager."""

    #: flight recorder (repro_torch.obs.Tracer) + the device name it files
    #: records under; set by the event kernel when a run is traced, left
    #: at the class defaults (no-op) otherwise
    tracer = None
    owner = ""

    def __init__(self, pm: PartitionManager,
                 cost_model: CostModel) -> None:
        self.pm = pm
        self.model = cost_model

    # -- search ------------------------------------------------------------

    def plan(self, request: PlanRequest,
             model: CostModel | None = None) -> Plan:
        model = model or self.model
        pm = self.pm
        backend = pm.backend
        base_state: Hashable = pm.state
        release = request.release
        if release is not None:
            base_state = backend.free(base_state, release.handle)

        # ONE pass over the live table: first idle partition per profile
        # name (dict order = creation order, as before) + the idle set the
        # reshape would consume.
        idle_by_name: dict[str, Partition] = {}
        idle_parts: list[Partition] = []
        for part in pm.live.values():
            if part.busy or part is release:
                continue
            idle_parts.append(part)
            idle_by_name.setdefault(part.profile.name, part)

        # the live state's |F_s| anchors every candidate's reach_delta (the
        # graph-computed change the action causes; one lookup per state)
        live_reach = pm.reach(pm.state)
        reshape_state: Hashable | None = None  # computed at most once
        candidates: list[Candidate] = []
        for rank, profile in enumerate(request.ladder):
            waste = profile.mem_gb - request.need_gb
            deficit = max(0.0, request.compute_demand
                          - profile.compute_fraction)
            relief = self._relief(request, profile)
            if request.reuse_idle and profile.name in idle_by_name:
                idle = idle_by_name[profile.name]
                candidates.append(self._candidate(
                    model, ReuseIdle(idle), reconfig_s=0.0, rank=rank,
                    disturbance=0, state=base_state, live_reach=live_reach,
                    waste=waste, deficit=deficit, request=request,
                    relief=relief))
            placement = pm.best_placement(base_state, profile)
            if placement is not None:
                candidates.append(self._candidate(
                    model, FreshAllocate(placement),
                    reconfig_s=request.reconfig_cost_s, rank=rank,
                    disturbance=0, state=placement.next_state,
                    live_reach=live_reach, waste=waste, deficit=deficit,
                    request=request, relief=relief))
            elif request.allow_reshape and idle_parts:
                if reshape_state is None:
                    reshape_state = base_state
                    for p in idle_parts:
                        reshape_state = backend.free(reshape_state, p.handle)
                placement = pm.best_placement(reshape_state, profile)
                if placement is not None:
                    candidates.append(self._candidate(
                        model, ReshapeFuseFission(placement,
                                                  tuple(idle_parts)),
                        reconfig_s=request.reconfig_cost_s, rank=rank,
                        disturbance=len(idle_parts),
                        state=placement.next_state, live_reach=live_reach,
                        waste=waste, deficit=deficit, request=request,
                        relief=relief))
        if request.allow_stay:
            # staying put pays no reconfiguration but keeps the whole
            # predicted violation probability; ladder_rank -1 makes it win
            # ties (zero pressure must never buy a free reconfiguration)
            terms = CostTerms(ladder_rank=-1.0, reach=float(live_reach),
                              queue_depth=request.queue_depth,
                              slo_violation_prob=request.slo_violation_prob)
            candidates.append(Candidate(action=Wait("stay: pressure below "
                                                    "reconfiguration cost"),
                                        terms=terms, cost=model.cost(terms)))

        chosen = min(candidates, key=lambda c: c.cost) if candidates else None
        plan = Plan(request=request, model=model, candidates=candidates,
                    chosen=chosen)
        if self.tracer is not None:
            # imported lazily: repro_torch.obs.audit imports this module
            from repro_torch.obs.audit import plan_audit_record
            self.tracer.audit(plan_audit_record(
                plan, t=self.tracer.now(), device=self.owner,
                state=pm.state, backend=backend))
        return plan

    @staticmethod
    def _relief(request: PlanRequest, profile: PartitionProfile) -> float:
        """Residual violation-probability fraction after acquiring
        ``profile``: explicit when the request pins it; zero at/above the
        gauge's forecast ``needed_compute`` (any sufficient slice fully
        cures, so tightness decides among them), linear in the shortfall
        below it; plain compute ratio when no need was forecast."""
        if request.slo_relief is not None:
            return request.slo_relief
        if request.release is None or profile.compute_fraction <= 0.0:
            return 1.0
        current = request.release.profile.compute_fraction
        need = request.needed_compute
        if need > 0.0:
            if profile.compute_fraction >= need or need <= current:
                return 0.0
            return min(1.0, (need - profile.compute_fraction)
                       / (need - current))
        return min(1.0, current / profile.compute_fraction)

    def _candidate(self, model: CostModel, action: Action, *,
                   reconfig_s: float, rank: int, disturbance: int,
                   state: Hashable, live_reach: int, waste: float,
                   deficit: float, request: PlanRequest,
                   relief: float) -> Candidate:
        reach = float(self.pm.reach(state))
        pname = request.ladder[rank].name
        prob = request.slo_violation_prob * relief
        if request.profile_risk is not None:
            prob = request.profile_risk.get(pname, prob)
        saved_w = 0.0
        if request.power_saved_w_by is not None:
            saved_w = request.power_saved_w_by.get(pname, 0.0)
        terms = CostTerms(reconfig_s=reconfig_s, ladder_rank=float(rank),
                          disturbance=float(disturbance),
                          reach=reach, reach_delta=reach - live_reach,
                          mem_waste_gb=waste, compute_deficit=deficit,
                          queue_depth=request.queue_depth,
                          slo_violation_prob=prob,
                          power_saved_w=saved_w)
        return Candidate(action=action, terms=terms, cost=model.cost(terms))

    # -- commit ------------------------------------------------------------

    def execute(self, plan: Plan) -> PlanResult | None:
        """Commit the plan's winning action; None when there is nothing to
        do (Wait without a pending release)."""
        pm = self.pm
        request = plan.request
        if plan.chosen is None or isinstance(plan.chosen.action, Wait):
            if request.release is None:
                return None
            # failed grow — or a stay candidate that won the pressure
            # trade: the search ran on hypothetical states only, so the
            # pending release simply never happens — the live partition,
            # the FSM state and n_reconfigs are all exactly untouched
            action = (plan.chosen.action if plan.chosen is not None
                      else Wait("no feasible growth target"))
            return PlanResult(partition=request.release, setup_s=0.0,
                              action=action)

        action = plan.chosen.action
        if request.release is not None:
            pm.release(request.release)
        if isinstance(action, ReuseIdle):
            return PlanResult(partition=action.partition, setup_s=0.0,
                              action=action)
        if isinstance(action, FreshAllocate):
            part = pm.commit_placement(action.placement)
        else:
            assert isinstance(action, ReshapeFuseFission)
            for p in action.consumed:
                pm.release(p)
            part = pm.commit_placement(action.placement)
            pm.n_reconfigs += len(action.consumed)
        if self.tracer is not None:
            self.tracer.instant(
                "partition." + ("reshape" if isinstance(
                    action, ReshapeFuseFission) else "create"),
                device=self.owner, lane="planner", cat="partition",
                profile=part.profile.name, pid=part.pid,
                action=plan.action.describe())
        return PlanResult(partition=part, setup_s=request.reconfig_cost_s,
                          action=plan.action)

    def place(self, request: PlanRequest,
              model: CostModel | None = None) -> PlanResult | None:
        """plan + execute in one step (the common hot path)."""
        return self.execute(self.plan(request, model))
