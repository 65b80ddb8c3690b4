"""Unified partition planner (paper §4.2-4.3 as one decision procedure),
the port's copy of ``repro.core.planner``.

* :mod:`~repro_torch.core.planner.graph` — the compiled FSM transition
  graph (state ids, cached placements, precomputed argmax-|F_s|) that turns
  the hot allocate path into O(1) lookups,
* :mod:`~repro_torch.core.planner.actions` — the typed candidate actions
  (ReuseIdle / FreshAllocate / ReshapeFuseFission / Grow / Shrink /
  Migrate / Wait),
* :mod:`~repro_torch.core.planner.cost` — the one cost model; policies
  register lexicographic weights instead of hand-rolled ladders,
* :mod:`~repro_torch.core.planner.ladders` — the shared candidate-profile
  ladders (placement, growth, shrink, restart rungs),
* :mod:`~repro_torch.core.planner.lookahead` — k-step plan-ahead carving
  over the compiled graph (bounded beam, never worse than greedy),
* :mod:`~repro_torch.core.planner.planner` — ``PartitionPlanner.plan/
  execute`` returning an explainable :class:`Plan`,
* :mod:`~repro_torch.core.planner.oracle` — the offline regret oracle: an
  exact DP optimum over the compiled graph, admissible closed-form
  bounds, and per-decision regret attribution for replayed audits.
"""

from repro_torch.core.planner.actions import (Action, FreshAllocate, Grow,
                                              Migrate, ReshapeFuseFission,
                                              ReuseIdle, Shrink, Wait)
from repro_torch.core.planner.cost import (BEST_FIT_DEVICE_COST, CostModel,
                                           CostTerms,
                                           ENERGY_AWARE_DEVICE_COST,
                                           FOLLOW_THE_SUN_ZONE_COST,
                                           PRICE_GREEDY_ZONE_COST,
                                           SCHEME_B_COST, SERVING_GROW_COST,
                                           SERVING_SHRINK_COST,
                                           SHRINK_HORIZON_S, SHRINK_TRADE_W,
                                           SLO_MISS_PENALTY_S,
                                           normalized_reachability,
                                           serving_grow_cost,
                                           serving_shrink_cost)
from repro_torch.core.planner.graph import (TransitionGraph,
                                            compile_transition_graph)
from repro_torch.core.planner.ladders import (grow_ladder, grow_request,
                                              place_request, placement_ladder,
                                              predicted_rung, restart_rung,
                                              shrink_ladder, shrink_request,
                                              tight_profile)
from repro_torch.core.planner.lookahead import (DEFAULT_BEAM_WIDTH,
                                                carve_homogeneous, plan_carve)
from repro_torch.core.planner.oracle import (BatchOracle, DecisionRegret,
                                              GrowWaitBound, OracleClass,
                                              OracleResult,
                                              admissible_lower_bound_s,
                                              attribute_decisions,
                                              classes_from_jobs,
                                              classes_from_specs,
                                              energy_lower_bound_j,
                                              grow_wait_sequence_bound,
                                              solve_batch_oracle)
from repro_torch.core.planner.planner import (Candidate, PartitionPlanner,
                                              Plan, PlanRequest, PlanResult)

__all__ = [
    "Action", "BEST_FIT_DEVICE_COST", "BatchOracle", "Candidate",
    "CostModel", "CostTerms",
    "DEFAULT_BEAM_WIDTH", "DecisionRegret", "ENERGY_AWARE_DEVICE_COST",
    "FOLLOW_THE_SUN_ZONE_COST", "FreshAllocate",
    "Grow", "GrowWaitBound", "Migrate", "OracleClass", "OracleResult",
    "PRICE_GREEDY_ZONE_COST",
    "PartitionPlanner", "Plan", "PlanRequest", "PlanResult",
    "ReshapeFuseFission", "ReuseIdle", "SCHEME_B_COST", "SERVING_GROW_COST",
    "SERVING_SHRINK_COST", "SHRINK_HORIZON_S", "SHRINK_TRADE_W",
    "SLO_MISS_PENALTY_S", "Shrink", "TransitionGraph", "Wait",
    "admissible_lower_bound_s", "attribute_decisions", "carve_homogeneous",
    "classes_from_jobs", "classes_from_specs", "compile_transition_graph",
    "energy_lower_bound_j", "grow_ladder",
    "grow_request", "grow_wait_sequence_bound", "normalized_reachability",
    "place_request",
    "placement_ladder", "plan_carve", "predicted_rung", "restart_rung",
    "serving_grow_cost", "serving_shrink_cost", "shrink_ladder",
    "shrink_request", "solve_batch_oracle", "tight_profile",
]
