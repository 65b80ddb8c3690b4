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
  execute`` returning an explainable :class:`Plan`.

The reference's offline regret oracle (``planner/oracle.py``) comes with
the scheduler it replays.
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
from repro_torch.core.planner.planner import (Candidate, PartitionPlanner,
                                              Plan, PlanRequest, PlanResult)

__all__ = [
    "Action", "BEST_FIT_DEVICE_COST", "Candidate", "CostModel", "CostTerms",
    "DEFAULT_BEAM_WIDTH", "ENERGY_AWARE_DEVICE_COST",
    "FOLLOW_THE_SUN_ZONE_COST", "FreshAllocate", "Grow", "Migrate",
    "PRICE_GREEDY_ZONE_COST", "PartitionPlanner", "Plan", "PlanRequest",
    "PlanResult", "ReshapeFuseFission", "ReuseIdle", "SCHEME_B_COST",
    "SERVING_GROW_COST", "SERVING_SHRINK_COST", "SHRINK_HORIZON_S",
    "SHRINK_TRADE_W", "SLO_MISS_PENALTY_S", "Shrink", "TransitionGraph",
    "Wait", "carve_homogeneous", "compile_transition_graph", "grow_ladder",
    "grow_request", "normalized_reachability", "place_request",
    "placement_ladder", "plan_carve", "predicted_rung", "restart_rung",
    "serving_grow_cost", "serving_shrink_cost", "shrink_ladder",
    "shrink_request", "tight_profile",
]
