"""The planner's single cost model (the port's copy of
``repro.core.planner.cost``; every named model and constant is the
reference's).

Every placement decision in this repo — scheme B's placement ladder, the
serving engines' grow/migrate targets, the fleet routers' device ranking —
is a preference over the same handful of physical quantities: how many
seconds of reconfiguration an action costs, how well the slice fits the
memory/compute need, how much of the device's future configuration space
(|F_s|, Algorithm 2) survives, and what idle power the choice keeps
burning.  A policy is a *weighting* of those terms, not its own ladder.

Costs compare lexicographically: ``CostModel.weights`` lists
``(feature, weight)`` pairs in priority order and ``cost()`` returns the
weighted tuple.  Python's tuple ordering then reproduces tiered
preferences exactly (a strictly cheaper high-priority term always wins;
equal terms fall through to the next), which is what lets one shared
scoring function reproduce each policy's tiered ladder bit-for-bit.
Negative weights express "larger is better" (reachability).

A tier may also be a *group* — a tuple of ``(feature, weight)`` pairs
summed into one scalar — for decisions that genuinely trade quantities
off against each other rather than rank them: the serving grow model's
top tier weighs the expected seconds a predicted p99 SLO miss costs
against the reconfiguration seconds a growth would pay, so an engine
reconfigures exactly when the forecast miss is the more expensive of the
two (MISO's predicted-pressure reconfiguration, arXiv:2207.11428).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Hashable

from repro_torch.core import reachability


@dataclasses.dataclass(frozen=True)
class CostTerms:
    """The measurable features of one candidate action (or device)."""

    reconfig_s: float = 0.0      # reconfiguration seconds paid right now
    ladder_rank: float = 0.0     # position in the request's profile ladder
    disturbance: float = 0.0     # idle partitions consumed by fusion/fission
    reach: float = 0.0           # |F_s| of the resulting FSM state
    reach_norm: float = 0.0      # log-normalized |F_s| (cross-device scale)
    mem_waste_gb: float = 0.0    # profile memory beyond the stated need
    compute_deficit: float = 0.0 # unmet fraction of the compute demand
    wake_s: float = 0.0          # wake latency if the device is power-gated
    idle_power_w: float = 0.0    # idle draw of the hosting device
    load: float = 0.0            # device load fraction (consolidation)
    free_after_gb: float = 0.0   # device memory left free after the action
    energy_price: float = 0.0    # tariff-weighted idle draw, $/s at the zone
    data_movement_s: float = 0.0 # cross-zone checkpoint/input transfer secs
    #: requests waiting per batch slot — recorded on every serving grow
    #: candidate for plan explainability and the learned-weights feature
    #: vocabulary (ROADMAP); no built-in model weighs it: within one plan
    #: it is request-constant, so only a cross-plan (learned) weighting
    #: could discriminate on it
    queue_depth: float = 0.0
    slo_violation_prob: float = 0.0  # predicted p99 TTFT/TPOT miss prob.
    reach_delta: float = 0.0     # |F_s| change the action causes (graph)
    #: dynamic watts the action stops burning (Shrink candidates: the
    #: power-model span times the compute fraction surrendered); credited
    #: over the shrink horizon by ``serving_shrink_cost``
    power_saved_w: float = 0.0


def _tier_value(tier, terms: CostTerms) -> float:
    """One lexicographic tier: ``(feature, weight)``, or a group — a tuple
    of such pairs summed into one scalar (a true trade-off)."""
    if isinstance(tier[0], str):
        f, w = tier
        return w * getattr(terms, f)
    return sum(w * getattr(terms, f) for f, w in tier)


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Prioritized weighted terms; policies differ only in ``weights``."""

    name: str
    weights: tuple

    def cost(self, terms: CostTerms) -> tuple[float, ...]:
        values = tuple(_tier_value(t, terms) for t in self.weights)
        for v in values:
            if not math.isfinite(v):
                raise ValueError(self._non_finite_message(terms))
        return values

    def _non_finite_message(self, terms: CostTerms) -> str:
        """Name the offending feature(s): a NaN anywhere in a cost tuple
        makes lexicographic comparison order-dependent (NaN compares false
        both ways), so the tuple must never be built."""
        bad = [f"{f.name}={getattr(terms, f.name)!r}"
               for f in dataclasses.fields(terms)
               if not math.isfinite(getattr(terms, f.name))]
        detail = ", ".join(bad) if bad else "a non-finite tier weight"
        return (f"non-finite cost feature for model {self.name!r}: {detail} "
                f"— lexicographic candidate comparison would be "
                f"order-dependent")

    def explain(self, terms: CostTerms) -> str:
        def label(tier) -> str:
            if isinstance(tier[0], str):
                return f"{tier[0]}={_tier_value(tier, terms):g}"
            inner = "+".join(f for f, _ in tier)
            return f"({inner})={_tier_value(tier, terms):g}"
        return " ".join(label(t) for t in self.weights)


#: Scheme B's placement preference (paper Alg. 5 + §4.3): avoid paying a
#: reconfiguration (reuse a tight idle slice), then follow the profile
#: ladder (compute-satisfying tight fit before memory-only tight fit), then
#: disturb as few idle partitions as possible (fresh carve before
#: fusion/fission), then keep |F_s| maximal (Alg. 3's argmax).
SCHEME_B_COST = CostModel("scheme_b", (
    ("reconfig_s", 1.0),
    ("ladder_rank", 1.0),
    ("disturbance", 1.0),
    ("reach", -1.0),
))

#: Seconds-equivalent price of a predicted p99 SLO miss — the exchange
#: rate the serving grow model's top tier converts a violation
#: probability into, so it lands in the same unit as ``reconfig_s``.
#: Far above any single MIG reconfiguration (~0.3s): a *certain* miss
#: always buys a reconfiguration, a near-zero risk never does, and the
#: crossover sits at ``reconfig_s / SLO_MISS_PENALTY_S`` miss probability.
SLO_MISS_PENALTY_S = 60.0


def serving_grow_cost(miss_penalty_s: float = SLO_MISS_PENALTY_S) -> CostModel:
    """Serving-engine growth (paper §4.3 lifted to request level, MISO's
    predicted-pressure trigger): the top tier *trades* the expected
    seconds a predicted p99 TTFT/TPOT miss costs against the
    reconfiguration seconds the growth pays — a ``Wait``/stay candidate
    carries the uncured violation probability at zero reconfiguration,
    each grow rung carries its relief-scaled residual probability plus
    the reconfiguration.  Ties (no pressure, or equal cure) fall through
    to the grow ladder, the least disruptive mechanism, then the
    graph-computed reachability delta (keep |F_s| maximal)."""
    return CostModel("serving_grow", (
        (("slo_violation_prob", miss_penalty_s), ("reconfig_s", 1.0)),
        ("ladder_rank", 1.0),
        ("disturbance", 1.0),
        ("reach_delta", -1.0),
    ))


SERVING_GROW_COST = serving_grow_cost()

#: Horizon (seconds) a shrink's power saving is credited over — the
#: window the headroom forecast claims will stay quiet.  MISO's EWMA
#: decay and the admission controller's forecast both look ~30-60s out;
#: crediting longer would let a single calm minute buy reconfigurations
#: the next burst immediately undoes.
SHRINK_HORIZON_S = 60.0

#: Joules-saved that justify one second of the shrink trade — the
#: exchange rate converting ``power_saved_w * SHRINK_HORIZON_S`` into the
#: same unit as ``reconfig_s`` and the risk penalty.  Sized at the
#: dynamic draw of a mid A100 slice (~150W): a shrink that saves a full
#: slice's wattage over the horizon buys tens of trade-seconds, while a
#: marginal 1/7-compute saving barely covers the rebuild.
SHRINK_TRADE_W = 150.0


def serving_shrink_cost(horizon_s: float = SHRINK_HORIZON_S,
                        trade_w: float = SHRINK_TRADE_W,
                        miss_penalty_s: float = SLO_MISS_PENALTY_S
                        ) -> CostModel:
    """Serving-engine scale-down — :class:`Grow`'s symmetric trade.  The
    top tier weighs the Joules a smaller slice stops burning over the
    forecast-quiet horizon (``power_saved_w * horizon_s``, converted to
    trade-seconds at ``trade_w``) against the reconfiguration + KV
    rebuild the shrink pays now plus the penalty-priced probability the
    headroom forecast is wrong (the engine regrows and pays it all
    again).  The stay candidate carries zero on every term, so an engine
    shrinks exactly when the forecast savings outweigh the risked
    rebuild.  Ties fall through to the shrink ladder (deepest rung
    first), disturbance, and the reachability delta — freeing span is
    the whole point, so |F_s| gains break the final ties."""
    return CostModel("serving_shrink", (
        (("slo_violation_prob", miss_penalty_s), ("reconfig_s", 1.0),
         ("power_saved_w", -horizon_s / trade_w)),
        ("ladder_rank", 1.0),
        ("disturbance", 1.0),
        ("reach_delta", -1.0),
    ))


SERVING_SHRINK_COST = serving_shrink_cost()

#: Fleet device ranking, best-fit flavour: never wake a gated device if an
#: awake one fits, waste the least slice memory, fill the fullest device,
#: and keep the fleet's future configuration space largest.
BEST_FIT_DEVICE_COST = CostModel("best_fit", (
    ("wake_s", 1.0),
    ("mem_waste_gb", 1.0),
    ("free_after_gb", 1.0),
    ("reach_norm", -1.0),
))

#: Fleet device ranking, consolidation flavour: pack the busiest awake
#: device (first-fit-decreasing in spirit), keep the cheapest idle floor
#: awake, and wake the cheapest gated device only as a last resort.
ENERGY_AWARE_DEVICE_COST = CostModel("energy_aware", (
    ("wake_s", 1.0),
    ("load", -1.0),
    ("idle_power_w", 1.0),
))

#: Cluster zone ranking, price-greedy flavour: chase the *instantaneous*
#: tariff (cheapest $/s of idle draw right now), then move the least data
#: across zones, then pack the busiest zone.  Deliberately myopic — near a
#: tariff crossover it ships work into a zone about to turn expensive,
#: which is exactly the failure mode follow-the-sun's forecast avoids.
PRICE_GREEDY_ZONE_COST = CostModel("price_greedy_zone", (
    ("energy_price", 1.0),
    ("data_movement_s", 1.0),
    ("load", -1.0),
))

#: Cluster zone ranking, follow-the-sun flavour: same weights, but the
#: ``energy_price`` feature is the tariff's *mean over the job's predicted
#: run window* (shifted by the cross-zone transfer it would pay), so work
#: flows to the zone whose night covers the job, not the zone that merely
#: looks cheap this second (arXiv:2501.17752 lifted to routing).
FOLLOW_THE_SUN_ZONE_COST = CostModel("follow_the_sun_zone", (
    ("energy_price", 1.0),
    ("data_movement_s", 1.0),
    ("load", -1.0),
))


#: key -> (pinned backend, log1p(reach of the empty device)).  The
#: normalizer is a per-backend constant, but computing it walks the
#: reachability cache-key path — measurable when the fleet routers score
#: hundreds of thousands of candidate devices on a backlogged trace.
_REACH0_LOG: dict[Hashable, tuple] = reachability.register_backend_cache({})


def normalized_reachability(backend, state: Hashable,
                            reach: int | None = None) -> float:
    """Current-state reachability normalized against the empty device, in
    log space so the A100's counts (up to 19) and the H100's (up to 148)
    are comparable.  1.0 = pristine, -> 0 as the FSM saturates."""
    if reach is None:
        reach = backend.reachability(state)
    key = reachability.reachability_cache_key(backend)
    hit = _REACH0_LOG.get(key)
    if hit is None:
        reach0 = backend.reachability(backend.initial_state())
        log0 = math.log1p(reach0) if reach0 > 1 else 0.0
        reachability.bounded_cache_insert(_REACH0_LOG, key, (backend, log0))
    else:
        log0 = hit[1]
    if log0 == 0.0:
        return 1.0
    return math.log1p(reach) / log0
