"""The port's partition planner against the reference: the same PlanRequest
sequences (place, reuse, grow, shrink, fragmented fusion/fission, wait and
seeded mixes) through both planners on both MIG cards give the same
candidates, costs, chosen action, Plan.explain() text and post-execute
state; the ladders, the look-ahead carve and the cost models agree."""

import dataclasses

import numpy as np
import pytest

import repro.core.planner as R
from repro.core.mig_a100 import MigA100Backend as RefA100
from repro.core.mig_h100 import MigH100Backend as RefH100
from repro.core.partition_manager import PartitionManager as RefManager
from repro.core.partition_state import enumerate_states as ref_states
import repro_torch.core.planner as P
from repro_torch.core.mig_a100 import MigA100Backend
from repro_torch.core.mig_h100 import MigH100Backend
from repro_torch.core.partition_manager import PartitionManager

CARDS = {"a100": (MigA100Backend, RefA100), "h100": (MigH100Backend, RefH100)}
SIDES = {"port": (P, PartitionManager, 0), "ref": (R, RefManager, 1)}
MODELS = ["SCHEME_B_COST", "SERVING_GROW_COST", "SERVING_SHRINK_COST",
          "BEST_FIT_DEVICE_COST", "ENERGY_AWARE_DEVICE_COST",
          "PRICE_GREEDY_ZONE_COST", "FOLLOW_THE_SUN_ZONE_COST"]


def _action(a):
    profile = getattr(a, "profile", None)
    return (type(a).__name__, a.describe(), profile and profile.name)


def _manager(pm):
    return (pm.state, pm.n_reconfigs, pm.describe(),
            {pid: (p.profile.name, p.handle, p.busy)
             for pid, p in pm.live.items()})


class Trace:
    """One side's run of a scenario, as comparable plain values."""

    def __init__(self, pk, backend, pm):
        self.pk, self.backend, self.pm = pk, backend, pm
        self.planner = pk.PartitionPlanner(pm, pk.SCHEME_B_COST)
        self.rows = []

    def profile(self, i):
        return self.backend.profiles[i]

    def run(self, request, model=None, execute=True):
        plan = self.planner.plan(request, model)
        row = {"candidates": [(_action(c.action),
                               dataclasses.asdict(c.terms), c.cost)
                              for c in plan.candidates],
               "chosen": plan.chosen and _action(plan.chosen.action),
               "action": _action(plan.action), "explain": plan.explain(),
               "model": plan.model.name}
        if execute:
            res = self.planner.execute(plan)
            row["result"] = res and (
                res.partition and (res.partition.pid, res.partition.handle,
                                   res.partition.profile.name),
                res.setup_s, _action(res.action))
        row["manager"] = _manager(self.pm)
        self.rows.append(row)
        return plan


def _place(t, rng):
    mems = [None] + [p.mem_gb * f for p in t.backend.profiles
                     for f in (0.5, 0.9, 1.0)]
    mem = mems[int(rng.integers(len(mems)))]
    compute = float(rng.choice([0.0, 0.1, 0.3, 0.45, 0.6, 1.0]))
    t.run(t.pk.place_request(t.backend, mem, compute, reconfig_cost_s=0.3))


def scenario_place(t, rng):
    for _ in range(10):
        _place(t, rng)


def scenario_reuse(t, rng):
    idle = t.pm.allocate(t.profile(2))
    plan = t.run(t.pk.place_request(t.backend, t.profile(2).mem_gb - 1.0,
                                    t.profile(2).compute_fraction, 0.3))
    assert plan.chosen.action.partition is idle


def scenario_fragmented(t, rng):
    for _ in range(7):
        t.pm.allocate(t.profile(0))
    t.pm.live[3].busy = True
    for i in (1, 2, 3):
        t.run(t.pk.place_request(t.backend, t.profile(i).mem_gb, 0.0, 0.3))


def scenario_wait(t, rng):
    for _ in range(7):
        t.pm.allocate(t.profile(0)).busy = True
    plan = t.run(t.pk.place_request(t.backend, t.profile(-2).mem_gb, 0.0,
                                    0.3))
    assert plan.chosen is None


def scenario_grow(t, rng):
    engine = t.pm.allocate(t.profile(1))
    engine.busy = True
    for predicted in (None, t.profile(2).mem_gb - 1, t.profile(-1).mem_gb):
        plan = t.run(t.pk.grow_request(t.backend, engine, predicted, 0.5),
                     t.pk.SERVING_GROW_COST, execute=False)
        assert plan.action.released is engine
    for prob in (0.0, 0.001, 0.5, 1.0):
        t.run(t.pk.grow_request(t.backend, engine, None, 0.3,
                                reconfig_cost_s=0.3, queue_depth=2.0,
                                slo_violation_prob=prob, allow_stay=True,
                                needed_compute=0.4),
              t.pk.SERVING_GROW_COST, execute=False)
    res = t.planner.place(t.pk.grow_request(t.backend, engine, None, 0.5),
                          t.pk.SERVING_GROW_COST)
    t.rows.append(_manager(t.pm))
    assert type(res.action).__name__ == "Grow"


def scenario_grow_blocked(t, rng):
    engine = t.pm.allocate(t.profile(-2))
    engine.busy = True
    blocker = t.pm.allocate(t.profile(-3))
    if blocker is not None:
        blocker.busy = True
    t.run(t.pk.grow_request(t.backend, engine, t.profile(-1).mem_gb, 0.5),
          t.pk.SERVING_GROW_COST)


def scenario_shrink(t, rng):
    engine = t.pm.allocate(t.profile(-2))
    engine.busy = True
    names = [p.name for p in t.backend.profiles]
    saved = {n: 40.0 * (len(names) - i) for i, n in enumerate(names)}
    for risk in (0.0, 0.05, 0.9):
        t.run(t.pk.shrink_request(t.backend, engine, t.profile(0).mem_gb,
                                  saved, dict.fromkeys(names, risk), 0.3),
              t.pk.SERVING_SHRINK_COST, execute=False)
    t.run(t.pk.shrink_request(t.backend, engine, t.profile(0).mem_gb, saved,
                              {}, 0.0), t.pk.SERVING_SHRINK_COST)


def scenario_mixed(t, rng):
    for _ in range(40):
        op = int(rng.integers(6))
        live = sorted(t.pm.live)
        if op < 2 or not live:
            _place(t, rng)
            continue
        part = t.pm.live[live[int(rng.integers(len(live)))]]
        model = getattr(t.pk, MODELS[int(rng.integers(len(MODELS)))])
        if op == 2:
            t.run(t.pk.grow_request(t.backend, part,
                                    float(rng.uniform(0, 90)),
                                    float(rng.uniform(0, 1))), model)
        elif op == 3:
            t.run(t.pk.shrink_request(
                t.backend, part, float(rng.uniform(0, 20)),
                {p.name: float(rng.uniform(0, 300))
                 for p in t.backend.profiles}, {}, 0.3), model)
        elif op == 4:
            t.pm.release(part)
        else:
            part.busy = not part.busy
        t.rows.append(_manager(t.pm))


SCENARIOS = {name[len("scenario_"):]: fn for name, fn in globals().items()
             if name.startswith("scenario_")}


def _trace(side, card, scenario, seed):
    pk, manager, i = SIDES[side]
    backend = CARDS[card][i]()
    t = Trace(pk, backend, manager(backend))
    SCENARIOS[scenario](t, np.random.default_rng(seed))
    return t.rows


@pytest.mark.parametrize("card", sorted(CARDS))
@pytest.mark.parametrize("scenario,seed",
                         [(s, 0) for s in SCENARIOS if s != "mixed"]
                         + [("mixed", seed) for seed in range(4)])
def test_plan_sequences_match_reference(card, scenario, seed):
    rows = _trace("port", card, scenario, seed)
    assert rows and rows == _trace("ref", card, scenario, seed)


@pytest.mark.parametrize("card", sorted(CARDS))
def test_ladders_match_reference(card):
    port, ref = (c() for c in CARDS[card])
    names = lambda ps: [p.name for p in ps]  # noqa: E731
    mems = [None, 0.0, 1.0] + [p.mem_gb + d for p in port.profiles
                               for d in (-0.5, 0.0, 0.5)] + [1e3]
    computes = [0.0, 0.1, 0.3, 0.5, 0.9, 1.0]
    for mem in mems:
        assert P.tight_profile(port, mem).name == R.tight_profile(
            ref, mem).name
        for c in computes:
            assert names(P.placement_ladder(port, mem, c)) == names(
                R.placement_ladder(ref, mem, c))
        if mem is not None:
            got, want = (P.predicted_rung(port, mem, 1.2),
                         R.predicted_rung(ref, mem, 1.2))
            assert (got and got.name) == (want and want.name)
    for cur, rcur in zip(port.profiles, ref.profiles):
        assert P.restart_rung(port, cur).name == R.restart_rung(
            ref, cur).name
        for mem in mems:
            for c in computes:
                assert names(P.grow_ladder(port, cur, mem, c)) == names(
                    R.grow_ladder(ref, rcur, mem, c))
            assert names(P.shrink_ladder(port, cur, mem or 0.0)) == names(
                R.shrink_ladder(ref, rcur, mem or 0.0))


@pytest.mark.parametrize("card", sorted(CARDS))
@pytest.mark.parametrize("beam", [1, 2, P.DEFAULT_BEAM_WIDTH])
def test_carves_match_reference(card, beam):
    """plan_carve from every state reachable in two steps, over profile
    sets of one and two sizes; carve_homogeneous commits the same chain."""
    assert P.DEFAULT_BEAM_WIDTH == R.DEFAULT_BEAM_WIDTH
    port, ref = (c() for c in CARDS[card])
    n = len(port.profiles)
    sets = [[i] for i in range(n)] + [[i, j] for i in range(n)
                                      for j in range(n) if i != j]
    starts = [s for s in ref_states(ref) if len(s) <= 2]
    for start in starts:
        for idx in sets:
            pm, rpm = PartitionManager(port), RefManager(ref)
            pm.state = rpm.state = start
            profs = [port.profiles[i] for i in idx]
            rprofs = [ref.profiles[i] for i in idx]
            got = P.plan_carve(pm, profs, beam)
            assert [(p.handle, p.next_state) for p in got] == [
                (p.handle, p.next_state)
                for p in R.plan_carve(rpm, rprofs, beam)]
    pm, rpm = PartitionManager(port), RefManager(ref)
    parts = P.carve_homogeneous(pm, port.profiles[:2], beam)
    rparts = R.carve_homogeneous(rpm, ref.profiles[:2], beam)
    assert [(p.pid, p.handle) for p in parts] == [
        (p.pid, p.handle) for p in rparts]
    assert _manager(pm) == _manager(rpm)


@pytest.mark.parametrize("name", MODELS)
def test_cost_models_match_reference(name):
    got, want = getattr(P, name), getattr(R, name)
    assert (got.name, got.weights) == (want.name, want.weights)
    rng = np.random.default_rng(len(name))
    for _ in range(20):
        kw = {f.name: float(rng.uniform(-5, 5))
              for f in dataclasses.fields(R.CostTerms)}
        assert got.cost(P.CostTerms(**kw)) == want.cost(R.CostTerms(**kw))
        assert got.explain(P.CostTerms(**kw)) == want.explain(
            R.CostTerms(**kw))
    with pytest.raises(ValueError, match="non-finite") as e:
        got.cost(P.CostTerms(reach=float("nan"), reach_delta=float("nan"),
                             reach_norm=float("nan"), load=float("nan"),
                             wake_s=float("nan"),
                             energy_price=float("nan")))
    with pytest.raises(ValueError) as f:
        want.cost(R.CostTerms(reach=float("nan"), reach_delta=float("nan"),
                              reach_norm=float("nan"), load=float("nan"),
                              wake_s=float("nan"),
                              energy_price=float("nan")))
    assert str(e.value) == str(f.value)


def test_cost_constants_and_builders_match_reference():
    for c in ("SLO_MISS_PENALTY_S", "SHRINK_HORIZON_S", "SHRINK_TRADE_W"):
        assert getattr(P, c) == getattr(R, c)
    for args in ((), (10.0,)):
        assert P.serving_grow_cost(*args).weights == R.serving_grow_cost(
            *args).weights
    for args in ((), (30.0, 100.0, 20.0)):
        assert (P.serving_shrink_cost(*args).weights
                == R.serving_shrink_cost(*args).weights)


@pytest.mark.parametrize("card", sorted(CARDS))
def test_normalized_reachability_matches_reference(card):
    port, ref = (c() for c in CARDS[card])
    for s in ref_states(ref):
        assert P.normalized_reachability(port, s) == \
            R.normalized_reachability(ref, s)


def test_actions_describe_as_the_reference():
    port, ref = MigH100Backend(), RefH100()
    pm, rpm = PartitionManager(port), RefManager(ref)
    part, rpart = pm.allocate(port.profiles[0]), rpm.allocate(ref.profiles[0])
    pl = pm.best_placement(pm.state, port.profiles[1])
    rpl = rpm.best_placement(rpm.state, ref.profiles[1])

    def build(pk, part, pl):
        fresh = pk.FreshAllocate(pl)
        return [pk.ReuseIdle(part), fresh,
                pk.ReshapeFuseFission(pl, (part,)), pk.Grow(part, fresh),
                pk.Shrink(part, fresh), pk.Wait(), pk.Wait("busy"),
                pk.Migrate("h100-1", fresh),
                pk.Migrate("h100-1", fresh, zone="eu", data_movement_s=2.5)]

    assert [_action(a) for a in build(P, part, pl)] == [
        _action(a) for a in build(R, rpart, rpl)]


def test_a_set_tracer_raises_until_the_flight_recorder_is_ported():
    assert P.PartitionPlanner.tracer is None
    pm = PartitionManager(MigH100Backend())
    planner = P.PartitionPlanner(pm, P.SCHEME_B_COST)
    plan = planner.plan(P.place_request(pm.backend, 5.0, 0.0, 0.3))
    planner.tracer = object()
    for call in (lambda: planner.plan(plan.request),
                 lambda: planner.execute(plan)):
        with pytest.raises(NotImplementedError, match="item 16"):
            call()
    assert pm.state == frozenset() and not pm.live


def test_package_exports_the_reference_names_but_the_oracle():
    oracle = {"BatchOracle", "DecisionRegret", "GrowWaitBound",
              "OracleClass", "OracleResult", "admissible_lower_bound_s",
              "attribute_decisions", "classes_from_jobs",
              "classes_from_specs", "energy_lower_bound_j",
              "grow_wait_sequence_bound", "solve_batch_oracle"}
    assert set(P.__all__) == set(R.__all__) - oracle
