"""The port's cluster-of-fleets layer against the reference, on the CPU:
the tariff, the zones and their workload, each zone router, and the
cluster run through ``run_cluster`` and ``api.simulate`` kind ``cluster``
on the reference bench's three arms and the reference example's whale
arms (the one scenario that makes a cross-zone ``Migrate``), traced and
untraced, plus ``launch/cluster_sim.py``'s output.

Host code on both sides: every comparison is against live ``repro`` in
this interpreter, with ``==`` (never against the reference's goldens,
whose last bits move under Python 3.12's ``sum``)."""

import dataclasses
import importlib.util
import io
import math
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from repro import api as ref_api
from repro import cluster as ref_cluster
from repro.core.scheduler import job as ref_job
from repro.obs import Tracer as RefTracer
from repro_torch import api, cluster
from repro_torch.core.scheduler import job
from repro_torch.launch import cluster_sim
from repro_torch.obs import Tracer

ROOT = Path(__file__).resolve().parents[1]
SIDES = {"port": (cluster, job, api, Tracer),
         "ref": (ref_cluster, ref_job, ref_api, RefTracer)}
POLICIES = ["single_zone", "price_greedy", "follow_the_sun"]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_BENCH = _load("benchmarks/bench_cluster.py", "_ref_bench_cluster")
REF_EXAMPLE = _load("examples/cluster_sim.py", "_ref_example_cluster")


def _metrics(m):
    """Every field of a ClusterMetrics (its per-zone metrics, per-device
    records and migration lines as plain values) and its derived
    properties."""
    return (dataclasses.asdict(m), m.throughput, m.summary(),
            [z.summary() for z in m.per_zone])


def _tou(pkg, trough=0.05, peak=0.25, period=200.0, phase=0.0):
    return pkg.ZoneTariff("tou", trough, peak, period_s=period, phase_s=phase)


def test_exports_are_the_reference():
    assert cluster.__all__ == ref_cluster.__all__
    for name in cluster.__all__:
        obj = getattr(cluster, name)
        if hasattr(obj, "__module__"):
            assert obj.__module__.startswith("repro_torch."), name
        else:
            assert obj == getattr(ref_cluster, name), name


# -- tariff ------------------------------------------------------------------------


@pytest.mark.parametrize("trough,peak,period,phase", [
    (0.05, 0.25, 86400.0, 0.0), (0.05, 0.25, 600.0, 200.0),
    (0.11, 0.11, 3600.0, -50.0), (0.02, 0.4, 1000.0, 12345.6)])
def test_tariff_prices_over_a_day_equal_the_reference(trough, peak, period,
                                                      phase):
    port = cluster.ZoneTariff("t", trough, peak, period, phase)
    ref = ref_cluster.ZoneTariff("t", trough, peak, period, phase)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for i in range(97):                          # every quarter hour
        t = i * 900.0
        assert port.price_at(t) == ref.price_at(t)
        for width in (0.0, 1.0, 600.0, 7200.0, -3.0):
            assert port.mean_price(t, t + width) == \
                ref.mean_price(t, t + width)
    assert cluster.ZoneTariff.flat(0.2) == cluster.ZoneTariff("flat", 0.2,
                                                              0.2)
    assert cluster.tariff.USD_PER_KWH_TO_USD_PER_J == \
        ref_cluster.tariff.USD_PER_KWH_TO_USD_PER_J


@pytest.mark.parametrize("args", [(0.3, 0.1), (0.0, 0.1), (0.1, 0.2, 0.0)])
def test_tariff_refuses_what_the_reference_refuses(args):
    with pytest.raises(ValueError) as port:
        cluster.ZoneTariff("bad", *args)
    with pytest.raises(ValueError) as ref:
        ref_cluster.ZoneTariff("bad", *args)
    assert str(port.value) == str(ref.value)


# -- zones and workload ------------------------------------------------------------


def test_make_zone_and_checkpoint_movement_equal_the_reference():
    assert (cluster.CROSS_ZONE_GBPS, cluster.CROSS_ZONE_SETUP_S) == \
        (ref_cluster.CROSS_ZONE_GBPS, ref_cluster.CROSS_ZONE_SETUP_S)
    port = cluster.make_zone("eu", ["a100", "a100", "h100"], _tou(cluster),
                             router="best_fit", phase_s=50.0)
    ref = ref_cluster.make_zone("eu", ["a100", "a100", "h100"],
                                _tou(ref_cluster), router="best_fit",
                                phase_s=50.0)
    assert [d.name for d in port.devices] == [d.name for d in ref.devices]
    assert [d.energy.model.p_idle_w for d in port.devices] == \
        [d.energy.model.p_idle_w for d in ref.devices]
    assert dataclasses.asdict(port.tariff) == dataclasses.asdict(ref.tariff)
    assert (port.name, port.phase_s, port.router.name) == \
        (ref.name, ref.phase_s, ref.router.name)
    assert port.idle_power_w() == ref.idle_power_w()
    assert port.load_fraction() == ref.load_fraction()
    for est in (None, 0.0, 4.5, 20.0, 60.0):
        jobs = [pkg_job.Job(name="j", mem_gb=20.0, t_kernel=1.0,
                            est_mem_gb=est) for pkg_job in (job, ref_job)]
        for route in ((None, "eu"), ("eu", "eu"), ("us", "eu")):
            for gbps in (cluster.CROSS_ZONE_GBPS, 1.0, 0.0):
                assert cluster.checkpoint_movement_s(jobs[0], *route,
                                                     gbps) == \
                    ref_cluster.checkpoint_movement_s(jobs[1], *route, gbps)
        assert port.feasible(jobs[0]) == ref.feasible(jobs[1])


@pytest.mark.parametrize("per_zone,period,peak,trough,seed", [
    (40, 600.0, 0.12, 0.02, 7), (30, 600.0, 0.12, 0.02, 42),
    (200, 100.0, 2.0, 0.1, 5)])
def test_cluster_workload_equals_the_reference(per_zone, period, peak,
                                               trough, seed):
    got = {}
    for side, (pkg, _, _, _) in SIDES.items():
        zones = [pkg.make_zone(name, ["a100", "h100"],
                               _tou(pkg, period=period), phase_s=k * period / 3)
                 for k, name in enumerate(("us", "eu", "ap"))]
        jobs, origin = pkg.cluster_workload(zones, per_zone, period, peak,
                                            trough, seed=seed)
        got[side] = ([dataclasses.asdict(j) for j in jobs], origin)
    assert got["port"] == got["ref"]
    assert len(got["port"][0]) == 3 * per_zone


# -- zone routers ------------------------------------------------------------------


def _routing_cases(pkg, side_job):
    """The reference tests' routing scenarios: (router name, job, zones,
    t, from_zone)."""
    flat = pkg.ZoneTariff.flat
    whale = side_job.Job(name="w", mem_gb=60.0, t_kernel=1.0,
                         est_mem_gb=60.0)
    long_job = side_job.Job(name="long", mem_gb=4.0, t_kernel=30.0,
                            est_mem_gb=4.0, t_fixed=0.0)
    gauss = side_job.rodinia_job("gaussian")
    euler = side_job.rodinia_job("euler3d")
    return {
        "single_home_pricier": ("single_zone", gauss, [
            pkg.make_zone("us", ["a100"], flat(0.50)),
            pkg.make_zone("eu", ["a100"], flat(0.01))], 0.0, None),
        "single_escape": ("single_zone", whale, [
            pkg.make_zone("us", ["a100"], flat(0.10)),
            pkg.make_zone("eu", ["h100"], flat(0.10))], 0.0, None),
        "greedy_night": ("price_greedy", gauss, [
            pkg.make_zone("noon", ["a100"], _tou(pkg, period=100.0),
                          phase_s=50.0),
            pkg.make_zone("night", ["a100"], _tou(pkg, period=100.0))],
            0.0, None),
        "movement_tie": ("follow_the_sun", euler, [
            pkg.make_zone("us", ["a100"], flat(0.10)),
            pkg.make_zone("eu", ["a100"], flat(0.10))], 0.0, "eu"),
        "greedy_crossover": ("price_greedy", long_job, [
            pkg.make_zone("waning", ["a100"], _tou(pkg, period=100.0),
                          phase_s=2.0),
            pkg.make_zone("waxing", ["a100"], _tou(pkg, period=100.0),
                          phase_s=-18.0)], 0.0, None),
        "sun_crossover": ("follow_the_sun", long_job, [
            pkg.make_zone("waning", ["a100"], _tou(pkg, period=100.0),
                          phase_s=2.0),
            pkg.make_zone("waxing", ["a100"], _tou(pkg, period=100.0),
                          phase_s=-18.0)], 0.0, None),
        "sun_three_zones": ("follow_the_sun", euler, [
            pkg.make_zone(name, ["a100", "h100"], _tou(pkg, period=600.0),
                          phase_s=k * 200.0)
            for k, name in enumerate(("us", "eu", "ap"))], 137.0, "ap"),
    }


@pytest.mark.parametrize("case", ["single_home_pricier", "single_escape",
                                  "greedy_night", "movement_tie",
                                  "greedy_crossover", "sun_crossover",
                                  "sun_three_zones"])
def test_zone_router_choice_equals_the_reference(case):
    name, port_job, port_zones, t, src = _routing_cases(cluster, job)[case]
    _, ref_job_, ref_zones, _, _ = _routing_cases(ref_cluster, ref_job)[case]
    port = cluster.make_zone_router(name)
    ref = ref_cluster.make_zone_router(name)
    assert (port.name, port.cross_zone_gbps, type(port).__name__) == \
        (ref.name, ref.cross_zone_gbps, type(ref).__name__)
    assert [z.name for z in port.rank(port_job, port_zones, t, src)] == \
        [z.name for z in ref.rank(ref_job_, ref_zones, t, src)]
    for pz, rz in zip(port_zones, ref_zones):
        for horizon in (None, 30.0):
            assert dataclasses.asdict(cluster.zone_cost_terms(
                port_job, pz, t, from_zone=src, horizon_s=horizon)) == \
                dataclasses.asdict(ref_cluster.zone_cost_terms(
                    ref_job_, rz, t, from_zone=src, horizon_s=horizon))
        if isinstance(port, cluster.CostZoneRouter):
            assert port.cost_model.cost(cluster.zone_cost_terms(
                port_job, pz, t, from_zone=src)) == \
                ref.cost_model.cost(ref_cluster.zone_cost_terms(
                    ref_job_, rz, t, from_zone=src))


def test_refresh_zone_prices_sets_each_cost_router_as_the_reference():
    got = {}
    for side, (pkg, _, _, _) in SIDES.items():
        zones = [pkg.make_zone("us", ["a100"], _tou(pkg), router="best_fit"),
                 pkg.make_zone("eu", ["a100"], _tou(pkg),
                               router="energy_aware", phase_s=70.0)]
        pkg.policies.refresh_zone_prices(zones, 33.0)
        got[side] = [z.router.price_per_j for z in zones]
    assert got["port"] == got["ref"]


def test_unknown_router_refused_as_the_reference():
    with pytest.raises(ValueError) as port:
        cluster.make_zone_router("teleport")
    with pytest.raises(ValueError) as ref:
        ref_cluster.make_zone_router("teleport")
    assert str(port.value) == str(ref.value)


# -- the cluster run ---------------------------------------------------------------


def _bench_arm(side, policy):
    """The reference bench's zones and workload, built by ``side``."""
    pkg = SIDES[side][0]
    tariff = pkg.ZoneTariff("tou", trough_usd_per_kwh=0.05,
                            peak_usd_per_kwh=0.25, period_s=600.0)
    zones = [pkg.make_zone(name, shape, tariff, phase_s=phase)
             for name, shape, phase in REF_BENCH.ZONE_SHAPES]
    jobs, origin = pkg.cluster_workload(
        zones, REF_BENCH.JOBS_PER_ZONE, period_s=REF_BENCH.PERIOD_S,
        peak_rate=REF_BENCH.PEAK_RATE, trough_rate=REF_BENCH.TROUGH_RATE,
        seed=REF_BENCH.SEED)
    return zones, pkg.make_zone_router(policy), jobs, origin


def _whale_arm(side, policy):
    """The reference example's zones and whale workload, built by
    ``side`` (the port through launch/cluster_sim.py)."""
    if side == "port":
        zones = cluster_sim._zones()
        jobs, origin = cluster_sim.whale_workload(zones)
        return zones, cluster.make_zone_router(policy), jobs, origin
    zones = REF_EXAMPLE.build_zones()
    jobs, origin = REF_EXAMPLE.build_workload(zones)
    return zones, ref_cluster.make_zone_router(policy), jobs, origin


ARMS = {"bench": _bench_arm, "whale": _whale_arm}


@pytest.mark.parametrize("entry", ["run_cluster", "simulate"])
@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("policy", POLICIES)
def test_cluster_metrics_equal_the_reference(arm, policy, entry):
    got = {}
    for side, (pkg, _, side_api, _) in SIDES.items():
        zones, router, jobs, origin = ARMS[arm](side, policy)
        if entry == "run_cluster":
            got[side] = pkg.run_cluster(zones, router, jobs, origin=origin)
        else:
            got[side] = side_api.simulate(side_api.RunSpec(
                kind="cluster", zones=zones, router=router, jobs=jobs,
                origin=origin))
    assert _metrics(got["port"]) == _metrics(got["ref"])
    m = got["port"]
    assert sum(z.n_finished for z in m.per_zone) == m.n_jobs
    if arm == "whale":
        # the whale's OOM restart: across zones under the cost routers,
        # counted once there and never in a fleet's own n_migrations
        assert m.n_oom == 1 and m.n_migrations == 0
        want = 0 if policy == "single_zone" else 1
        assert m.n_cross_zone_migrations == len(m.migrations) == want
    else:
        assert m.n_cross_zone_migrations == 0


@pytest.mark.parametrize("case", ["whale_once", "origin_staging",
                                  "flat_price"])
def test_small_cluster_runs_equal_the_reference(case):
    got = {}
    for side, (pkg, side_job, _, _) in SIDES.items():
        flat = pkg.ZoneTariff.flat
        if case == "whale_once":
            zones = [pkg.make_zone("cheap", ["a100"], flat(0.05)),
                     pkg.make_zone("dear", ["h100"], flat(0.25))]
            jobs = [side_job.Job(name="whale", mem_gb=60.0, t_kernel=3.0,
                                 compute_demand=0.8, est_mem_gb=30.0)]
            origin, policy = {"whale": "cheap"}, "price_greedy"
        elif case == "origin_staging":
            zones = [pkg.make_zone("home", ["a100"], flat(0.25)),
                     pkg.make_zone("away", ["a100"], flat(0.05))]
            jobs = [side_job.rodinia_job("gaussian")]
            origin, policy = {jobs[0].name: "home"}, "price_greedy"
        else:
            zones = [pkg.make_zone("us", ["a100"], flat(0.36))]
            jobs = [side_job.rodinia_job("gaussian")]
            origin, policy = None, "single_zone"
        got[side] = pkg.run_cluster(zones, pkg.make_zone_router(policy),
                                    jobs, origin=origin)
    assert _metrics(got["port"]) == _metrics(got["ref"])
    if case == "whale_once":
        assert got["port"].n_cross_zone_migrations == 1
        assert got["port"].data_movement_s == \
            cluster.CROSS_ZONE_SETUP_S + 60.0 / cluster.CROSS_ZONE_GBPS
    if case == "flat_price":
        assert math.isclose(got["port"].dollars,
                            got["port"].energy_j * 1e-7, rel_tol=1e-9)


@pytest.mark.parametrize("case", ["duplicate", "deadlock"])
def test_cluster_refuses_what_the_reference_refuses(case):
    errors = {}
    for side, (pkg, side_job, _, _) in SIDES.items():
        zones = [pkg.make_zone("z", ["a100"], pkg.ZoneTariff.flat(0.1))]
        jobs = []
        if case == "duplicate":
            zones.append(pkg.make_zone("z", ["a100"],
                                       pkg.ZoneTariff.flat(0.1)))
        else:
            jobs = [side_job.Job(name="lev", mem_gb=500.0, t_kernel=1.0,
                                 est_mem_gb=500.0)]
        with pytest.raises((ValueError, RuntimeError)) as exc:
            pkg.run_cluster(zones, pkg.make_zone_router("single_zone"), jobs)
        errors[side] = (type(exc.value).__name__, str(exc.value))
    assert errors["port"] == errors["ref"]


@pytest.mark.parametrize("policy", ["price_greedy", "follow_the_sun"])
def test_traced_whale_run_records_equal_the_reference(policy, tmp_path):
    """The whale arm under a tracer: every record (the cross-zone
    ``migrate.xzone`` instant among them) and the JSONL bytes as the
    reference's, and the metrics as the untraced run's."""
    got, untraced = {}, {}
    for side, (pkg, _, _, side_tracer) in SIDES.items():
        tracer = side_tracer()
        zones, router, jobs, origin = _whale_arm(side, policy)
        m = pkg.run_cluster(zones, router, jobs, origin=origin,
                            tracer=tracer)
        path = tmp_path / f"{side}.jsonl"
        tracer.write_jsonl(str(path))
        got[side] = (tracer.records, path.read_bytes(), _metrics(m))
        zones, router, jobs, origin = _whale_arm(side, policy)
        untraced[side] = _metrics(pkg.run_cluster(zones, router, jobs,
                                                  origin=origin))
    assert got["port"] == got["ref"]
    assert got["port"][2] == untraced["port"] == untraced["ref"]
    xzone = [r for r in got["port"][0] if r.get("name") == "migrate.xzone"]
    assert len(xzone) == 1 and xzone[0]["args"]["target_zone"] == "us-east"


def test_cluster_sim_launcher_prints_the_reference_bench_and_example():
    """launch/cluster_sim.py's table is the reference bench's output line
    for line, its whale arms the reference example's, and its check holds."""
    port_rows, ref_rows = [], []
    port_out, ref_out = io.StringIO(), io.StringIO()
    with redirect_stdout(port_out):
        results = cluster_sim.run(port_rows)
        whale = cluster_sim.run_whale()
    with redirect_stdout(ref_out):
        REF_BENCH.run(ref_rows)
    assert port_rows == ref_rows
    bench_text = ref_out.getvalue()
    assert port_out.getvalue().startswith(bench_text)
    ref_whale = {}
    for policy in POLICIES:
        zones, router, jobs, origin = _whale_arm("ref", policy)
        ref_whale[policy] = ref_cluster.run_cluster(zones, router, jobs,
                                                    origin=origin)
        assert _metrics(whale[policy]) == _metrics(ref_whale[policy])
        line = f"\n== {policy} (whale) ==\n{whale[policy].summary()}\n"
        assert line in port_out.getvalue()
    assert [m.n_cross_zone_migrations for m in whale.values()] == [0, 1, 1]
    assert set(results) == set(POLICIES)


def test_cluster_sim_main_writes_the_example_trace(tmp_path, capsys):
    path = tmp_path / "fts.jsonl"
    assert cluster_sim.main(["--trace", str(path)]) == 0
    out = capsys.readouterr().out
    assert f"trace records to {path}" in out
    assert "cluster.follow_the_sun.dollar_saving" in out
    tracer = RefTracer()
    zones, router, jobs, origin = _whale_arm("ref", "follow_the_sun")
    ref_cluster.run_cluster(zones, router, jobs, origin=origin,
                            tracer=tracer)
    ref_path = tmp_path / "ref.jsonl"
    tracer.write_jsonl(str(ref_path))
    assert path.read_bytes() == ref_path.read_bytes()
