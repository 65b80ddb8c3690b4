"""The port's fleet against the reference, on the CPU: the admission
controller (`core/scheduler/admission.py`), the TPU-pod partition FSM of the
device catalogue (`core/tpu_slices.py`), the arrival generators, each
router with and without the routing index, the device catalogue, and the
fleet run through ``run_fleet``, ``FleetOrchestrator`` and
``api.simulate`` kind ``fleet``.

Host code on both sides: every comparison is against live ``repro`` in
this interpreter, with ``==`` (never against the reference's goldens,
whose last bits move under Python 3.12's ``sum``)."""

import dataclasses

import pytest

from repro import api as ref_api
from repro.core import mig_a100 as ref_mig_a100
from repro.core import mig_h100 as ref_mig_h100
from repro.core import tpu_slices as ref_tpu_slices
from repro.core.planner.graph import \
    compile_transition_graph as ref_compile_graph
from repro.core.scheduler import admission as ref_admission
from repro.core.scheduler.job import rodinia_job as ref_rodinia_job
from repro import fleet as ref_fleet
from repro.fleet import arrivals as ref_arrivals
from repro_torch import api, fleet
from repro_torch.core import mig_a100, mig_h100, tpu_slices
from repro_torch.core.planner.graph import compile_transition_graph
from repro_torch.core.reachability import clear_reachability_cache
from repro_torch.core.scheduler import admission
from repro_torch.core.scheduler.job import rodinia_job
from repro_torch.fleet import arrivals

BACKENDS = {"a100": (mig_a100.MigA100Backend, ref_mig_a100.MigA100Backend),
            "h100": (mig_h100.MigH100Backend, ref_mig_h100.MigH100Backend)}
POLICIES = ["round_robin", "random", "best_fit", "energy_aware"]
POOL = ["myocyte", "gaussian", "srad", "euler3d", "particlefilter", "nw",
        "lavamd", "hotspot3d", "cfd_full"]


def _fleet_metrics(m):
    """Every field of a FleetMetrics (its per-device Metrics and records
    as dicts) and its derived properties, as plain values."""
    return (dataclasses.asdict(m), m.throughput, m.energy_per_job,
            m.summary())


def _jobs(side, n, rate, seed=7):
    """The reference bench's Rodinia-style mix of ``n`` jobs with Poisson
    arrivals, built by the port (``side="port"``) or the reference."""
    if side == "port":
        return fleet.poisson_arrivals(
            [rodinia_job(POOL[i % len(POOL)], i) for i in range(n)],
            rate_per_s=rate, seed=seed)
    return ref_fleet.poisson_arrivals(
        [ref_rodinia_job(POOL[i % len(POOL)], i) for i in range(n)],
        rate_per_s=rate, seed=seed)


def test_exports_are_the_reference():
    assert fleet.__all__ == ref_fleet.__all__
    for name in fleet.__all__:
        assert getattr(fleet, name).__module__.startswith("repro_torch."), \
            name


# -- admission -------------------------------------------------------------------


@pytest.mark.parametrize("model", list(BACKENDS))
def test_reach_floor_and_hosting_states_equal_the_reference(model):
    """The hosting DP and the reach floor of every profile at k = 0..4, on
    each MIG backend's compiled graph."""
    port_b, ref_b = BACKENDS[model][0](), BACKENDS[model][1]()
    graph, ref_graph = compile_transition_graph(port_b), \
        ref_compile_graph(ref_b)
    assert [p.name for p in port_b.profiles] == \
        [p.name for p in ref_b.profiles]
    for prof, ref_prof in zip(port_b.profiles, ref_b.profiles):
        for k in range(5):
            assert admission.hosting_states(graph, prof, k) == \
                ref_admission.hosting_states(ref_graph, ref_prof, k)
            assert admission.reach_floor(graph, prof, k) == \
                ref_admission.reach_floor(ref_graph, ref_prof, k)


def test_arrival_forecast_equals_the_reference():
    port, ref = admission.ArrivalForecast(0.3), \
        ref_admission.ArrivalForecast(0.3)
    assert port.rate_per_s(0.0) == ref.rate_per_s(0.0) == 0.0
    t = 0.0
    for i in range(30):
        t += 0.25 + (i % 7) * 0.4
        mem = None if i % 5 == 0 else 1.0 + (i % 3) * 4.5
        port.observe(t, mem)
        ref.observe(t, mem)
        for later in (t, t + 3.0, t + 60.0):
            assert port.rate_per_s(later) == ref.rate_per_s(later)
            assert port.expected_arrivals(later, 20.0) == \
                ref.expected_arrivals(later, 20.0)
        assert port.typical_mem_gb == ref.typical_mem_gb


@pytest.mark.parametrize("model", list(BACKENDS))
def test_controller_decisions_equal_the_reference(model):
    """AdmissionController.decide on planned placements of a filling
    device, under a forecast of bursting arrivals: verdict, floor, reach
    and reason as the reference's."""
    dev, ref_dev = fleet.make_device(model), ref_fleet.make_device(model)
    ctrl = admission.AdmissionController(horizon_s=20.0)
    ref_ctrl = ref_admission.AdmissionController(horizon_s=20.0)
    jobs = [rodinia_job(POOL[i % len(POOL)], i) for i in range(8)]
    ref_jobs = [ref_rodinia_job(POOL[i % len(POOL)], i) for i in range(8)]
    decisions = 0
    for i, (job, ref_job) in enumerate(zip(jobs, ref_jobs)):
        ctrl.note_arrival(0.5 * i, job)
        ref_ctrl.note_arrival(0.5 * i, ref_job)
        for shares in (1, 2):
            assert ctrl.required_placements(0.5 * i, shares) == \
                ref_ctrl.required_placements(0.5 * i, shares)
        plan, ref_plan = dev.plan_place(job), ref_dev.plan_place(ref_job)
        if plan.chosen is None:
            assert ref_plan.chosen is None
            continue
        got = ctrl.decide(dev.pm, plan, 0.5 * i)
        want = ref_ctrl.decide(ref_dev.pm, ref_plan, 0.5 * i)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.describe() == want.describe()
        decisions += 1
        dev.pm.allocate(dev.backend.tightest_profile(job.est_mem_gb))
        ref_dev.pm.allocate(ref_dev.backend.tightest_profile(
            ref_job.est_mem_gb))
    assert decisions >= 3


# -- the TPU pod of the catalogue -------------------------------------------------


def test_tpu_pod_profiles_and_reachability_equal_the_reference():
    """The pod FSM's profiles, its depth helpers and |F_s| from the empty
    pod through a walk of placements and frees, with every placement list
    and description on the way."""
    port, ref = tpu_slices.make_backend(), ref_tpu_slices.make_backend()
    assert [dataclasses.asdict(p) for p in port.profiles] == \
        [dataclasses.asdict(p) for p in ref.profiles]
    for d in range(tpu_slices.MAX_DEPTH + 1):
        assert tpu_slices.shape_at_depth(d) == ref_tpu_slices.shape_at_depth(d)
        assert tpu_slices.chips_at_depth(d) == ref_tpu_slices.chips_at_depth(d)
        assert tpu_slices.f_configs(d) == ref_tpu_slices.f_configs(d)
    assert port.total_mem_gb() == ref.total_mem_gb()
    state, ref_state = port.initial_state(), ref.initial_state()
    assert state == ref_state
    held = []
    for step in range(12):
        prof = port.profiles[(3 * step) % len(port.profiles)]
        ref_prof = ref.profiles[(3 * step) % len(ref.profiles)]
        pls = port.enumerate_placements(state, prof)
        ref_pls = ref.enumerate_placements(ref_state, ref_prof)
        assert [(p.handle, p.next_state) for p in pls] == \
            [(p.handle, p.next_state) for p in ref_pls]
        if pls:
            state, ref_state = pls[0].next_state, ref_pls[0].next_state
            held.append(pls[0].handle)
            assert port.slice_shape(held[-1]) == ref.slice_shape(held[-1])
            assert port.slice_origin(held[-1]) == ref.slice_origin(held[-1])
        if step % 4 == 3 and held:
            h = held.pop(0)
            state, ref_state = port.free(state, h), ref.free(ref_state, h)
        assert state == ref_state
        assert port.reachability(state) == ref.reachability(ref_state)
        assert port.describe(state) == ref.describe(ref_state)


def test_catalogue_devices_equal_the_reference():
    for model in fleet.devices.DEVICE_CATALOGUE:
        dev = fleet.make_device(model, name=f"{model}-0")
        ref = ref_fleet.make_device(model, name=f"{model}-0")
        assert type(dev.pm.backend).__name__ == type(ref.pm.backend).__name__
        assert dataclasses.asdict(dev.energy.model) == \
            dataclasses.asdict(ref.energy.model)
        assert dev.reconfig_cost_s == ref.reconfig_cost_s
        assert dev.name == ref.name
    assert fleet.devices.WAKE_LATENCY_S == ref_fleet.devices.WAKE_LATENCY_S
    with pytest.raises(ValueError, match="unknown device model"):
        fleet.make_device("v100")
    shape = {"a100": 2, "h100": 1, "tpu-v5e": 1}
    assert [d.name for d in fleet.make_fleet(shape)] == \
        [d.name for d in ref_fleet.make_fleet(shape)]


# -- arrivals -------------------------------------------------------------------


def _stamps(jobs):
    return [(j.name, j.arrival) for j in jobs]


@pytest.mark.parametrize("seed,rate,start", [(0, 0.4, 0.0), (7, 2.5, 10.0)])
def test_poisson_arrivals_equal_the_reference(seed, rate, start):
    got = arrivals.poisson_arrivals(
        [rodinia_job(POOL[i % 9], i) for i in range(50)], rate, seed, start)
    want = ref_arrivals.poisson_arrivals(
        [ref_rodinia_job(POOL[i % 9], i) for i in range(50)], rate, seed,
        start)
    assert _stamps(got) == _stamps(want)
    assert arrivals.poisson_arrivals([], 1.0) == []


@pytest.mark.parametrize("exact", [False, True])
def test_diurnal_arrivals_equal_the_reference(exact):
    kw = dict(period_s=600.0, peak_rate=1.5, trough_rate=0.1, seed=3,
              phase_s=120.0, exact=exact)
    got = arrivals.diurnal_arrivals(
        [rodinia_job(POOL[i % 9], i) for i in range(60)], **kw)
    want = ref_arrivals.diurnal_arrivals(
        [ref_rodinia_job(POOL[i % 9], i) for i in range(60)], **kw)
    assert _stamps(got) == _stamps(want)
    with pytest.raises(ValueError):
        arrivals.diurnal_arrivals([rodinia_job("nw", 0)], 600.0, 0.1, 1.5)


def _rows(rows):
    return [dataclasses.asdict(r) for r in rows]


def test_alibaba_csv_rows_and_jobs_equal_the_reference(tmp_path):
    """Synthetic cluster-trace rows written by the port, read back by both
    packages (list and streaming readers, two time scales and GPU memory
    sizes), and the jobs built from them."""
    rows = arrivals.synthetic_alibaba_rows(40, seed=5, rate_per_s=0.3)
    assert _rows(rows) == _rows(ref_arrivals.synthetic_alibaba_rows(
        40, seed=5, rate_per_s=0.3))
    assert _rows(arrivals.iter_synthetic_alibaba_rows(40, seed=5,
                                                      rate_per_s=0.3)) \
        == _rows(rows)
    path = str(tmp_path / "trace.csv")
    assert arrivals.write_alibaba_csv(rows, path) == 40
    ref_path = str(tmp_path / "ref_trace.csv")
    ref_arrivals.write_alibaba_csv(
        ref_arrivals.synthetic_alibaba_rows(40, seed=5, rate_per_s=0.3),
        ref_path)
    with open(path) as a, open(ref_path) as b:
        assert a.read() == b.read()
    for kw in ({}, {"time_scale": 0.5, "gpu_mem_gb": 80.0}):
        got = arrivals.load_alibaba_csv(path, **kw)
        want = ref_arrivals.load_alibaba_csv(path, **kw)
        assert _rows(got) == _rows(want)
        assert _rows(arrivals.iter_alibaba_csv(path, **kw)) == _rows(want)
    for got, want in (
            (rows, ref_arrivals.synthetic_alibaba_rows(40, seed=5,
                                                       rate_per_s=0.3)),
            (arrivals.load_alibaba_csv(path),
             ref_arrivals.load_alibaba_csv(path))):
        jobs = [dataclasses.asdict(j) for j in arrivals.jobs_from_trace(got)]
        assert jobs == [dataclasses.asdict(j)
                        for j in ref_arrivals.jobs_from_trace(want)]
        assert [dataclasses.asdict(j)
                for j in arrivals.iter_jobs_from_trace(got)] == jobs


# -- routers and the fleet run ----------------------------------------------------


@pytest.mark.parametrize("use_index", [True, False])
@pytest.mark.parametrize("policy", POLICIES)
def test_each_router_runs_the_fleet_as_the_reference(policy, use_index):
    """run_fleet over a mixed fleet with each router, with the routing
    index bound (the default for the cost routers) and without it (the
    seed full sort): FleetMetrics equal the reference's, and index and
    full sort agree."""
    shape = ["a100", "a100", "h100", "h100"]
    router = fleet.make_router(policy, seed=7)
    ref_router = ref_fleet.make_router(policy, seed=7)
    router.use_index = ref_router.use_index = use_index
    got = fleet.run_fleet(fleet.make_fleet(shape), router,
                          _jobs("port", 40, 0.6))
    want = ref_fleet.run_fleet(ref_fleet.make_fleet(shape), ref_router,
                               _jobs("ref", 40, 0.6))
    assert _fleet_metrics(got) == _fleet_metrics(want)
    if router.stateless_rank:
        assert (router.index is not None) == use_index
    other = fleet.make_router(policy, seed=7)
    other.use_index = not use_index
    again = fleet.run_fleet(fleet.make_fleet(shape), other,
                            _jobs("port", 40, 0.6))
    assert _fleet_metrics(again) == _fleet_metrics(got)


@pytest.mark.parametrize("policy", ["best_fit", "energy_aware"])
def test_cost_router_ranks_equal_the_reference(policy):
    """device_cost_terms and rank on a fleet with work placed on it."""
    shape = ["a100", "h100", "a100"]
    devs, ref_devs = fleet.make_fleet(shape), ref_fleet.make_fleet(shape)
    for i, (dev, ref_dev) in enumerate(zip(devs, ref_devs)):
        for k in range(i):
            dev.pm.allocate(dev.backend.tightest_profile(5.0 + 4 * k))
            ref_dev.pm.allocate(ref_dev.backend.tightest_profile(
                5.0 + 4 * k))
    router = fleet.make_router(policy)
    ref_router = ref_fleet.make_router(policy)
    for i in range(9):
        job, ref_job = rodinia_job(POOL[i], i), ref_rodinia_job(POOL[i], i)
        assert [d.name for d in router.rank(job, devs)] == \
            [d.name for d in ref_router.rank(ref_job, ref_devs)]
        for dev, ref_dev in zip(devs, ref_devs):
            assert dataclasses.asdict(fleet.device_cost_terms(job, dev)) == \
                dataclasses.asdict(ref_fleet.device_cost_terms(ref_job,
                                                               ref_dev))


def test_admission_in_the_fleet_equals_the_reference():
    """A burst into a two-device fleet under the reach-floor controller:
    the deferrals, overrides and every metric as the reference's."""
    shape = ["a100", "h100"]
    got = fleet.run_fleet(fleet.make_fleet(shape),
                          fleet.make_router("best_fit"),
                          _jobs("port", 40, 2.0, seed=2),
                          admission=fleet.AdmissionController(horizon_s=20.0))
    want = ref_fleet.run_fleet(
        ref_fleet.make_fleet(shape), ref_fleet.make_router("best_fit"),
        _jobs("ref", 40, 2.0, seed=2),
        admission=ref_fleet.AdmissionController(horizon_s=20.0))
    assert got.n_admission_deferrals >= 1
    assert _fleet_metrics(got) == _fleet_metrics(want)


def test_api_fleet_kind_and_orchestrator_equal_the_reference():
    """api.simulate kind "fleet" (the catalogue's TPU pod among the
    devices, a wake latency of 3 s) and FleetOrchestrator.run twice on one
    fleet, whose energy integrator keeps accumulating across runs."""
    shape = ["a100", "h100", "tpu-v5e"]
    spec = dict(kind="fleet", wake_latency_s=3.0)
    got = api.simulate(api.RunSpec(
        devices=fleet.make_fleet(shape),
        router=fleet.make_router("energy_aware"),
        jobs=_jobs("port", 30, 0.5), **spec))
    want = ref_api.simulate(ref_api.RunSpec(
        devices=ref_fleet.make_fleet(shape),
        router=ref_fleet.make_router("energy_aware"),
        jobs=_jobs("ref", 30, 0.5), **spec))
    assert isinstance(got, fleet.FleetMetrics)
    assert _fleet_metrics(got) == _fleet_metrics(want)
    orch = fleet.FleetOrchestrator(fleet.make_fleet(["a100", "h100"]),
                                   fleet.make_router("best_fit"))
    ref_orch = ref_fleet.FleetOrchestrator(
        ref_fleet.make_fleet(["a100", "h100"]),
        ref_fleet.make_router("best_fit"))
    for seed in (1, 2):
        assert _fleet_metrics(orch.run(_jobs("port", 12, 0.5, seed))) == \
            _fleet_metrics(ref_orch.run(_jobs("ref", 12, 0.5, seed)))
    assert orch.energy.joules == ref_orch.energy.joules
    assert [dataclasses.asdict(r) for r in orch.energy.breakdown()] == \
        [dataclasses.asdict(r) for r in ref_orch.energy.breakdown()]


def test_priced_energy_integrator_equals_the_reference():
    """The fleet through api.simulate with a PricedEnergyIntegrator on a
    time-of-day price curve: dollars and the cost summary as the
    reference's."""
    def price(t):
        return 1e-7 * (2.0 if (t // 100) % 2 else 1.0)

    devs, ref_devs = fleet.make_fleet(["a100"] * 2), \
        ref_fleet.make_fleet(["a100"] * 2)
    energy = fleet.PricedEnergyIntegrator(devs, price)
    ref_energy = ref_fleet.PricedEnergyIntegrator(ref_devs, price)
    got = api.simulate(api.RunSpec(
        kind="fleet", devices=devs, router=fleet.make_router("best_fit"),
        jobs=_jobs("port", 20, 0.4), energy=energy))
    want = ref_api.simulate(ref_api.RunSpec(
        kind="fleet", devices=ref_devs,
        router=ref_fleet.make_router("best_fit"),
        jobs=_jobs("ref", 20, 0.4), energy=ref_energy))
    assert _fleet_metrics(got) == _fleet_metrics(want)
    for t in (50.0, 150.0, got.makespan):
        energy.observe(t)
        ref_energy.observe(t)
    assert energy.dollars == ref_energy.dollars
    assert dataclasses.asdict(energy.cost_summary()) == \
        dataclasses.asdict(ref_energy.cost_summary())


def test_fleet_launcher_rows_equal_the_reference_bench():
    """launch/fleet_sim.py's table rows and checks against the reference's
    benchmarks/bench_fleet.py, on the bench's own traffic."""
    from benchmarks import bench_fleet
    from repro_torch.launch import fleet_sim
    rows, ref_rows = [], []
    results = fleet_sim.run(rows)
    bench_fleet.run(ref_rows)
    assert rows == ref_rows
    assert len(results) == 12


def test_reachability_caches_clear_the_admission_floor_cache():
    """admission's floor cache is registered with the reachability
    caches, as the reference's is, so clearing those clears it."""
    graph = compile_transition_graph(mig_a100.MigA100Backend())
    admission.reach_floor(graph, graph.backend.profiles[0], 2)
    assert admission._FLOOR_CACHE
    clear_reachability_cache()
    assert not admission._FLOOR_CACHE
