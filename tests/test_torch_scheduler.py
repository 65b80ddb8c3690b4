"""The port's batch scheduler against the reference, in one interpreter.

Every Fig. 4 workload and arm on both MIG cards gives the same ``Metrics``
(every field, the run records and the streamed p99 included) as live
``repro``, compared with ``==``: the seed's goldens depend on the
interpreter's float summation, so the port is held to the reference run
here, not to them.  Each package builds its jobs from its own copy of the
mixes, and a separate test holds the two job lists equal.  Also held:
plan-ahead carving, streamed arrivals and lazy advance through the event
kernel, the event queue, ``api.simulate`` against the shims and its
refusals, the streaming counters, ``launch/fig4.py``'s rows against the
reference benches' rows, and ``chip_smoke.py``'s pinned phase-7 table.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import benchmarks.bench_fig4_general as ref_bench_general
import benchmarks.bench_fig4_ml as ref_bench_ml
import benchmarks.mixes as ref_mixes
import repro.api as ref_api
import repro.core.scheduler.events as ref_events
import repro.core.scheduler.kernel as ref_kernel
import repro.core.scheduler.policies as ref_policies
import repro.obs.counters as ref_counters
from repro.core import mig_a100 as ref_a100
from repro.core import mig_h100 as ref_h100
from repro.core.scheduler import energy as ref_energy
import repro_torch.api as api
import repro_torch.core.scheduler.events as events
import repro_torch.core.scheduler.kernel as kernel
import repro_torch.core.scheduler.policies as policies
import repro_torch.obs.counters as counters
from repro_torch.core import mig_a100, mig_h100
from repro_torch.core.scheduler import energy
from repro_torch.launch import fig4

REPO = Path(__file__).resolve().parents[1]

#: card -> (port backend factory, port power, ref backend factory, ref power)
CARDS = {"a100": (mig_a100.make_backend, energy.A100_POWER,
                  ref_a100.make_backend, ref_energy.A100_POWER),
         "h100": (mig_h100.make_backend, energy.H100_POWER,
                  ref_h100.make_backend, ref_energy.H100_POWER)}


def _ref_mix(workload):
    if workload in ref_mixes.RODINIA_MIXES:
        return ref_mixes.rodinia_mix(workload)
    if workload in ref_mixes.ML_MIXES:
        return ref_mixes.ml_mix(workload)
    return ref_mixes.llm_mix(workload)


def _ref_arms(workload, backend, power):
    """The reference benches' arms of ``workload``, in fig4's order."""
    p = ref_policies
    if workload in ref_mixes.LLM_SPECS:
        return {"full-GPU seq": p.run_baseline(_ref_mix(workload), backend,
                                               power),
                "A (no predict)": p.run_scheme_a(_ref_mix(workload), backend,
                                                 power, use_prediction=False),
                "A (predict)": p.run_scheme_a(_ref_mix(workload), backend,
                                              power, use_prediction=True)}
    arms = {"baseline": p.run_baseline(_ref_mix(workload), backend, power),
            "scheme_a": p.run_scheme_a(_ref_mix(workload), backend, power,
                                       use_prediction=False),
            "scheme_b": p.run_scheme_b(_ref_mix(workload), backend, power,
                                       use_prediction=False)}
    if workload in ref_mixes.ML_MIXES:
        arms["A+steal"] = p.run_scheme_a(_ref_mix(workload), backend, power,
                                         use_prediction=False,
                                         work_steal=True)
    return arms


def _metrics(m):
    """Every field of a Metrics (its RunRecords as dicts) and its derived
    properties, as plain values."""
    return (dataclasses.asdict(m), m.throughput, m.energy_per_job,
            m.summary())


def _job(j):
    return dataclasses.asdict(j)


def test_the_mixes_copy_the_reference_tables():
    assert fig4.RODINIA_MIXES == ref_mixes.RODINIA_MIXES
    assert fig4.ML_MIXES == ref_mixes.ML_MIXES
    assert fig4.LLM_SPECS == ref_mixes.LLM_SPECS
    assert fig4._DNN_SPECS == ref_mixes._DNN_SPECS
    assert fig4.WORKLOADS == (*ref_mixes.RODINIA_MIXES, *ref_mixes.ML_MIXES,
                              *ref_mixes.LLM_SPECS)
    from repro.core.scheduler import job as ref_job
    from repro_torch.core.scheduler import job
    assert job._RODINIA_POOL == ref_job._RODINIA_POOL
    assert job.GB == ref_job.GB


@pytest.mark.parametrize("workload", fig4.WORKLOADS)
def test_each_workload_builds_the_reference_jobs(workload):
    jobs, ref = fig4.mix(workload), _ref_mix(workload)
    assert len(jobs) == len(ref) > 0
    assert [_job(j) for j in jobs] == [_job(j) for j in ref]
    assert [j.is_dynamic for j in jobs] == [j.is_dynamic for j in ref]


@pytest.mark.parametrize("card", sorted(CARDS))
@pytest.mark.parametrize("workload", fig4.WORKLOADS)
def test_fig4_metrics_equal_the_reference(card, workload):
    """Every arm of phase 7a, every Metrics field, exactly."""
    make, power, ref_make, ref_power = CARDS[card]
    arms = fig4.run_workload(workload, make(), power)
    ref = _ref_arms(workload, ref_make(), ref_power)
    assert list(arms) == list(ref)
    for arm in arms:
        assert _metrics(arms[arm]) == _metrics(ref[arm]), arm
        assert arms[arm].records, arm


@pytest.mark.parametrize("card", sorted(CARDS))
@pytest.mark.parametrize("workload", ["Hm1", "Ht1", "Ht3", "Ml1", "Ml3",
                                      "flan_t5"])
def test_plan_ahead_carving_equals_the_reference(card, workload):
    make, power, ref_make, ref_power = CARDS[card]
    for steal in (False, True):
        got = policies.run_scheme_a(fig4.mix(workload), make(), power,
                                    use_prediction=True, work_steal=steal,
                                    plan_ahead=2)
        want = ref_policies.run_scheme_a(_ref_mix(workload), ref_make(),
                                         ref_power, use_prediction=True,
                                         work_steal=steal, plan_ahead=2)
        assert got.policy.endswith("+plan")
        assert _metrics(got) == _metrics(want)


def _seeded_stream(mix, workload, seed):
    """``workload``'s jobs arriving as a seeded Poisson stream (the first
    two at t=0), sorted by arrival."""
    jobs = mix(workload)
    gaps = np.random.default_rng(seed).exponential(2.0, len(jobs))
    t = np.cumsum(gaps) - gaps[0]
    for i, job in enumerate(jobs):
        job.arrival = 0.0 if i < 2 else float(t[i])
    return sorted(jobs, key=lambda j: j.arrival)


def _lazy(pk):
    """Scheme B with lazy device advancement (its hooks read no clock)."""
    return type("LazySchemeB", (pk.SchemeBPolicy,), {"lazy_advance": True})


def _two_devices(pk, lazy):
    """Scheme B's FIFO over two devices: the head job goes to the first
    device that can place it (the kernel's multi-device path)."""

    class TwoDevices(pk.SchemeBPolicy):
        lazy_advance = lazy

        def dispatch(self, k):
            started = False
            while k.queue:
                for dev in k.devices:
                    k.sync(dev)
                    placed = dev.try_place(k.queue[0])
                    if placed is not None:
                        k.start(dev, k.queue.pop(0), *placed)
                        started = True
                        break
                else:
                    break
            return started

        def result(self, k, jobs):
            return [d.metrics(len(jobs)) for d in k.devices]

    return TwoDevices()


def _run_kernel(side, card, workload, seed, stream, lazy, two=False):
    make, power, ref_make, ref_power = CARDS[card]
    pk_events, pk_kernel, pk_policies, mix = (
        (events, kernel, policies, fig4.mix) if side == "port" else
        (ref_events, ref_kernel, ref_policies, _ref_mix))
    backend = make() if side == "port" else ref_make()
    pw = power if side == "port" else ref_power
    jobs = _seeded_stream(mix, workload, seed)
    n = 2 if two else 1
    devs = [pk_events.DeviceSim(backend, pw, True, policy="scheme_b+pred",
                                name=f"dev{i}") for i in range(n)]
    if two:
        policy = _two_devices(pk_policies, lazy)
    else:
        policy = (_lazy(pk_policies) if lazy else pk_policies.SchemeBPolicy)()
    k = pk_kernel.EventKernel(devs, policy)
    out = k.run(iter(jobs) if stream else jobs, stream=stream)
    out = out if two else [out]
    return ([_metrics(m) for m in out], k.n_events, k.n_jobs_seen,
            [d.t for d in devs], [d.energy.joules for d in devs])


@pytest.mark.parametrize("card", sorted(CARDS))
@pytest.mark.parametrize("workload,seed", [("Ht3", 0), ("Ml1", 1),
                                           ("flan_t5", 2), ("Hm1", 3)])
def test_streamed_arrivals_and_lazy_advance_equal_the_reference(
        card, workload, seed):
    """``run(jobs, stream=True)`` stages one arrival at a time; lazy
    advance replays the clock per device.  Each mode equals the
    reference's, and (the kernel's contract) the eager, materialized run."""
    runs = {}
    for stream in (False, True):
        for lazy in (False, True):
            got = _run_kernel("port", card, workload, seed, stream, lazy)
            assert got == _run_kernel("ref", card, workload, seed, stream,
                                      lazy)
            runs[stream, lazy] = got
    eager = runs[False, False]
    for (stream, lazy), got in runs.items():
        # a streamed run's result sees no jobs list: n_jobs is 0 there
        assert got[1:] == eager[1:]
        if not stream:
            assert got == eager


@pytest.mark.parametrize("card", sorted(CARDS))
@pytest.mark.parametrize("lazy", [False, True])
def test_two_devices_through_one_kernel_equal_the_reference(card, lazy):
    for stream in (False, True):
        got = _run_kernel("port", card, "Ht3", 5, stream, lazy, two=True)
        assert got == _run_kernel("ref", card, "Ht3", 5, stream, lazy,
                                  two=True)
        assert all(m[0]["records"] for m in got[0])


def test_streamed_runs_refuse_what_the_reference_refuses():
    for pk, pke, make in ((kernel, events, mig_a100.make_backend),
                          (ref_kernel, ref_events, ref_a100.make_backend)):
        dev = pke.DeviceSim(make(), energy.A100_POWER)
        batch = (policies if pk is kernel else ref_policies).SchemeAPolicy()
        with pytest.raises(ValueError, match="online policy"):
            pk.EventKernel([dev], batch).run([], stream=True)
        with pytest.raises(ValueError, match="at least one device"):
            pk.EventKernel([], batch)
        jobs = _seeded_stream(fig4.mix if pk is kernel else _ref_mix,
                              "Hm1", 0)
        online = (policies if pk is kernel else ref_policies).SchemeBPolicy()
        with pytest.raises(ValueError, match="sorted by arrival"):
            pk.EventKernel([pke.DeviceSim(make(), energy.A100_POWER)],
                           online).run(iter(jobs[::-1]), stream=True)
        with pytest.raises(ValueError, match="duplicate job names"):
            pk.EventKernel([pke.DeviceSim(make(), energy.A100_POWER)],
                           online).run(jobs + jobs[:1])


@pytest.mark.parametrize("seed", range(3))
def test_indexed_event_queue_pops_as_the_reference(seed):
    """A seeded walk of pushes, cancels, un-cancels and pops: the same
    events in the same order, with the same counts and peeks."""
    kinds = [kernel.FINISH, kernel.RECONFIG, kernel.ARRIVAL, kernel.TICK]
    sides = {}
    for name, pk in (("port", kernel), ("ref", ref_kernel)):
        q, live, log = pk.IndexedEventQueue(), [], []
        r = np.random.default_rng(seed)
        for step in range(600):
            op = int(r.integers(5))
            if op < 2:
                kind = kinds[int(r.integers(4))]
                ev = pk.Event(t=float(r.integers(50)),
                              prio=pk._PRIO[kind], sub=int(r.integers(3)),
                              seq=step, kind=kind, payload=step)
                q.push(ev)
                live.append(ev)
            elif op == 2 and live:
                ev = live[int(r.integers(len(live)))]
                ev.cancelled = not ev.cancelled
            else:
                ev = q.pop()
                log.append(None if ev is None else (ev.t, ev.kind, ev.payload))
            log.append((len(q), q.count(kernel.TICK), q.has(kernel.FINISH),
                        q.next_time(), q.next_time(kernel.ARRIVAL),
                        q.next_finish_for(1)))
        sides[name] = log
    assert sides["port"] == sides["ref"]


@pytest.mark.parametrize("kind", ["baseline", "scheme_a", "scheme_b"])
@pytest.mark.parametrize("workload", ["Ht1", "Ml3", "qwen2"])
def test_simulate_equals_each_shim(kind, workload):
    make, power = mig_h100.make_backend, energy.H100_POWER
    shim = {"baseline": lambda j: policies.run_baseline(j, make(), power),
            "scheme_a": lambda j: policies.run_scheme_a(
                j, make(), power, use_prediction=False, work_steal=True),
            "scheme_b": lambda j: policies.run_scheme_b(
                j, make(), power, use_prediction=True)}[kind]
    spec = api.RunSpec(kind=kind, jobs=fig4.mix(workload), backend=make(),
                       power=power, use_prediction=kind == "scheme_b",
                       work_steal=kind == "scheme_a")
    got = api.simulate(spec)
    assert _metrics(got) == _metrics(shim(fig4.mix(workload)))
    ref = ref_api.simulate(ref_api.RunSpec(
        kind=kind, jobs=_ref_mix(workload), backend=ref_h100.make_backend(),
        power=ref_energy.H100_POWER, use_prediction=kind == "scheme_b",
        work_steal=kind == "scheme_a"))
    assert _metrics(got) == _metrics(ref)


def test_runspec_and_kinds_are_the_reference():
    assert api.KINDS == ref_api.KINDS
    assert [(f.name, f.default) for f in dataclasses.fields(api.RunSpec)] \
        == [(f.name, f.default) for f in dataclasses.fields(ref_api.RunSpec)]


@pytest.mark.parametrize("kind,item", [("cluster", "16e")])
def test_simulate_refuses_the_kinds_not_ported(kind, item):
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        api.simulate(api.RunSpec(kind=kind))


def test_simulate_rejects_an_unknown_kind_as_the_reference():
    for pk in (api, ref_api):
        with pytest.raises(ValueError, match="unknown RunSpec.kind"):
            pk.simulate(pk.RunSpec(kind="schemeB"))


def test_power_models_and_integrator_are_the_reference():
    for name in ("A100_POWER", "H100_POWER", "V5E_CHIP_POWER"):
        assert dataclasses.asdict(getattr(energy, name)) == \
            dataclasses.asdict(getattr(ref_energy, name))
    assert dataclasses.asdict(energy.pod_power_model(16)) == \
        dataclasses.asdict(ref_energy.pod_power_model(16))
    assert events.RECONFIG_COST_S == ref_events.RECONFIG_COST_S
    assert (events.DONE, events.OOM, events.EARLY_RESTART) == (
        ref_events.DONE, ref_events.OOM, ref_events.EARLY_RESTART)
    rng = np.random.default_rng(0)
    steps = [(float(t), float(u)) for t, u in zip(
        np.cumsum(rng.exponential(1.0, 50)), rng.uniform(0, 1.2, 50))]
    sides = []
    for pk in (energy, ref_energy):
        integ = pk.EnergyIntegrator(pk.H100_POWER)
        for i, (t, u) in enumerate(steps):
            # gate for one interval in seven (legal only while idle)
            gate = integ.gated or i % 7 == 6
            integ.advance(t, 0.0 if gate else u)
            if gate:
                integ.set_gated(not integ.gated)
        sides.append((integ.joules, integ.gated_seconds))
    assert sides[0] == sides[1]


# -- the streaming counters ---------------------------------------------------

STREAMS = {
    "normal": lambda r, n: r.normal(10.0, 3.0, n),
    "lognormal": lambda r, n: r.lognormal(0.0, 1.5, n),
    "pareto": lambda r, n: r.pareto(1.2, n),
    "exponential": lambda r, n: r.exponential(2.0, n),
    "sorted": lambda r, n: np.sort(r.uniform(0, 1, n)),
    "ties": lambda r, n: r.integers(0, 4, n).astype(float),
}


@pytest.mark.parametrize("stream", sorted(STREAMS))
@pytest.mark.parametrize("seed", [0, 1])
def test_tail_stats_and_p2_equal_the_reference(stream, seed):
    """The P² markers and the TailStats facade, observation by
    observation, equal the reference's exactly (not statistically)."""
    xs = [float(x) for x in STREAMS[stream](np.random.default_rng(seed),
                                            2000)]
    sides = []
    for pk in (counters, ref_counters):
        est = {q: pk.P2Quantile(q) for q in (0.01, 0.5, 0.9, 0.99)}
        tail = pk.TailStats("lat", quantiles=(0.25, 0.5, 0.95, 0.99))
        exact = pk.TailStats("lat", exact=True)
        trace = []
        for i, x in enumerate(xs):
            for e in est.values():
                e.observe(x)
            tail.observe(x)
            exact.observe(x)
            if i < 40 or i % 97 == 0:
                trace.append(([e.value for e in est.values()],
                              tail.snapshot(), exact.percentile(99)))
        trace.append((tail.snapshot(), exact.snapshot(), tail.mean,
                      tail.count, [e.count for e in est.values()]))
        sides.append(trace)
    assert sides[0] == sides[1]


def test_counter_gauge_and_registry_equal_the_reference():
    sides = []
    for pk in (counters, ref_counters):
        reg = pk.MetricsRegistry()
        rng = np.random.default_rng(4)
        for i in range(300):
            reg.counter("done").inc(float(rng.integers(3)))
            reg.gauge("depth").set(float(rng.normal()))
            reg.tail("ttft").observe(float(rng.exponential()))
            reg.tail("exact", exact=True).observe(float(rng.normal()))
        with pytest.raises(TypeError):
            reg.gauge("done")
        with pytest.raises(ValueError):
            reg.counter("done").inc(-1.0)
        with pytest.raises(KeyError):
            reg.tail("ttft").percentile(42)
        with pytest.raises(ValueError):
            pk.P2Quantile(1.0)
        # the reference's snapshot reads q back as (100 q) / 100, which is
        # not 0.999 at q=0.999: the same KeyError in both packages
        odd = pk.TailStats(quantiles=(0.999,))
        odd.observe(1.0)
        with pytest.raises(KeyError):
            odd.snapshot()
        empty = pk.TailStats()
        sides.append((reg.snapshot(), math.isnan(empty.percentile(50)),
                      empty.mean, pk.SEED_SAMPLES, pk.DEFAULT_QUANTILES))
    assert sides[0] == sides[1]


# -- launch/fig4.py -------------------------------------------------------------


def test_fig4_run_rows_equal_the_reference_benches_rows():
    """The rows' names and values (the general bench's per-call host
    microseconds are timings, so only those are left out)."""
    rows, ref_rows = [], []
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = fig4.run(rows)
    with contextlib.redirect_stdout(io.StringIO()) as ref_out:
        ref_bench_general.run(ref_rows)
        ref_bench_ml.run(ref_rows)
    assert [(n, d) for n, _, d in rows] == [(n, d) for n, _, d in ref_rows]
    assert [u for n, u, _ in rows if not n.startswith("fig4_general")] == [
        u for n, u, _ in ref_rows if not n.startswith("fig4_general")]
    assert len(rows) == 42 and set(got) == set(fig4.WORKLOADS)
    # the printed tables too, but for the card named in each title
    card = ", MigA100Backend + a100-40gb-pcie"
    assert out.getvalue().replace(card, "") == ref_out.getvalue()


def test_fig4_cli_prints_the_h100_tables():
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fig4", "--backend",
         "h100"], cwd=REPO, env={"PYTHONPATH": str(REPO / "src"),
                                 "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "MigH100Backend + h100-80gb-sxm" in res.stdout
    assert "name,us_per_call,derived" in res.stdout
    assert "fig4_llm.mean_thpt_gain_pct" in res.stdout
    assert len(res.stdout.split("name,us_per_call,derived")[1].split()) == 42


# -- chip_smoke.py's pinned phase-7 values ----------------------------------------


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_fig4_pins_equal_the_reference():
    """Phase 7a's pinned table against live ``repro`` at its own relative
    limit (counts exactly), so a stale pin fails here too."""
    cs = _chip_smoke()
    assert set(cs.FIG4_PINNED) == {(c, w) for c in CARDS
                                   for w in fig4.WORKLOADS}
    for card, (_, _, ref_make, ref_power) in CARDS.items():
        for workload in fig4.WORKLOADS:
            ref = _ref_arms(workload, ref_make(), ref_power)
            want = cs.FIG4_PINNED[(card, workload)]
            assert len(want) == len(ref)
            for m, pin in zip(ref.values(), want):
                assert cs.close(m.makespan, pin[0], cs.FIG4_REL)
                assert cs.close(m.energy_j, pin[1], cs.FIG4_REL)
                assert (m.n_oom, m.n_early_restarts, m.n_reconfigs) == \
                    pin[2:], (card, workload)
    hm3 = _ref_arms("Hm3", ref_a100.make_backend(), ref_energy.A100_POWER)
    qwen2 = _ref_arms("qwen2", ref_a100.make_backend(),
                      ref_energy.A100_POWER)
    got = {"Hm3 scheme_a thpt x": hm3["scheme_a"].throughput
           / hm3["baseline"].throughput,
           "Hm3 scheme_a energy x": hm3["baseline"].energy_j
           / hm3["scheme_a"].energy_j,
           "qwen2 predict makespan s": qwen2["A (predict)"].makespan,
           "qwen2 no-predict makespan s": qwen2["A (no predict)"].makespan}
    for key, (want, decimals) in cs.FIG4_HEADLINES.items():
        assert round(got[key], decimals) == want, key


def test_chip_smoke_trace_pins_equal_the_reference(tmp_path):
    """Phase 7b's pinned regret of the traced Hm3 scheme B run, and 7c's
    gate, against the reference's oracle and replay."""
    from repro.core.planner.oracle import BatchOracle, classes_from_jobs
    from repro.obs import Tracer
    from repro.obs.replay import load_replay, trace_regret
    cs = _chip_smoke()
    backend = ref_a100.make_backend()
    tracer = Tracer(meta={"policy": "scheme_b", "mix": cs.TRACE_MIX})
    ref_policies.run_scheme_b(ref_mixes.rodinia_mix(cs.TRACE_MIX), backend,
                              ref_energy.A100_POWER, tracer=tracer)
    tracer.write_jsonl(str(tmp_path / "t.jsonl"))
    reg = trace_regret(load_replay(str(tmp_path / "t.jsonl")),
                       node_budget=cs.ORACLE_NODE_BUDGET)
    graded = [d for d in reg.decisions if d.regret_s is not None]
    got = {"oracle_makespan_s": reg.oracle.makespan_s,
           "oracle_exact": reg.oracle.exact,
           "makespan_regret_s": reg.makespan_regret_s,
           "graded": len(graded),
           "diverged": sum(1 for d in graded if d.diverged),
           "worst_decision_regret_s": max(d.regret_s for d in graded)}
    for key, want in cs.TRACE_PINNED.items():
        if isinstance(want, (bool, int)):
            assert got[key] == want, key
        else:
            assert cs.close(got[key], want, cs.FIG4_REL), key
    for mix in cs.REGRET_MIXES:
        oracle = BatchOracle(backend, classes_from_jobs(
            ref_mixes.rodinia_mix(mix)),
            node_budget=cs.ORACLE_NODE_BUDGET).solve()
        b = ref_policies.run_scheme_b(ref_mixes.rodinia_mix(mix), backend,
                                      ref_energy.A100_POWER)
        base = ref_policies.run_baseline(ref_mixes.rodinia_mix(mix), backend,
                                         ref_energy.A100_POWER)
        assert oracle.makespan_s <= b.makespan <= base.makespan


def test_chip_smoke_phase_7_passes_on_the_host(capsys):
    """Phase 7 needs no card: run it here with every pin and gate."""
    cs = _chip_smoke()
    out = cs.phase_scheduler({}, "NVIDIA H100 80GB HBM3, 700.00 W")
    assert out["trace"]["graded"] == cs.TRACE_PINNED["graded"]
    text = capsys.readouterr().out
    assert "the model's figure" in text and "700.00 W" in text
