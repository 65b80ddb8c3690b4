"""The port's flight recorder and regret oracle against the reference.

A traced run of each batch policy files the same JSONL records, byte for
byte, and the same Chrome trace as the reference's; the JSONL round trip
and its refusals, the audit codecs, the replayed decision points, the
trace regret and the report equal the reference's; ``BatchOracle.solve``
and ``admissible_lower_bound_s`` equal the reference's on fixed small
mixes (the mix that outran the reference's own hypothesis deadline among
them), at a node budget of at most 200,000.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
from pathlib import Path

import pytest

import benchmarks.mixes as ref_mixes
import repro.core.planner as ref_planner
import repro.core.planner.oracle as ref_oracle
import repro.core.scheduler.policies as ref_policies
import repro.obs as ref_obs
import repro.obs.audit as ref_audit
import repro.obs.replay as ref_replay
import repro.obs.report as ref_report
from repro.core import mig_a100 as ref_a100
from repro.core import mig_h100 as ref_h100
from repro.core.partition_manager import PartitionManager as RefManager
from repro.core.partition_state import enumerate_states as ref_states
from repro.core.scheduler import energy as ref_energy
from repro.core.scheduler.job import rodinia_job as ref_rodinia_job
import repro_torch.core.planner as planner
import repro_torch.core.planner.oracle as oracle
import repro_torch.core.scheduler.policies as policies
import repro_torch.obs as obs
import repro_torch.obs.audit as audit
import repro_torch.obs.replay as replay
import repro_torch.obs.report as report
from repro_torch.core import mig_a100, mig_h100
from repro_torch.core.partition_manager import PartitionManager
from repro_torch.core.partition_state import enumerate_states
from repro_torch.core.scheduler import energy
from repro_torch.core.scheduler.job import rodinia_job
from repro_torch.launch import fig4

REPO = Path(__file__).resolve().parents[1]

#: side -> card -> (backend factory, power model)
SIDES = {
    "port": {"a100": (mig_a100.make_backend, energy.A100_POWER),
             "h100": (mig_h100.make_backend, energy.H100_POWER)},
    "ref": {"a100": (ref_a100.make_backend, ref_energy.A100_POWER),
            "h100": (ref_h100.make_backend, ref_energy.H100_POWER)},
}
PKG = {"port": (policies, obs, fig4.mix),
       "ref": (ref_policies, ref_obs, None)}
#: the traced arms: (policy, kwargs)
ARMS = {"baseline": ("run_baseline", {}),
        "scheme_a": ("run_scheme_a", {"use_prediction": True}),
        "scheme_b": ("run_scheme_b", {"use_prediction": True})}
NODE_BUDGET = 200_000


def _ref_mix(workload):
    if workload in ref_mixes.RODINIA_MIXES:
        return ref_mixes.rodinia_mix(workload)
    if workload in ref_mixes.ML_MIXES:
        return ref_mixes.ml_mix(workload)
    return ref_mixes.llm_mix(workload)


def _traced(side, card, arm, workload, sink=None):
    pol, pobs, mix = PKG[side]
    make, power = SIDES[side][card]
    fn, kwargs = ARMS[arm]
    tracer = pobs.Tracer(meta={"policy": arm, "mix": workload}, sink=sink)
    with tracer:
        m = getattr(pol, fn)((mix or _ref_mix)(workload), make(), power,
                             tracer=tracer, **kwargs)
    untraced = getattr(pol, fn)((mix or _ref_mix)(workload), make(), power,
                                **kwargs)
    return tracer, m, untraced


@pytest.mark.parametrize("card", ["a100", "h100"])
@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("workload", ["Hm3", "Ht1", "Ml1", "qwen2"])
def test_a_traced_run_files_the_reference_records(card, arm, workload,
                                                  tmp_path):
    """The same records, header and JSONL bytes as the reference's traced
    run, the same Chrome trace, and Metrics unperturbed by the tracer."""
    tracer, m, untraced = _traced("port", card, arm, workload)
    ref_tracer, ref_m, _ = _traced("ref", card, arm, workload)
    assert dataclasses.asdict(m) == dataclasses.asdict(untraced)
    assert dataclasses.asdict(m) == dataclasses.asdict(ref_m)
    assert tracer.records == ref_tracer.records
    assert tracer.header() == ref_tracer.header()
    kinds = {r["type"] for r in tracer.records}
    assert {"job", "span"} <= kinds
    assert ("audit" in kinds) == (arm == "scheme_b")
    tracer.write_jsonl(str(tmp_path / "port.jsonl"))
    ref_tracer.write_jsonl(str(tmp_path / "ref.jsonl"))
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
    meta = tracer.meta
    assert obs.to_chrome_trace(tracer.records, meta) == \
        ref_obs.to_chrome_trace(ref_tracer.records, meta)
    obs.write_chrome_trace(str(tmp_path / "port.json"), tracer.records, meta)
    ref_obs.write_chrome_trace(str(tmp_path / "ref.json"),
                               ref_tracer.records, meta)
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "ref.json").read_bytes()


@pytest.mark.parametrize("card", ["a100", "h100"])
def test_a_streamed_trace_equals_the_reference_stream(card, tmp_path):
    """``sink=``: records go to disk as emitted, the final meta in a
    trailing record that read_jsonl folds back; the bytes are the
    reference's and each package reads the other's file."""
    port, ref = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    tracer, _, _ = _traced("port", card, "scheme_b", "Ht3", sink=port)
    _traced("ref", card, "scheme_b", "Ht3", sink=ref)
    assert tracer.records == []
    assert Path(port).read_bytes() == Path(ref).read_bytes()
    with pytest.raises(RuntimeError, match="streaming tracer"):
        tracer.write_jsonl(str(tmp_path / "again.jsonl"))
    header, records = obs.read_jsonl(port)
    assert (header, records) == ref_obs.read_jsonl(port) == \
        obs.read_jsonl(ref)
    assert header["meta"]["t_end"] > 0 and records
    assert all(r["type"] != "meta" for r in records)


def test_jsonl_round_trip_and_refusals(tmp_path):
    tracer = obs.Tracer(meta={"run": 1})
    tracer.bind_clock(lambda: 2.5)
    tracer.span(0.0, 1.5, "job:0", device="d", lane="1g#0", cat="run",
                outcome="done")
    tracer.instant("oom", device="d", job="job:0")
    tracer.counter("queue", 3.0)
    tracer.emit({"type": "job", "name": "job:0"})
    tracer.audit({"type": "audit", "t": 1.0, "chosen": None})
    tracer.finish(4.0)
    path = tmp_path / "t.jsonl"
    assert tracer.write_jsonl(str(path)) == 5
    header, records = obs.read_jsonl(str(path))
    assert records == tracer.records
    assert header == {"schema": "repro.obs.trace", "schema_version": 1,
                      "meta": {"run": 1, "t_end": 4.0}}
    assert records[1]["t"] == 2.5 and records[2]["t"] == 2.5
    lines = path.read_text().splitlines()
    bad = [("stale.jsonl", json.dumps({**header, "schema_version": 99})),
           ("foreign.jsonl", json.dumps({"hello": 1})),
           ("empty.jsonl", "")]
    for name, first in bad:
        (tmp_path / name).write_text("\n".join([first, *lines[1:]]))
        for pk in (obs, ref_obs):
            with pytest.raises(ValueError):
                pk.read_jsonl(str(tmp_path / name))
        assert report.main([str(tmp_path / name)]) == 2
    assert report.main([str(tmp_path / "missing.jsonl")]) == 2


def _all_states(side, card):
    make = SIDES[side][card][0]
    return (enumerate_states if side == "port" else ref_states)(make())


@pytest.mark.parametrize("card", ["a100", "h100"])
def test_audit_codecs_equal_the_reference(card):
    states = _all_states("port", card)
    assert states == _all_states("ref", card)
    for state in states:
        enc = audit.encode_state(state)
        assert enc == ref_audit.encode_state(state)
        assert audit.decode_state(json.loads(json.dumps(enc))) == state
        for handle in state:
            h = audit.encode_handle(handle)
            assert h == ref_audit.encode_handle(handle)
            assert audit.decode_handle(json.loads(json.dumps(h))) == handle
    for odd in ("pod", ("a", 1), 7):
        assert audit.encode_handle(odd) == ref_audit.encode_handle(odd)
        assert audit.decode_handle(odd) == ref_audit.decode_handle(odd)
        assert audit.encode_state(odd) == ref_audit.encode_state(odd)
        assert audit.decode_state(odd) == ref_audit.decode_state(odd)


def test_deciding_tiers_and_labels_equal_the_reference():
    for name in ("SCHEME_B_COST", "SERVING_GROW_COST", "SERVING_SHRINK_COST",
                 "BEST_FIT_DEVICE_COST", "ENERGY_AWARE_DEVICE_COST",
                 "PRICE_GREEDY_ZONE_COST", "FOLLOW_THE_SUN_ZONE_COST"):
        assert audit.tier_labels(getattr(planner, name)) == \
            ref_audit.tier_labels(getattr(ref_planner, name))
    for a, b in (((1, 2, 3), (1, 2, 4)), ((0,), (0,)), ((2, 0), (1, 0))):
        assert audit.deciding_tier_from_costs(a, b) == \
            ref_audit.deciding_tier_from_costs(a, b)
    for pk in (audit, ref_audit):
        with pytest.raises(ValueError, match="cost-tuple length"):
            pk.deciding_tier_from_costs((1, 2), (1,))


@pytest.mark.parametrize("card", ["a100", "h100"])
@pytest.mark.parametrize("seed", range(3))
def test_plan_audit_records_equal_the_reference(card, seed):
    """A seeded walk of places and frees: each plan's audit record, built
    directly by ``plan_audit_record`` and through JSON, is the
    reference's, and decodes back to the live state and handles."""
    import numpy as np
    rng = np.random.default_rng(seed)
    walk = [(float(rng.uniform(0.5, 80.0)), bool(rng.integers(2)))
            for _ in range(14)]
    sides = {}
    for side, pk, apk, manager in (("port", planner, audit, PartitionManager),
                                   ("ref", ref_planner, ref_audit,
                                    RefManager)):
        backend = SIDES[side][card][0]()
        pm = manager(backend)
        plnr = pk.PartitionPlanner(pm, pk.SCHEME_B_COST)
        held, recs = [], []
        for t, (need, free) in enumerate(walk):
            if free and held:
                done = held.pop(0)
                done.busy = False
                pm.release(done)
            plan = plnr.plan(pk.place_request(
                backend, min(need, backend.total_mem_gb()), 0.5, 1.0))
            rec = apk.plan_audit_record(plan, t=float(t), device="d",
                                        owner="o", state=pm.state,
                                        backend=backend)
            assert audit.decode_state(rec["state"]) == pm.state
            recs.append(json.dumps(rec))
            res = plnr.execute(plan)
            if res is not None and res.partition is not None:
                res.partition.busy = True
                held.append(res.partition)
        sides[side] = recs
    assert sides["port"] == sides["ref"]


def _trace_file(side, card, arm, workload, tmp_path):
    tracer, _, _ = _traced(side, card, arm, workload)
    path = str(tmp_path / f"{side}-{card}-{arm}-{workload}.jsonl")
    tracer.write_jsonl(path)
    return path


def _regret(reg):
    out = dataclasses.asdict(reg)
    out["decisions"] = [dataclasses.asdict(d) for d in reg.decisions]
    return out


@pytest.mark.parametrize("card,workload,arm", [
    ("a100", "Hm3", "scheme_b"), ("h100", "Hm3", "scheme_b"),
    ("a100", "Ht1", "scheme_b"), ("h100", "Ht1", "scheme_b"),
    ("a100", "Hm4", "scheme_b"), ("a100", "Hm3", "scheme_a"),
    ("h100", "Hm1", "baseline")])
def test_trace_regret_equals_the_reference(card, workload, arm, tmp_path):
    """Replay, decision points and the graded regret of one traced run:
    the port's on its own trace equal the reference's on its trace, and
    each package grades the other's file the same way."""
    port = _trace_file("port", card, arm, workload, tmp_path)
    ref = _trace_file("ref", card, arm, workload, tmp_path)
    rp, rr = replay.load_replay(port), ref_replay.load_replay(ref)
    assert (rp.header, rp.records, rp.jobs, rp.audits) == (
        rr.header, rr.records, rr.jobs, rr.audits)
    assert [dataclasses.asdict(r) for r in rp.runs] == [
        dataclasses.asdict(r) for r in rr.runs]
    assert rp.backend_name() == rr.backend_name()
    assert type(rp.backend()).__name__ == type(rr.backend()).__name__
    points = replay.decision_points(rp)
    assert [dataclasses.asdict(p) for p in points] == [
        dataclasses.asdict(p) for p in ref_replay.decision_points(rr)]
    reg = replay.trace_regret(rp, node_budget=NODE_BUDGET)
    want = _regret(ref_replay.trace_regret(rr, node_budget=NODE_BUDGET))
    assert _regret(reg) == want
    assert _regret(replay.trace_regret(replay.load_replay(ref),
                                       node_budget=NODE_BUDGET)) == want
    # only the planner's audits name the backend, so only scheme B's
    # trace is replayable against the oracle (as in the reference)
    assert (arm == "scheme_b") == bool(points) == (reg.oracle is not None)
    if reg.oracle is not None:
        assert reg.makespan_regret_s >= -1e-6
        assert all(d.regret_s is None or d.regret_s >= -1e-9
                   for d in reg.decisions)


def test_report_renders_as_the_reference(tmp_path):
    path = _trace_file("port", "a100", "scheme_b", "Hm3", tmp_path)
    header, records = obs.read_jsonl(path)
    assert report.render(header, records, top_k=3) == \
        ref_report.render(header, records, top_k=3)
    for limit in (None, 20):
        assert report.render_regret(path, node_budget=NODE_BUDGET,
                                    attribution_limit=limit) == \
            ref_report.render_regret(path, node_budget=NODE_BUDGET,
                                     attribution_limit=limit)
    chrome = tmp_path / "c.json"
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert report.main([path, "--regret", "--node-budget",
                            str(NODE_BUDGET), "--chrome", str(chrome)]) == 0
    with contextlib.redirect_stdout(io.StringIO()) as ref_out:
        assert ref_report.main([path, "--regret", "--node-budget",
                                str(NODE_BUDGET), "--chrome",
                                str(tmp_path / "r.json")]) == 0
    assert out.getvalue().replace(str(chrome), str(tmp_path / "r.json")) \
        == ref_out.getvalue()
    assert chrome.read_bytes() == (tmp_path / "r.json").read_bytes()


def test_report_cli_runs(tmp_path):
    path = _trace_file("port", "h100", "scheme_b", "Ht1", tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", path, "--regret",
         "--top-k", "2"], cwd=REPO,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "regret vs offline oracle" in res.stdout
    assert "MigH100Backend" in res.stdout


# -- the oracle -------------------------------------------------------------------

#: fixed small mixes, (job, count) pairs as the reference's own property
#: test draws them; the first is the draw that outran its deadline
MIXES = [
    [("myocyte", 1), ("myocyte", 1), ("gaussian", 3)],
    [("myocyte", 4), ("gaussian", 2)],
    [("srad", 2), ("particlefilter", 3)],
    [("gaussian", 2), ("srad", 2)],
    [("particlefilter", 2), ("myocyte", 3)],
    [("euler3d", 3)],
    [("myocyte", 20)],
    [("cfd_full", 2), ("myocyte", 3)],
]


def _jobs(make_job, mix):
    return [make_job(name, i) for name, count in mix for i in range(count)]


def _result(r):
    return dataclasses.asdict(r)


@pytest.mark.parametrize("card", ["a100", "h100"])
@pytest.mark.parametrize("mix", MIXES, ids=lambda m: "+".join(
    f"{n}{c}" for n, c in m))
def test_oracle_and_bound_equal_the_reference(card, mix):
    backend, ref_backend = (SIDES["port"][card][0](),
                            SIDES["ref"][card][0]())
    classes = oracle.classes_from_jobs(_jobs(rodinia_job, mix))
    ref_classes = ref_oracle.classes_from_jobs(_jobs(ref_rodinia_job, mix))
    assert [_result(c) for c in classes] == [_result(c) for c in ref_classes]
    bound = oracle.admissible_lower_bound_s(backend, classes)
    assert bound == ref_oracle.admissible_lower_bound_s(ref_backend,
                                                        ref_classes)
    for n in (2, 3):
        assert oracle.admissible_lower_bound_s(backend, classes, n) == \
            ref_oracle.admissible_lower_bound_s(ref_backend, ref_classes, n)
    port = oracle.BatchOracle(backend, classes, node_budget=NODE_BUDGET)
    ref = ref_oracle.BatchOracle(ref_backend, ref_classes,
                                 node_budget=NODE_BUDGET)
    result = port.solve()
    assert _result(result) == _result(ref.solve())
    assert port.durations == ref.durations
    if result.exact:
        assert bound <= result.makespan_s + 1e-9
        node = port.initial_node()
        assert port.describe_action(port.best_action(node)) == \
            ref.describe_action(ref.best_action(ref.initial_node()))
    for power in ("A100_POWER", "H100_POWER"):
        assert oracle.energy_lower_bound_j(
            getattr(energy, power), classes, result.makespan_s) == \
            ref_oracle.energy_lower_bound_j(getattr(ref_energy, power),
                                            ref_classes, result.makespan_s)
    assert _result(oracle.solve_batch_oracle(
        backend, _jobs(rodinia_job, mix), node_budget=NODE_BUDGET)) == \
        _result(result)


def test_oracle_budget_and_infeasible_jobs_as_the_reference():
    for pk, make, job in ((oracle, mig_a100.make_backend, rodinia_job),
                          (ref_oracle, ref_a100.make_backend,
                           ref_rodinia_job)):
        small = pk.solve_batch_oracle(make(), _jobs(job, [("myocyte", 9)]),
                                      node_budget=5)
        assert not small.exact and small.makespan_s == small.bound_s
        big = job("cfd_full", 0)
        big.mem_gb = 90.0
        with pytest.raises(ValueError, match="fit no profile"):
            pk.BatchOracle(make(), pk.classes_from_jobs([big]))
        with pytest.raises(ValueError, match="fit no profile"):
            pk.admissible_lower_bound_s(make(), pk.classes_from_jobs([big]))
    assert oracle.DEFAULT_NODE_BUDGET == ref_oracle.DEFAULT_NODE_BUDGET


def test_classes_from_specs_equal_the_reference():
    jobs = fig4.mix("Ht3") + fig4.mix("flan_t5")
    tracer = obs.Tracer()
    policies.run_scheme_b(jobs, mig_h100.make_backend(), energy.H100_POWER,
                          tracer=tracer)
    specs = [r for r in tracer.records if r["type"] == "job"]
    got = oracle.classes_from_specs(specs)
    assert [_result(c) for c in got] == [
        _result(c) for c in ref_oracle.classes_from_specs(specs)]
    assert sum(c.count for c in got) == len(jobs)


def test_grow_wait_sequence_bound_equals_the_reference():
    """The serving grow/wait beam bound on the audits a traced planner
    files for a growing engine."""
    sides = []
    for pk, make, manager, pobs, pk_oracle in (
            (planner, mig_h100.make_backend, PartitionManager, obs, oracle),
            (ref_planner, ref_h100.make_backend, RefManager, ref_obs,
             ref_oracle)):
        backend = make()
        pm = manager(backend)
        plnr = pk.PartitionPlanner(pm, pk.SCHEME_B_COST)
        tracer = pobs.Tracer()
        plnr.tracer, plnr.owner = tracer, "h100-0"
        engine = pm.allocate(backend.profiles[0])
        engine.busy = True
        for prob in (0.0, 0.2, 0.6, 0.9, 0.3, 1.0):
            res = plnr.place(pk.grow_request(
                backend, engine, None, 0.3, reconfig_cost_s=0.3,
                queue_depth=2.0, slo_violation_prob=prob, allow_stay=True,
                needed_compute=0.5), pk.SERVING_GROW_COST)
            engine = res.partition
            engine.busy = True
        audits = [r for r in tracer.records if r["type"] == "audit"]
        bounds = [dataclasses.asdict(pk_oracle.grow_wait_sequence_bound(
            audits, beam_width=w)) for w in (1, 8)]
        sides.append((json.dumps(audits), bounds))
    assert sides[0] == sides[1]
    assert oracle.grow_wait_sequence_bound(
        [{"type": "audit", "model": "scheme_b"}]) is None
