"""The serving engine's spans and counters (``repro_torch.obs.trace``'s
``wall_span`` in ``ServeEngine.run``), on the CPU with the engine tests'
smoke weights: the spans under ``torch.profiler`` on its own clock, the
same spans in a wall ``Tracer``, nothing entered when neither records,
the counters against the batch's arithmetic, the restart instant at the
reference's step; ``launch/serve.py --trace``; and the profile launchers'
busy time as a union of intervals."""

import json
import time

import numpy as np
import pytest
import torch
from test_torch_engine import (_pair_requests, _prompts, _series_close,
                               weights)  # noqa: F401  (the fixture)

from repro.core.mig_h100 import MigH100Backend as RefMigH100Backend
from repro.core.restart import NeedsLargerPartition as RefNeedsLargerPartition
from repro.serving import engine as ref_engine
from repro_torch.core.mig_h100 import MigH100Backend
from repro_torch.core.restart import NeedsLargerPartition
from repro_torch.launch import profile_serve, serve as serve_mod
from repro_torch.obs.trace import Tracer
from repro_torch.serving.engine import (SPAN, EngineConfig, Request,
                                        ServeEngine)

STEP_STAGES = ("launch", "sync", "tokens", "memory")
MAX_NEW = (3, 5, 4)


def _requests():
    rng = np.random.default_rng(7)
    return [Request(uid=i, prompt=rng.integers(0, 200, 4 + 2 * i
                                               ).astype(np.int32),
                    max_new_tokens=n) for i, n in enumerate(MAX_NEW)]


def _engine(p, cfg, tracer=None):
    return ServeEngine(cfg, p, EngineConfig(max_batch=3, max_context=64,
                                            partition_gb=1e3, predict=True),
                       device="cpu", tracer=tracer)


def _profiled(engine):
    """Run the batch under the profiler, inside a caller's own range;
    returns (requests, the engine's spans and the caller's as (name,
    start_ns, end_ns) by start, the time.time_ns() readings around)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        before = time.time_ns()
        with torch.profiler.record_function("caller"):
            out = engine.run(_requests())
        after = time.time_ns()
    spans = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(SPAN) or e.name() == "caller"),
                   key=lambda s: s[1])
    return out, spans, (before, after)


def test_profiled_run_has_one_span_of_each_stage_a_step_nested(weights):
    _, _, cfg, p = weights
    out, spans, (before, after) = _profiled(_engine(p, cfg))
    names = [n[len(SPAN):] for n, _, _ in spans if n != "caller"]
    steps = max(MAX_NEW)
    assert names == (["run", "capture", "prefill"]
                     + list(STEP_STAGES) * steps)
    (_, c0, c1), = [s for s in spans if s[0] == "caller"]
    (_, r0, r1), = [s for s in spans if s[0] == SPAN + "run"]
    assert c0 <= r0 and r1 <= c1
    for name, s, e in spans:
        assert before <= s <= e <= after, name
        assert name == "caller" or r0 <= s and e <= r1, name
    assert [len(r.generated) for r in out] == list(MAX_NEW)


def test_tracer_records_are_the_profilers_spans(weights):
    _, _, cfg, p = weights
    tracer = Tracer.wall()
    assert tracer.meta["clock"] == "time_ns"
    _, spans, _ = _profiled(_engine(p, cfg, tracer))
    theirs = [s for s in spans if s[0] != "caller"]
    mine = sorted((r for r in tracer.records if r["type"] == "span"),
                  key=lambda r: r["t0"])
    assert [r["name"] for r in mine] == [n for n, _, _ in theirs]
    origin = tracer.meta["origin_ns"]
    slack = 50_000    # ns: the profiler's clock conversion
    for r, (_, s, e) in zip(mine, theirs):
        assert s - slack <= origin + r["t0"] * 1e9
        assert origin + r["t1"] * 1e9 <= e + slack
    run = mine[0]
    assert run["args"] == {"batch": 3, "padded": 8, "prompt_tokens": 18}


def test_untraced_run_enters_no_range_and_computes_the_same(weights,
                                                            monkeypatch):
    _, _, cfg, p = weights
    traced = _engine(p, cfg, Tracer.wall())
    want, _, _ = _profiled(traced)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered untraced")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    plain = _engine(p, cfg)
    got = plain.run(_requests())
    assert [r.generated for r in got] == [r.generated for r in want]
    assert plain.accountant.history == traced.accountant.history
    assert plain.predictor.req_mem_list == traced.predictor.req_mem_list
    assert (plain.predictor.reuse_ratio_list
            == traced.predictor.reuse_ratio_list)


def test_traced_engine_matches_the_reference(weights):
    """``test_torch_engine``'s parity test, with a tracer and a profiler
    on."""
    from torch.profiler import ProfilerActivity, profile
    ref_cfg, ref_p, cfg, p = weights
    ref_reqs, reqs = _pair_requests(_prompts(3, 3, cfg.vocab), 10)
    ecfg = dict(max_batch=3, max_context=64, predict=False)
    ref_eng = ref_engine.ServeEngine(ref_cfg, ref_p,
                                     ref_engine.EngineConfig(**ecfg))
    ref_out = ref_eng.run(ref_reqs)
    eng = ServeEngine(cfg, p, EngineConfig(**ecfg), device="cpu",
                      tracer=Tracer.wall())
    with profile(activities=[ProfilerActivity.CPU]):
        out = eng.run(reqs)
    assert [r.generated for r in out] == [r.generated for r in ref_out]
    _series_close(eng.accountant, ref_eng.accountant)


def test_counters_are_the_batchs_arithmetic(weights):
    _, _, cfg, p = weights
    tracer = Tracer.wall()
    engine = _engine(p, cfg, tracer)
    reqs = _requests()
    engine.run(reqs)
    counters = {r["name"][len(SPAN):]: r["value"] for r in tracer.records
                if r["type"] == "counter"}
    b, steps = len(reqs), max(MAX_NEW)
    padded = max(len(r.prompt) for r in reqs)
    assert counters == {
        "padding_tokens": b * padded - sum(len(r.prompt) for r in reqs),
        "decode_row_steps": steps * b,
        "decode_rows_done": steps * b - sum(MAX_NEW),
        "accountant_peak_bytes": engine.accountant.peak_in_use,
        "restarts": 0}


def test_restart_instant_once_at_the_references_step(weights):
    ref_cfg, ref_p, cfg, p = weights
    ecfg = dict(max_batch=1, max_context=96, partition_gb=1e-4, predict=True)
    prompt = np.arange(4, dtype=np.int32)
    ref_eng = ref_engine.ServeEngine(ref_cfg, ref_p,
                                     ref_engine.EngineConfig(**ecfg),
                                     backend=RefMigH100Backend())
    with pytest.raises(RefNeedsLargerPartition) as ref_exc:
        ref_eng.run([ref_engine.Request(uid=0, prompt=prompt,
                                        max_new_tokens=80)])
    tracer = Tracer.wall()
    eng = ServeEngine(cfg, p, EngineConfig(**ecfg), backend=MigH100Backend(),
                      device="cpu", tracer=tracer)
    with pytest.raises(NeedsLargerPartition):
        eng.run([Request(uid=0, prompt=prompt, max_new_tokens=80)])
    restarts = [r for r in tracer.records if r["type"] == "instant"]
    assert [r["name"] for r in restarts] == [SPAN + "restart"]
    # the prefill is iteration 0 of the history, decode step k iteration k+1
    assert restarts[0]["args"]["step"] == len(ref_eng.accountant.history) - 2
    assert restarts[0]["args"]["target"] == ref_exc.value.profile.name
    assert restarts[0]["args"]["peak_gib"] > ecfg["partition_gb"]
    memory = [r for r in tracer.records if r["name"] == SPAN + "memory"]
    assert len(memory) == restarts[0]["args"]["step"] + 1
    assert [r["value"] for r in tracer.records
            if r["name"] == SPAN + "restarts"] == [1]


def test_serve_trace_writes_both_traces_and_the_summary(tmp_path, capsys):
    path = tmp_path / "serve.jsonl"
    serve_mod.main(["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu",
                    "--requests", "2", "--max-new", "6",
                    "--partition-gb", "0.0001", "--trace", str(path)])
    out = capsys.readouterr().out
    line, = [x for x in out.splitlines() if x.startswith("[serve] trace:")]
    assert "restarts 1" in line and "ttft " in line
    assert "accountant/allocator peak n/a" in line   # no allocator here
    _, records = serve_mod.read_jsonl(str(path))
    summary = serve_mod.trace_summary(records)
    assert summary["restarts"] == 1 and summary["padding_share"] == 0.0
    assert summary["done_row_share"] == 0.0
    assert summary["ttft_ms"] > 0 and summary["gap_p90_ms"] > 0
    assert set(summary["host_ms_per_step"]) == set(STEP_STAGES)
    chrome = json.loads((tmp_path / "serve.chrome.json").read_text())
    assert {e["name"] for e in chrome["traceEvents"]} >= {
        SPAN + "run", SPAN + "restart", SPAN + "padding_tokens"}


@pytest.mark.parametrize("ranges,ms", [
    ([(0.0, 10.0), (5.0, 15.0)], 0.015),
    ([(5.0, 15.0), (0.0, 10.0), (20.0, 21.0)], 0.016),
    ([(0.0, 30.0), (5.0, 15.0)], 0.030),
    ([], 0.0)])
def test_profile_busy_time_counts_overlapping_kernels_once(ranges, ms):
    assert profile_serve.busy_ms(ranges) == pytest.approx(ms)
