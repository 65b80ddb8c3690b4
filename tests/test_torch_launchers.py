"""The port's host launchers of the reference's last two examples,
``launch/llm_memory_prediction.py`` and ``launch/trace_replay.py``,
against the examples themselves run live in this interpreter: the same
printed trajectory, fire and crash iterations and Scheme A metrics, and
the same streamed replay's metrics and per-device summaries."""

import contextlib
import dataclasses
import importlib.util
import io
from pathlib import Path

import pytest

from repro.core.scheduler.kernel import EventKernel as RefKernel
from repro.fleet import (FleetPolicy as RefPolicy,
                         iter_jobs_from_trace as ref_jobs,
                         iter_synthetic_alibaba_rows as ref_rows,
                         make_fleet as ref_fleet, make_router as ref_router)
from repro_torch.launch import llm_memory_prediction, trace_replay

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _example(name: str):
    spec = importlib.util.spec_from_file_location(
        f"ref_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stdout(fn, *args) -> tuple[str, object]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = fn(*args)
    return buf.getvalue(), value


@pytest.fixture(scope="module")
def memory_prediction():
    ref_out, _ = _stdout(_example("llm_memory_prediction").main)
    port_out, run = _stdout(llm_memory_prediction.run)
    return ref_out, port_out, run


def test_memory_prediction_prints_the_examples_lines(memory_prediction):
    ref_out, port_out, _ = memory_prediction
    assert port_out == ref_out


def test_memory_prediction_fire_crash_and_scheme_a(memory_prediction):
    ref_out, _, run = memory_prediction
    assert run["oom_at"] == 94 and run["fired"] == 5
    assert f"crashes on a 10GB slice at iteration {run['oom_at']}" in ref_out
    assert f"   {run['fired']} ^^^ PREDICTED OOM" in ref_out
    no_pred, pred = run["no_pred"], run["pred"]
    assert (round(no_pred.makespan, 1), round(pred.makespan, 1)) == \
        (365.1, 159.5)
    assert f"{no_pred.makespan / pred.makespan:.2f}x faster" == "2.29x faster"
    assert f"{no_pred.energy_j / pred.energy_j:.2f}x" == "1.91x"
    assert (no_pred.n_oom, pred.n_early_restarts) == (1, 1)


def test_memory_prediction_cli(capsys):
    assert llm_memory_prediction.main([]) == 0
    assert "2.29x faster, 1.91x less energy" in capsys.readouterr().out


def _ref_replay(events: int, seed: int = 11, rate: float = 6.5):
    fleet = ref_fleet(["a100"] * 6 + ["h100"] * 6, record_runs=False)
    kernel = RefKernel(fleet, RefPolicy(ref_router("energy_aware",
                                                   seed=seed)))
    metrics = kernel.run(ref_jobs(ref_rows(events // 2, seed=seed,
                                           rate_per_s=rate)), stream=True)
    return kernel, metrics


def test_trace_replay_equals_the_reference_event_kernel():
    ref_kernel, ref_metrics = _ref_replay(10_000)
    kernel, metrics, seconds = trace_replay.replay(10_000)
    assert seconds > 0
    assert (kernel.n_jobs_seen, kernel.n_events) == \
        (ref_kernel.n_jobs_seen, ref_kernel.n_events)
    assert metrics.summary() == ref_metrics.summary()
    assert [d.summary() for d in metrics.per_device] == \
        [d.summary() for d in ref_metrics.per_device]
    assert dataclasses.asdict(metrics.per_device[0]) == \
        dataclasses.asdict(ref_metrics.per_device[0])


def test_trace_replay_cli_streams_a_trace(tmp_path, capsys):
    sink = tmp_path / "replay.jsonl"
    assert trace_replay.main(["--events", "400", "--trace", str(sink),
                              "--memstats"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("replayed 200 jobs / ")
    assert "events/s" in out and "tracemalloc peak" in out
    assert sink.stat().st_size > 0
