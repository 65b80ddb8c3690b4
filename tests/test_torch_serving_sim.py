"""The port's request-level LLM serving simulator against the reference, on
the CPU: both SLO gauges observation by observation, every ServingConfig
arm of the reference's serving and SLO benches on both devices, the
multi-device and admission-gated runs, ``api.simulate`` kind ``serving``,
the ``serving`` package's exports and ``launch/serving_sim.py``.

Host code on both sides: every comparison is against live ``repro`` in
this interpreter, with ``==``, on about 40 requests (the reference bench's
300 take ~45 s); the reference's own goldens for this simulator fail on
Python 3.12 (its tests/test_kernel_parity.py), so they are not used."""

import dataclasses

import pytest

from repro import api as ref_api
from repro import serving as ref_serving
from repro.core.memory.timeseries import \
    PeakMemoryPredictor as RefPeakMemoryPredictor
from repro.core.scheduler.admission import \
    AdmissionController as RefAdmissionController
from repro.obs import Tracer as RefTracer
from repro.serving import sim as ref_sim
from repro.serving import slo as ref_slo
from repro_torch import api, serving
from repro_torch.core.memory.timeseries import PeakMemoryPredictor
from repro_torch.core.scheduler.admission import AdmissionController
from repro_torch.obs import Tracer
from repro_torch.serving import sim, slo

GB = 1024 ** 3
#: the reference benches' arms: bench_serving's four, then bench_slo's
#: SLO-aware growth, with scale-down, and the exact-quantile path
ARMS = {
    "full": dict(policy="full"),
    "static": dict(policy="static", n_engines=2),
    "dynamic": dict(policy="dynamic", n_engines=2, use_prediction=False,
                    gauge="queue_ticks"),
    "dynamic+pred": dict(policy="dynamic", n_engines=2, use_prediction=True,
                         gauge="queue_ticks"),
    "dynamic+slo+pred": dict(policy="dynamic", n_engines=2),
    "dynamic+slo+shrink+pred": dict(policy="dynamic", n_engines=2,
                                    scale_down_ticks=30),
    "exact_quantiles": dict(policy="dynamic", n_engines=2,
                            exact_quantiles=True),
}
N_REQUESTS, RATE, SEED = 40, 2.0, 11


def _serving_metrics(m):
    """Every field of a ServingMetrics and its derived properties."""
    return (dataclasses.asdict(m), m.energy_per_token, m.goodput_fraction,
            m.summary())


def _requests(pkg, n=N_REQUESTS, rate=RATE, seed=SEED):
    return pkg.poisson_requests(n, rate_per_s=rate, seed=seed)


def test_exports_are_the_reference():
    """The package exports the reference's names, the engine's three
    resolved lazily from the torch engine module."""
    assert serving.__all__ == ref_serving.__all__
    for name in serving.__all__:
        obj = getattr(serving, name)
        assert obj.__module__.startswith("repro_torch.serving."), name
    from repro_torch.serving import engine
    assert serving.ServeEngine is engine.ServeEngine
    with pytest.raises(AttributeError, match="no attribute"):
        serving.NotAName


def test_model_and_config_defaults_are_the_reference():
    assert dataclasses.asdict(sim.LLMServingModel()) == \
        dataclasses.asdict(ref_sim.LLMServingModel())
    assert dataclasses.asdict(sim.ServingConfig()) == \
        dataclasses.asdict(ref_sim.ServingConfig())
    for kw in ARMS.values():
        assert sim.ServingConfig(**kw).name == ref_sim.ServingConfig(**kw).name
    assert slo.RISK_RAMP_START == ref_slo.RISK_RAMP_START


@pytest.mark.parametrize("kind", ["poisson", "diurnal"])
def test_request_generators_equal_the_reference(kind):
    if kind == "poisson":
        got, want = _requests(sim, 200), _requests(ref_sim, 200)
    else:
        kw = dict(n=200, peak_rate_per_s=3.0, trough_rate_per_s=0.2,
                  period_s=120.0, seed=4)
        got, want = sim.diurnal_requests(**kw), ref_sim.diurnal_requests(**kw)
    assert [dataclasses.asdict(r) for r in got] == \
        [dataclasses.asdict(r) for r in want]


# -- the gauges -----------------------------------------------------------------


@dataclasses.dataclass
class FakeEngine:
    """What a gauge reads of an engine."""
    cfg: object
    model: object
    compute: float
    running: list
    waiting: list
    predictor: object
    part_bytes: float = 10 * GB
    last_prediction: object = None
    migrating: bool = False


def _engines(pkg, predictor):
    """One engine's iterations as (time, engine) on ``pkg``'s classes: a
    queue that builds and ages, a batch whose sequences grow, a predictor
    fed a growing series, then a drained, idle engine."""
    cfg, model = pkg.ServingConfig(), pkg.LLMServingModel()
    pred = predictor(max_iter=96)
    out = []
    for it in range(40):
        t = 0.5 * it
        running = []
        for i in range(min(it, cfg.max_batch)):
            r = pkg.ServingRequest(rid=i, arrival=0.1 * i, prompt_tokens=256,
                                   decode_tokens=160)
            r.generated = min(it * 4, 159)
            r.in_prefill = False
            running.append(r)
        waiting = [pkg.ServingRequest(rid=100 + i, arrival=t - 0.3 * i,
                                      prompt_tokens=512, decode_tokens=64)
                   for i in range(max(0, it - 10))] if it < 30 else []
        last = pred.observe((4.0 + 0.2 * it) * GB, 0.5)
        out.append((t, FakeEngine(cfg, model, 0.5 if it < 20 else 1.0,
                                  running, waiting, pred,
                                  last_prediction=last)))
    return out


@pytest.mark.parametrize("gauge", ["queue_ticks", "slo"])
def test_gauges_observe_as_the_reference(gauge):
    """QueueTickGauge (threshold 3) and PredictiveSLOGauge (the default
    SLOs) over the same engine iterations, with arrivals noted, growth
    attempts and resets: every SLOPressure and headroom equal."""
    if gauge == "queue_ticks":
        g, ref_g = slo.QueueTickGauge(3), ref_slo.QueueTickGauge(3)
    else:
        g = slo.PredictiveSLOGauge(slo_ttft_s=6.0, slo_tpot_s=0.30)
        ref_g = ref_slo.PredictiveSLOGauge(slo_ttft_s=6.0, slo_tpot_s=0.30)
    assert (g.relief, g.use_predicted_need, g.trade_rebuild_cost) == \
        (ref_g.relief, ref_g.use_predicted_need, ref_g.trade_rebuild_cost)
    fired = 0
    for (t, eng), (_, ref_eng) in zip(
            _engines(sim, PeakMemoryPredictor),
            _engines(ref_sim, RefPeakMemoryPredictor)):
        g.note_arrival(t)
        ref_g.note_arrival(t)
        got, want = g.observe(eng, t), ref_g.observe(ref_eng, t)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), t
        assert g.headroom(eng, t) == ref_g.headroom(ref_eng, t)
        if got.violation_prob >= 0.5:
            fired += 1
            g.attempt()
            ref_g.attempt()
        if int(t) % 7 == 6:
            g.reset()
            ref_g.reset()
    assert fired >= 1


def test_make_gauge_selects_as_the_reference():
    for kw in ARMS.values():
        got = slo.make_gauge(sim.ServingConfig(**kw))
        want = ref_slo.make_gauge(ref_sim.ServingConfig(**kw))
        assert type(got).__name__ == type(want).__name__
    with pytest.raises(ValueError):
        slo.make_gauge(sim.ServingConfig(gauge="none"))


# -- the simulator ----------------------------------------------------------------


@pytest.mark.parametrize("device", ["a100", "h100"])
@pytest.mark.parametrize("arm", list(ARMS))
def test_each_arm_equals_the_reference(arm, device):
    """run_serving of each arm on one device: every ServingMetrics field
    equal to the reference's."""
    got = sim.run_serving([device], sim.ServingConfig(**ARMS[arm]),
                          _requests(sim))
    want = ref_sim.run_serving([device], ref_sim.ServingConfig(**ARMS[arm]),
                               _requests(ref_sim))
    assert got.n_completed + got.n_dropped == N_REQUESTS
    assert _serving_metrics(got) == _serving_metrics(want)


def test_two_device_fleet_and_a_custom_model_equal_the_reference():
    """Requests routed across an A100 and an H100, with a model of a
    larger KV cache per token, under bursty diurnal arrivals."""
    kw = dict(n=40, peak_rate_per_s=4.0, trough_rate_per_s=0.3,
              period_s=20.0, seed=2)
    model = dict(kv_mb_per_token=1.0, params_gb=6.0)
    got = sim.run_serving(["a100", "h100"], sim.ServingConfig(),
                          sim.diurnal_requests(**kw),
                          model=sim.LLMServingModel(**model))
    want = ref_sim.run_serving(["a100", "h100"], ref_sim.ServingConfig(),
                               ref_sim.diurnal_requests(**kw),
                               model=ref_sim.LLMServingModel(**model))
    assert _serving_metrics(got) == _serving_metrics(want)


def test_api_serving_kind_equals_the_reference():
    """api.simulate kind "serving" (duplicate device models named by
    index, the reach-floor gate on growth, a tracer) against the
    reference's facade; the traced run's metrics equal the untraced
    run's, and the trace holds the reference's records."""
    cfg = dict(policy="dynamic", n_engines=2)
    spec = dict(kind="serving", devices=["h100", "h100"])
    got = api.simulate(api.RunSpec(
        serving=sim.ServingConfig(**cfg), requests=_requests(sim),
        admission=AdmissionController(horizon_s=20.0), **spec))
    want = ref_api.simulate(ref_api.RunSpec(
        serving=ref_sim.ServingConfig(**cfg), requests=_requests(ref_sim),
        admission=RefAdmissionController(horizon_s=20.0), **spec))
    assert isinstance(got, sim.ServingMetrics)
    assert _serving_metrics(got) == _serving_metrics(want)
    tracer, ref_tracer = Tracer(), RefTracer()
    traced = api.simulate(api.RunSpec(
        serving=sim.ServingConfig(**cfg), requests=_requests(sim),
        tracer=tracer, **spec))
    ref_traced = ref_api.simulate(ref_api.RunSpec(
        serving=ref_sim.ServingConfig(**cfg), requests=_requests(ref_sim),
        tracer=ref_tracer, **spec))
    assert _serving_metrics(traced) == _serving_metrics(ref_traced)
    untraced = sim.run_serving(["h100", "h100"], sim.ServingConfig(**cfg),
                               _requests(sim))
    assert _serving_metrics(traced) == _serving_metrics(untraced)
    assert tracer.records == ref_tracer.records
    assert tracer.records


def test_serving_launcher_checks_as_the_reference_bench(monkeypatch):
    """launch/serving_sim.py against the reference's
    benchmarks/bench_serving.py at 40 requests, where both refuse the same
    arm: the A100's dynamic arms do not yet save energy over the monolith
    on so short a run (at the bench's 300 requests they do; the chip's
    phase 8 runs that)."""
    from benchmarks import bench_serving
    from repro_torch.launch import serving_sim
    assert [c.name for c in serving_sim.CONFIGS] == \
        [c.name for c in bench_serving.CONFIGS]
    assert (serving_sim.N_REQUESTS, serving_sim.ARRIVAL_RATE,
            serving_sim.SEED) == (300, 2.0, 11)
    monkeypatch.setattr(serving_sim, "N_REQUESTS", N_REQUESTS)
    monkeypatch.setattr(bench_serving, "N_REQUESTS", N_REQUESTS)
    with pytest.raises(AssertionError) as got:
        serving_sim.run([])
    with pytest.raises(AssertionError) as want:
        bench_serving.run([])
    assert str(got.value) == str(want.value) == \
        "a100: MIG serving must save energy vs the monolith"
