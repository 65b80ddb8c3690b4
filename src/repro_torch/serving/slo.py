"""SLO-pressure gauges — the serving layer's growth *signal*; the port's
copy of ``repro.serving.slo``.

An earlier design grew engines off a fixed queue-tick threshold (``20
consecutive iterations with requests waiting``); this module replaces that
trigger with a measured **predicted SLO-violation probability** the
partition planner can trade against a reconfiguration
(:func:`repro_torch.core.planner.cost.serving_grow_cost`).  A gauge observes
one engine at each iteration boundary and reports an
:class:`SLOPressure`:

* :class:`PredictiveSLOGauge` — the real thing (MISO's
  predicted-pressure reconfiguration, arXiv:2207.11428, lifted to
  request level): forecasts the worst queued request's TTFT from the
  batch's remaining decode lengths and the engine's admission drain,
  folds in the arrival-rate utilisation (an EWMA over observed
  inter-arrival gaps), the iteration latency's distance to the TPOT SLO,
  and the :class:`~repro_torch.core.memory.timeseries.PeakMemoryPredictor`'s
  graded OOM risk — a crash stalls the whole batch, so memory risk *is*
  latency risk,
* :class:`QueueTickGauge` — the deleted threshold, re-expressed as a
  degenerate gauge: violation probability snaps from 0 to 1 after N
  consecutive pressured ticks (and ``slo_relief=0``: any growth fully
  cures).  Exists so the golden tests pin the refactor bit-for-bit
  against the pre-SLO metrics, and as the ablation arm of
  ``benchmarks/bench_slo.py``.

Both emit the same pressure snapshot: ``slo_violation_prob`` drives the
cost model's trade tier (the growth *decision* lives entirely there —
the gauges only measure), while ``queue_depth`` rides along on every
candidate for plan explainability and the learned-weights feature
vocabulary.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.scheduler.admission import ArrivalForecast

#: TTFT/TPOT risk ramps from 0 at this fraction of the SLO to 1 at the
#: SLO itself: acting only once the SLO is already missed would make every
#: growth a post-mortem, so pressure builds over the tail of the budget
#: (the paper's early-restart philosophy applied to latency).  0.6 leaves
#: enough headroom to pre-empt a p99 miss while not growing on transient
#: spikes the batch would absorb anyway (benchmarks/bench_slo.py measures
#: the resulting SLO-attainment-vs-Joules point against reactive growth).
RISK_RAMP_START = 0.6


def _ramp(value: float, slo: float) -> float:
    """0 below ``RISK_RAMP_START * slo``, 1 at/above ``slo``, linear
    in between — a deterministic, unit-free risk score."""
    if slo <= 0.0:
        return 0.0
    lo = RISK_RAMP_START * slo
    if value <= lo:
        return 0.0
    return min(1.0, (value - lo) / (slo - lo))


@dataclasses.dataclass(frozen=True)
class SLOPressure:
    """One engine-iteration snapshot of predicted SLO pressure."""

    queue_depth: float        # waiting requests per batch slot
    ttft_risk: float          # worst queued request's forecast TTFT vs SLO
    tpot_risk: float          # iteration latency vs the TPOT SLO
    oom_risk: float           # predictor tail mass above the partition
    violation_prob: float     # combined p99-miss probability
    #: compute fraction forecast to cure the pressure — slices at/above it
    #: relieve fully, so the planner's ladder picks the smallest
    #: *sufficient* rung instead of over-growing to the biggest (growth
    #: protects the SLO; tightness protects the Joules)
    needed_compute: float = 0.0

    @classmethod
    def none(cls) -> "SLOPressure":
        return cls(0.0, 0.0, 0.0, 0.0, 0.0)


class SLOGauge:
    """Observe one engine per iteration; report an :class:`SLOPressure`.

    ``attempt()`` is called when the pressure actually triggers a growth
    attempt, ``reset()`` when a migration begins for any reason — the
    queue-tick gauge keys its consecutive-tick counter off both, exactly
    where the deleted threshold code zeroed ``_pressure_ticks``.
    """

    #: residual violation fraction a growth leaves (request.slo_relief):
    #: None lets the planner derive it from the compute ratio.
    relief: float | None = None
    #: fold the predictor's current peak estimate into a pressure-driven
    #: growth's memory need (the predictive gauge sizes the target slice
    #: to the KV trajectory so one migration suffices); the queue-tick
    #: emulation keeps the legacy next-rung-only need.
    use_predicted_need = False
    #: charge the grow trade the full interruption (reconfiguration + KV
    #: rebuild re-prefill) instead of the bare reconfiguration; the
    #: queue-tick emulation keeps the legacy bare cost (its 0/1 pressure
    #: overrides any finite cost anyway).
    trade_rebuild_cost = False

    def note_arrival(self, t: float) -> None:
        """A request was enqueued on the observed engine at time ``t``."""

    def observe(self, engine, t: float) -> SLOPressure:
        raise NotImplementedError

    def headroom(self, engine, t: float) -> float:
        """Forecast *sustained* headroom in [0, 1] — the scale-down
        signal, symmetric to ``observe``'s violation probability: 1 means
        the engine could serve its forecast load on a smaller slice, 0
        means shrinking would immediately regrow.  The base gauge (and
        the queue-tick emulation) reports 0 — engines under it never
        scale down, which keeps every pre-elasticity golden bit-for-bit."""
        return 0.0

    def attempt(self) -> None:
        """Pressure crossed the trade threshold; a growth plan was run."""

    def reset(self) -> None:
        """A migration began (memory- or pressure-driven)."""


class QueueTickGauge(SLOGauge):
    """The pre-SLO fixed threshold as a degenerate gauge: probability is a
    step function of consecutive pressured ticks.  ``relief=0.0`` means a
    chosen growth is modelled as fully curing — together these reproduce
    the deleted ``scale_up_queue_ticks`` ladder decision bit-for-bit
    (the reference's tests/test_kernel_parity.py pins it against
    pre-refactor goldens; tests/test_torch_serving_sim.py holds this copy
    to the live reference)."""

    relief = 0.0

    def __init__(self, threshold_ticks: int) -> None:
        self.threshold = threshold_ticks
        self._ticks = 0

    def observe(self, engine, t: float) -> SLOPressure:
        self._ticks = self._ticks + 1 if engine.waiting else 0
        fire = 0 < self.threshold <= self._ticks
        return SLOPressure(
            queue_depth=len(engine.waiting) / max(engine.cfg.max_batch, 1),
            ttft_risk=1.0 if fire else 0.0, tpot_risk=0.0, oom_risk=0.0,
            violation_prob=1.0 if fire else 0.0)

    def attempt(self) -> None:
        self._ticks = 0

    def reset(self) -> None:
        self._ticks = 0


class PredictiveSLOGauge(SLOGauge):
    """Forecast the engine's p99 TTFT/TPOT attainment one horizon out.

    Deterministic by construction: every input is engine state or an EWMA
    of observed arrivals — two identically-seeded runs see identical
    pressures.  The forecast is deliberately cheap (O(batch) per tick):

    * **TTFT** — each waiting request is admitted when a batch slot frees;
      slots free in order of the running batch's remaining decode lengths
      (known in-sim; a real engine uses its output-length predictor), so
      queued request ``i`` waits ``remaining[i]`` further iterations.  Its
      forecast TTFT is elapsed wait + that drain + its own prefill.
    * **utilisation** — if EWMA arrivals outpace service capacity
      (``max_batch`` sequences at the current iteration latency), the
      queue diverges no matter what the snapshot says; the risk floor is
      the overload fraction.
    * **TPOT** — the iteration latency itself, against the TPOT SLO.
    * **OOM** — :meth:`PeakMemoryPredictor.oom_risk`: the probability the
      fitted trajectory's true peak exceeds the slice.  A crash costs
      ``crash_penalty_s`` plus a full KV rebuild, stalling every running
      request past its tail budget — memory risk *is* p99 risk.

    The risks combine as independent failure modes:
    ``1 - prod(1 - risk)``.
    """

    #: only this many queue heads are forecast exactly; a deeper queue is
    #: already saturating the utilisation term.
    MAX_FORECAST = 32

    use_predicted_need = True
    trade_rebuild_cost = True

    def __init__(self, slo_ttft_s: float, slo_tpot_s: float,
                 arrival_alpha: float = 0.2) -> None:
        self.slo_ttft_s = slo_ttft_s
        self.slo_tpot_s = slo_tpot_s
        # the fleet admission controller's estimator, reused verbatim:
        # EWMA inter-arrival gap, decaying as post-burst silence grows
        self.forecast = ArrivalForecast(alpha=arrival_alpha)

    def note_arrival(self, t: float) -> None:
        self.forecast.observe(t)

    def arrival_rate(self, t: float) -> float:
        """Requests/s this engine is currently receiving; the estimate
        decays as the quiet time since the last arrival grows, so a burst
        that ended does not pin the gauge high forever."""
        return self.forecast.rate_per_s(t)

    # -- the forecast ------------------------------------------------------

    def observe(self, engine, t: float) -> SLOPressure:
        cfg, model = engine.cfg, engine.model
        c = max(engine.compute, 1e-6)
        n_running = len(engine.running)
        step_s = (model.decode_step_fixed_s
                  + max(n_running, 1) * model.decode_step_per_seq_s) / c

        # the compute each risk needs to clear its ramp start — the planner
        # relieves candidates at/above the max, so growth stays tight
        needs = [c]

        # TTFT: drain order = remaining decode lengths, ascending
        ttft_risk = 0.0
        if engine.waiting:
            remaining = sorted(max(r.decode_tokens - r.generated, 1)
                               for r in engine.running)
            free_slots = max(cfg.max_batch - n_running, 0)
            for i, req in enumerate(engine.waiting[:self.MAX_FORECAST]):
                if i < free_slots:
                    # a slot is open now: the wait is memory, not compute —
                    # admission happens at the next grow/preempt, bounded
                    # below by one iteration
                    drain_s = step_s
                else:
                    k = min(i - free_slots, len(remaining) - 1)
                    drain_s = remaining[k] * step_s if remaining else step_s
                prefill_s = req.prompt_tokens / (model.prefill_tokens_per_s
                                                 * c)
                forecast = (t - req.arrival) + drain_s + prefill_s
                risk = _ramp(forecast, self.slo_ttft_s)
                ttft_risk = max(ttft_risk, risk)
                if risk > 0.0:
                    # compute scales the variable part (drain + prefill)
                    # by 1/c; the elapsed wait is sunk
                    budget = (RISK_RAMP_START * self.slo_ttft_s
                              - (t - req.arrival))
                    if budget <= 0.0:
                        needs.append(1.0)
                    else:
                        needs.append(c * (drain_s + prefill_s) / budget)

        # utilisation: offered decode-work rate vs this slice's capacity
        rate = self.arrival_rate(t)
        util_risk = 0.0
        if rate > 0.0 and engine.waiting:
            mean_decode = (sum(r.decode_tokens for r in engine.running)
                           / max(n_running, 1)) if n_running else 1.0
            service_s = mean_decode * step_s          # one request's decode
            capacity = cfg.max_batch / max(service_s, 1e-9)
            overload = rate / capacity
            util_risk = min(1.0, max(0.0, overload - 1.0))
            if util_risk > 0.0:
                needs.append(c * overload)   # capacity scales with compute
        ttft_risk = max(ttft_risk, util_risk)

        tpot_risk = _ramp(step_s, self.slo_tpot_s) if n_running else 0.0
        if tpot_risk > 0.0:
            needs.append(c * step_s / (RISK_RAMP_START * self.slo_tpot_s))

        oom_risk = 0.0
        if (cfg.use_prediction and engine.last_prediction is not None
                and engine.last_prediction.converged):
            # graded tail mass of a *converged* fit only: an unconverged
            # trajectory's sigma is noise, and acting on it buys repeated
            # under-sized migrations
            oom_risk = engine.predictor.oom_risk(engine.part_bytes,
                                                 engine.last_prediction)

        prob = 1.0 - ((1.0 - ttft_risk) * (1.0 - tpot_risk)
                      * (1.0 - oom_risk))
        return SLOPressure(
            queue_depth=len(engine.waiting) / max(cfg.max_batch, 1),
            ttft_risk=ttft_risk, tpot_risk=tpot_risk, oom_risk=oom_risk,
            violation_prob=prob, needed_compute=min(1.0, max(needs)))

    # -- the scale-down signal ---------------------------------------------

    def headroom(self, engine, t: float) -> float:
        """Sustained-headroom forecast: 1 - (EWMA arrival rate / this
        slice's service capacity), gated to zero whenever *any* growth
        signal is live — a non-empty queue, an in-flight migration, or a
        converged predictor showing OOM tail mass.  The arrival EWMA
        decays through quiet time (:meth:`arrival_rate`), so headroom
        rises only after a burst has genuinely passed, not at the first
        idle tick inside one."""
        if engine.waiting or engine.migrating:
            return 0.0
        cfg, model = engine.cfg, engine.model
        if (cfg.use_prediction and engine.last_prediction is not None
                and engine.last_prediction.converged
                and engine.predictor.oom_risk(
                    engine.part_bytes, engine.last_prediction) > 0.0):
            return 0.0
        c = max(engine.compute, 1e-6)
        n_running = len(engine.running)
        step_s = (model.decode_step_fixed_s
                  + max(n_running, 1) * model.decode_step_per_seq_s) / c
        mean_decode = (sum(r.decode_tokens for r in engine.running)
                       / max(n_running, 1)) if n_running else 1.0
        service_s = mean_decode * step_s
        capacity = cfg.max_batch / max(service_s, 1e-9)
        util = self.arrival_rate(t) / capacity
        return max(0.0, 1.0 - util)


def make_gauge(cfg) -> SLOGauge:
    """Build the gauge a :class:`~repro_torch.serving.sim.ServingConfig` names.
    ``scale_up_queue_ticks == 0`` disables pressure-driven growth under
    either gauge (the pre-SLO convention the tests rely on)."""
    if cfg.scale_up_queue_ticks <= 0:
        return QueueTickGauge(0)           # never fires
    if cfg.gauge == "queue_ticks":
        return QueueTickGauge(cfg.scale_up_queue_ticks)
    if cfg.gauge == "slo":
        return PredictiveSLOGauge(cfg.slo_ttft_s, cfg.slo_tpot_s)
    raise ValueError(f"unknown SLO gauge {cfg.gauge!r}; "
                     f"known: ['queue_ticks', 'slo']")
