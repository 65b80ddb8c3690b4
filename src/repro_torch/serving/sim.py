"""Request-level LLM serving simulation on the unified event kernel; the
port's copy of ``repro.serving.sim``.  Host code: an analytic model of
the engines, which launches nothing on a card.

The paper's headline LLM result (1.43x throughput, 1.11x energy) comes
from *serving* workloads whose memory grows with the KV cache — the
dynamic-memory regime the peak predictor and the fission/fusion machinery
target.  This module simulates that regime at request granularity:

* requests arrive open-loop (Poisson) with prompt/decode lengths drawn
  from seeded heavy-tailed distributions,
* each MIG partition hosts a continuous-batching engine: admitted
  requests prefill, then decode one token per engine iteration; iteration
  latency scales with the slice's compute fraction and the batch size,
* per-iteration KV-cache growth feeds the same
  :class:`~repro_torch.core.memory.timeseries.PeakMemoryPredictor` the batch
  scheduler uses; when the converged prediction exceeds the partition the
  engine *early-restarts* onto a larger slice through the shared partition
  planner (a :class:`~repro_torch.core.planner.actions.Grow` plan over the
  restart ladder, scored by ``serving_grow_cost``), paying a
  reconfiguration + KV-rebuild (re-prefill) cost instead of crashing
  mid-iteration and losing work,
* latency pressure drives growth the same way: an SLO gauge
  (:mod:`repro_torch.serving.slo`) forecasts the p99 TTFT/TPOT violation
  probability each iteration, and the grow plan *trades* that predicted
  miss against the reconfiguration + rebuild it would pay — an explicit
  stay candidate carries the uncured risk, so the engine reconfigures
  exactly when the forecast miss is the more expensive side (the old
  fixed queue-tick threshold survives only as the degenerate
  ``gauge="queue_ticks"`` emulation the golden-parity tests pin),
* SLO metrics come out the other end: TTFT, TPOT, p99 end-to-end
  latency and goodput (SLO-attaining requests per second), next to the
  energy integral — so fusion/fission and early restart are evaluated
  against serving SLOs, not just makespan.

Everything is driven by :class:`~repro_torch.core.scheduler.kernel.EventKernel`
events — ARRIVAL for requests, TICK for engine iteration boundaries,
RECONFIG for migration completions — the same heap the batch policies and
the fleet use.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.memory.timeseries import PeakMemoryPredictor, Prediction
from repro_torch.core.partition_manager import Partition, PartitionManager
from repro_torch.core.partition_state import PartitionProfile
from repro_torch.core.planner import (SERVING_GROW_COST, SLO_MISS_PENALTY_S,
                                      PartitionPlanner, Wait, grow_request,
                                      serving_grow_cost, serving_shrink_cost,
                                      shrink_ladder, shrink_request)
from repro_torch.core.scheduler.energy import EnergyIntegrator
from repro_torch.core.scheduler.job import GB
from repro_torch.core.scheduler.kernel import EventKernel, SchedulingPolicy
from repro_torch.core.scheduler.metrics import percentile
from repro_torch.fleet.devices import DEVICE_CATALOGUE
from repro_torch.obs.counters import TailStats
from repro_torch.serving.slo import SLOPressure, make_gauge

MB = 1024 ** 2


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ServingRequest:
    rid: int
    arrival: float
    prompt_tokens: int
    decode_tokens: int
    # runtime state
    generated: int = 0
    in_prefill: bool = True
    t_first_token: float | None = None
    t_done: float | None = None
    dropped: bool = False
    n_preemptions: int = 0

    @property
    def name(self) -> str:            # kernel admission bookkeeping
        return f"req{self.rid}"

    @property
    def done(self) -> bool:
        return self.t_done is not None

    @property
    def kv_tokens(self) -> int:
        """Tokens whose KV the engine holds for this request."""
        return self.prompt_tokens + self.generated

    @property
    def ttft(self) -> float:
        assert self.t_first_token is not None
        return self.t_first_token - self.arrival

    @property
    def latency(self) -> float:
        assert self.t_done is not None
        return self.t_done - self.arrival

    @property
    def tpot(self) -> float:
        """Mean time per output token after the first."""
        assert self.t_done is not None and self.t_first_token is not None
        return ((self.t_done - self.t_first_token)
                / max(self.decode_tokens - 1, 1))


def poisson_requests(n: int, rate_per_s: float, seed: int = 0,
                     median_prompt: int = 256, median_decode: int = 160,
                     sigma_prompt: float = 0.6, sigma_decode: float = 0.8,
                     max_tokens: int = 4096) -> list[ServingRequest]:
    """Open-loop Poisson arrivals with log-normal (heavy-tailed) prompt and
    decode lengths — the shape production serving traces report (ShareGPT /
    Azure LLM traces: most requests short, a long decode tail).

    ``median_*`` are the lognormal *medians* (mu = log(median)); the means
    sit a factor exp(sigma^2 / 2) above them — size offered load from the
    mean, ``median * exp(sigma**2 / 2) * rate_per_s`` tokens/s."""
    rng = np.random.default_rng(seed)
    reqs = []
    t = 0.0
    for i in range(n):
        t += float(rng.exponential(1.0 / rate_per_s))
        prompt = int(np.clip(
            rng.lognormal(np.log(median_prompt), sigma_prompt),
            8, max_tokens))
        decode = int(np.clip(
            rng.lognormal(np.log(median_decode), sigma_decode),
            4, max_tokens))
        reqs.append(ServingRequest(rid=i, arrival=t, prompt_tokens=prompt,
                                   decode_tokens=decode))
    return reqs


def diurnal_requests(n: int, peak_rate_per_s: float,
                     trough_rate_per_s: float, period_s: float,
                     seed: int = 0, median_prompt: int = 256,
                     median_decode: int = 160, sigma_prompt: float = 0.6,
                     sigma_decode: float = 0.8,
                     max_tokens: int = 4096) -> list[ServingRequest]:
    """Bursty diurnal arrivals: a square wave alternating between
    ``peak_rate_per_s`` (the first half of each ``period_s``) and
    ``trough_rate_per_s``, with the same seeded heavy-tailed lengths as
    :func:`poisson_requests`.  The elasticity benchmark's workload shape:
    bursts that justify fused slices, troughs long enough that holding
    them burns Joules for nothing."""
    rng = np.random.default_rng(seed)
    reqs = []
    t = 0.0
    for i in range(n):
        peak_phase = (t % period_s) < period_s / 2.0
        rate = peak_rate_per_s if peak_phase else trough_rate_per_s
        t += float(rng.exponential(1.0 / rate))
        prompt = int(np.clip(
            rng.lognormal(np.log(median_prompt), sigma_prompt),
            8, max_tokens))
        decode = int(np.clip(
            rng.lognormal(np.log(median_decode), sigma_decode),
            4, max_tokens))
        reqs.append(ServingRequest(rid=i, arrival=t, prompt_tokens=prompt,
                                   decode_tokens=decode))
    return reqs


# ---------------------------------------------------------------------------
# Model + engine configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LLMServingModel:
    """Latency/memory coefficients of the served model (full-device rates;
    a slice with compute fraction ``c`` scales them by ``c``)."""

    name: str = "qwen2-7b"
    params_gb: float = 3.0             # weights resident per engine replica
    #: full-attention 7B-class KV (2 * 32 layers * 32 heads * 128 dim * 2B)
    kv_mb_per_token: float = 0.5
    activations_gb: float = 0.4        # workspace + activation churn
    prefill_tokens_per_s: float = 24000.0
    decode_step_fixed_s: float = 0.009
    decode_step_per_seq_s: float = 0.0011

    def kv_bytes(self, tokens: int) -> float:
        return tokens * self.kv_mb_per_token * MB

    def base_bytes(self) -> float:
        return (self.params_gb + self.activations_gb) * GB


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """One serving policy configuration.

    ``policy``:
      * ``"full"``    — one engine on the whole device (no MIG),
      * ``"static"``  — ``n_engines`` fixed slices; on memory pressure the
        engine preempts (evicts + later re-prefills) requests, vLLM-style,
      * ``"dynamic"`` — engines start on the smallest feasible slice and
        grow via partition fission/fusion; with ``use_prediction`` the
        predictor early-restarts them *before* the crash (paper §2.3),
        without it they grow only after OOM crashes.
    """

    policy: str = "dynamic"
    n_engines: int = 2
    max_batch: int = 24
    #: admission is optimistic (vLLM-style): a request is admitted when its
    #: *current* KV fits — subsequent decode growth is exactly the dynamic
    #: memory the predictor/fission machinery must then absorb
    admit_frac: float = 0.98
    use_prediction: bool = True
    predict_lookahead: int = 96        # predictor horizon, engine iterations
    crash_penalty_s: float = 2.0       # engine crash + reload after an OOM
    #: compute share an engine asks for when growing — a soft constraint
    #: (paper §4.3): without it Hopper's 1g.20gb profile traps a memory-
    #: hungry engine at 1/7 compute forever
    engine_compute_demand: float = 0.5
    #: pressure signal for dynamic growth (:mod:`repro_torch.serving.slo`):
    #: ``"slo"`` forecasts the p99 TTFT/TPOT violation probability and
    #: lets the cost model trade it against a reconfiguration;
    #: ``"queue_ticks"`` is the deleted fixed threshold re-expressed as a
    #: degenerate gauge (the golden-parity emulation + benchmark ablation)
    gauge: str = "slo"
    #: queue-tick gauge threshold (consecutive pressured iterations); 0
    #: disables pressure-driven growth under EITHER gauge — memory
    #: pressure (OOM, converged predictor) remains the only growth path
    scale_up_queue_ticks: int = 20
    #: consecutive high-headroom iterations (gauge ``headroom() >= 0.5``)
    #: before a :class:`~repro_torch.core.planner.actions.Shrink` plan is
    #: scored; 0 disables scale-down entirely — the default, so every
    #: pre-elasticity golden and benchmark stays bit-for-bit.  Only the
    #: predictive gauge reports headroom, so shrink implies
    #: ``gauge="slo"``
    scale_down_ticks: int = 0
    slo_ttft_s: float = 6.0
    slo_tpot_s: float = 0.30
    #: seconds-equivalent price of a predicted p99 miss — the exchange
    #: rate of the grow trade (cost.serving_grow_cost)
    slo_miss_penalty_s: float = SLO_MISS_PENALTY_S
    #: keep full latency sample lists and compute percentiles by sorting
    #: (the legacy path the golden-parity tests pin); the default streams
    #: TTFT/TPOT/latency through P² estimators at O(1) memory
    #: (repro_torch.obs.counters), which is what lets the kernel survive
    #: trace-scale request counts
    exact_quantiles: bool = False

    @property
    def name(self) -> str:
        if self.policy != "dynamic":
            return self.policy
        n = "dynamic"
        if self.gauge == "slo" and self.scale_up_queue_ticks > 0:
            n += "+slo"
        if self.scale_down_ticks > 0:
            n += "+shrink"
        return n + ("+pred" if self.use_prediction else "")


# ---------------------------------------------------------------------------
# Streaming request statistics
# ---------------------------------------------------------------------------

class ServingStats:
    """Request-completion statistics streamed as the simulation runs.

    Engines feed every completed request in here the moment it finishes,
    so TTFT/TPOT/latency tails come from P² estimators at O(1) memory
    instead of end-of-run sorts over stored lists (``exact=True`` keeps
    the lists — the golden-parity path)."""

    def __init__(self, cfg: "ServingConfig") -> None:
        exact = cfg.exact_quantiles
        self.ttft = TailStats("ttft_s", exact=exact)
        self.tpot = TailStats("tpot_s", exact=exact)
        self.latency = TailStats("latency_s", exact=exact)
        self.n_completed = 0
        self.n_good = 0
        self.tokens = 0
        self._slo_ttft = cfg.slo_ttft_s
        self._slo_tpot = cfg.slo_tpot_s

    def complete(self, req: ServingRequest) -> None:
        self.n_completed += 1
        self.tokens += req.generated
        ttft, tpot = req.ttft, req.tpot
        self.ttft.observe(ttft)
        self.tpot.observe(tpot)
        self.latency.observe(req.latency)
        if ttft <= self._slo_ttft and tpot <= self._slo_tpot:
            self.n_good += 1


# ---------------------------------------------------------------------------
# Devices and engines
# ---------------------------------------------------------------------------

class ServingDevice:
    """A MIG device hosting serving engines: partition FSM + energy
    integral, satisfying the kernel's device surface (``name`` /
    ``has_running`` / ``advance_to``)."""

    #: flight recorder (repro_torch.obs.Tracer); instance-assigned by the event
    #: kernel when a run is traced, class-default None otherwise
    tracer = None
    #: reachability-floor gate (repro_torch.core.scheduler.admission
    #: .AdmissionController) for pressure-driven engine growth on this
    #: device; instance-assigned by ``run_serving(admission=...)``, class
    #: default None = admit every grow (the pre-elasticity behaviour)
    admission = None

    def __init__(self, model: str, name: str | None = None) -> None:
        try:
            backend_cls, power, reconfig_s = DEVICE_CATALOGUE[model]
        except KeyError:
            raise ValueError(f"unknown device model {model!r}; "
                             f"known: {sorted(DEVICE_CATALOGUE)}") from None
        self.model = model
        self.name = name or model
        self.backend = backend_cls()
        self.pm = PartitionManager(self.backend)
        self.planner = PartitionPlanner(self.pm, SERVING_GROW_COST)
        self.energy = EnergyIntegrator(power)
        self.reconfig_s = reconfig_s
        self.t = 0.0
        self.engines: list["EngineSim"] = []

    def _active_util(self) -> float:
        return sum(e.util() for e in self.engines)

    @property
    def has_running(self) -> bool:
        return any(e.busy or e.waiting for e in self.engines)

    def advance_to(self, t: float) -> None:
        if t > self.t:
            self.energy.advance(t, self._active_util())
            self.t = t

    def sync(self) -> None:
        """Re-latch the utilization after engine state changed at time t."""
        self.energy.advance(self.t, self._active_util())


class EngineSim:
    """A continuous-batching engine bound to one partition of a device."""

    def __init__(self, device: ServingDevice, partition: Partition,
                 model: LLMServingModel, cfg: ServingConfig,
                 eid: int, stats: ServingStats | None = None) -> None:
        self.device = device
        self.partition = partition
        partition.busy = True
        self.model = model
        self.cfg = cfg
        self.eid = eid
        self.stats = stats
        self.running: list[ServingRequest] = []
        self.waiting: list[ServingRequest] = []
        self.migrating = False
        self._tick_pending = False
        self._requested_cum = 0.0
        self.predictor = self._fresh_predictor()
        self.last_prediction: Prediction | None = None
        self.last_pressure: SLOPressure | None = None
        self.gauge = make_gauge(cfg)
        self.grow_cost = serving_grow_cost(cfg.slo_miss_penalty_s)
        self.shrink_cost = serving_shrink_cost(
            miss_penalty_s=cfg.slo_miss_penalty_s)
        self.n_oom = 0
        self.n_early = 0
        self.n_preemptions = 0
        self.n_dropped = 0
        self.n_scaleups = 0
        self.n_shrinks = 0
        self.n_grow_deferrals = 0
        self._grow_cooldown = 0
        self._shrink_cooldown = 0
        self._calm_ticks = 0

    # -- state helpers -----------------------------------------------------

    def _fresh_predictor(self) -> PeakMemoryPredictor:
        return PeakMemoryPredictor(max_iter=self.cfg.predict_lookahead)

    @property
    def busy(self) -> bool:
        return bool(self.running) or self.migrating

    @property
    def compute(self) -> float:
        return self.partition.profile.compute_fraction

    @property
    def part_bytes(self) -> float:
        return self.partition.profile.mem_gb * GB

    def util(self) -> float:
        return self.compute if self.busy else 0.0

    def load(self) -> int:
        return len(self.running) + len(self.waiting)

    def live_bytes(self, extra_tokens: int = 0) -> float:
        tokens = sum(r.kv_tokens for r in self.running) + extra_tokens
        return self.model.base_bytes() + self.model.kv_bytes(tokens)

    def _complete(self, finished: list[ServingRequest], t: float) -> None:
        """Retire finished requests: stream their latencies, trace them."""
        tracer = self.device.tracer
        for r in finished:
            self.running.remove(r)
            if self.stats is not None:
                self.stats.complete(r)
            if tracer is not None:
                tracer.span(r.arrival, t, r.name,
                            device=self.device.name,
                            lane=f"engine{self.eid}", cat="request",
                            ttft=r.ttft, tpot=r.tpot,
                            preemptions=r.n_preemptions)

    # -- queue interface ---------------------------------------------------

    def enqueue(self, kernel: EventKernel, req: ServingRequest) -> None:
        self.waiting.append(req)
        self.gauge.note_arrival(kernel.t)
        if self.device.admission is not None:
            self.device.admission.note_arrival(kernel.t, req)
        if not self.migrating and not self._tick_pending:
            self._admit(kernel)
            self._schedule_tick(kernel)

    def _admit(self, kernel: EventKernel) -> None:
        budget = self.cfg.admit_frac * self.part_bytes
        while self.waiting and len(self.running) < self.cfg.max_batch:
            nxt = self.waiting[0]
            if self.live_bytes(extra_tokens=nxt.kv_tokens) > budget:
                if not self.running:
                    # this request alone cannot fit the current slice: grow,
                    # or reject it if the engine cannot
                    if (self._can_grow()
                            and self._begin_migration(kernel, crashed=False)):
                        break
                    self.waiting.pop(0)
                    nxt.dropped = True
                    self.n_dropped += 1
                    if self.device.tracer is not None:
                        self.device.tracer.instant(
                            "request.drop", device=self.device.name,
                            lane=f"engine{self.eid}", req=nxt.name,
                            kv_tokens=nxt.kv_tokens)
                    continue
                break
            nxt.in_prefill = True
            self.running.append(self.waiting.pop(0))

    def _schedule_tick(self, kernel: EventKernel) -> None:
        if self._tick_pending or self.migrating or not self.running:
            return
        c = max(self.compute, 1e-6)
        prefill_tokens = sum(r.kv_tokens for r in self.running
                             if r.in_prefill)
        dt = (prefill_tokens / (self.model.prefill_tokens_per_s * c)
              + (self.model.decode_step_fixed_s
                 + len(self.running) * self.model.decode_step_per_seq_s) / c)
        self._tick_pending = True
        kernel.schedule_tick(kernel.t + dt, self)

    # -- one engine iteration ---------------------------------------------

    def step(self, kernel: EventKernel) -> None:
        self._tick_pending = False
        if self._grow_cooldown > 0:
            self._grow_cooldown -= 1
        if self._shrink_cooldown > 0:
            self._shrink_cooldown -= 1
        # the iteration that just ran appends one token per sequence; check
        # whether its KV allocations actually fit *before* crediting them
        grew = sum(1 for r in self.running if not r.in_prefill) \
            + sum(r.kv_tokens for r in self.running if r.in_prefill)
        live_after = self.live_bytes(
            extra_tokens=sum(1 for r in self.running if not r.in_prefill))
        if live_after > self.part_bytes:
            self.n_oom += 1
            if self.device.tracer is not None:
                self.device.tracer.instant(
                    "oom", device=self.device.name,
                    lane=f"engine{self.eid}",
                    profile=self.partition.profile.name,
                    live_gb=live_after / GB)
            if not (self._can_grow()
                    and self._begin_migration(kernel, crashed=True)):
                self._preempt_until_fits()
                # preemption may have evicted the whole batch; re-admit (or
                # drop requests that no longer fit alone) so the evicted
                # work cannot strand in `waiting` with no tick scheduled
                self._admit(kernel)
            self._schedule_tick(kernel)   # no-op while migrating
            self.device.sync()
            return

        # credit the iteration
        t = kernel.t
        finished: list[ServingRequest] = []
        for r in self.running:
            if r.in_prefill:
                r.in_prefill = False
                if r.t_first_token is None:
                    r.t_first_token = t
                r.generated += 1
            else:
                r.generated += 1
            if r.generated >= r.decode_tokens:
                r.t_done = t
                finished.append(r)
        self._complete(finished, t)

        # allocator statistics -> the paper's time-series predictor
        self._requested_cum += (self.model.kv_bytes(grew)
                                + 0.02 * self.model.activations_gb * GB)
        live_now = self.live_bytes()
        pred = self.predictor.observe(
            self._requested_cum + self.model.base_bytes(),
            min((live_now) / max(self._requested_cum
                                 + self.model.base_bytes(), 1.0), 1.0))
        self.last_prediction = pred
        if (self.cfg.use_prediction and self.running
                and self.predictor.will_oom(self.part_bytes, pred)
                and self._can_grow()
                and self._begin_migration(
                    kernel, crashed=False,
                    predicted_gb=pred.peak_mem_bytes / GB)):
            self.n_early += 1
            self.device.sync()
            return

        self._admit(kernel)
        # SLO pressure: the gauge forecasts the p99-miss probability; when
        # it is nonzero the grow plan *trades* it against a reconfiguration
        # (an explicit stay candidate carries the uncured risk) — the old
        # fixed queue-tick threshold survives only as the degenerate
        # QueueTickGauge whose probability is a 0/1 step
        pressure = self.gauge.observe(self, kernel.t)
        self.last_pressure = pressure
        if self.device.tracer is not None:
            self.device.tracer.counter(
                f"engine{self.eid}.violation_prob",
                pressure.violation_prob, device=self.device.name)
            self.device.tracer.counter(
                f"engine{self.eid}.queue_depth",
                pressure.queue_depth, device=self.device.name)
        if pressure.violation_prob > 0.0 and self._can_grow():
            self.gauge.attempt()
            predicted = None
            if (self.gauge.use_predicted_need and self.cfg.use_prediction
                    and self.last_prediction is not None):
                predicted = self.last_prediction.peak_mem_bytes / GB
            if self._begin_migration(kernel, crashed=False,
                                     predicted_gb=predicted,
                                     pressure=pressure):
                self.n_scaleups += 1
                if self.device.tracer is not None:
                    self.device.tracer.instant(
                        "scaleup", device=self.device.name,
                        lane=f"engine{self.eid}",
                        violation_prob=pressure.violation_prob)
                self.device.sync()
                return
        # scale-down: the symmetric signal — the gauge's sustained-headroom
        # forecast must hold for a streak of iterations before the shrink
        # trade (Joules saved over the horizon vs reconfiguration + rebuild
        # + regrow risk) is even scored
        if self.cfg.scale_down_ticks > 0 and self.cfg.policy == "dynamic":
            head = self.gauge.headroom(self, kernel.t)
            self._calm_ticks = self._calm_ticks + 1 if head >= 0.5 else 0
            if (self._calm_ticks >= self.cfg.scale_down_ticks
                    and self._shrink_cooldown == 0
                    and self._begin_shrink(kernel, head)):
                self.device.sync()
                return
        self._schedule_tick(kernel)
        self.device.sync()

    # -- memory pressure paths --------------------------------------------

    def _preempt_until_fits(self) -> None:
        """Static policy: evict the youngest sequences (KV dropped, tokens
        kept) until the batch fits; they re-prefill on readmission."""
        budget = self.cfg.admit_frac * self.part_bytes
        while self.running and self.live_bytes(
                extra_tokens=len(self.running)) > budget:
            victim = self.running.pop()          # LIFO: youngest first
            victim.in_prefill = True             # must rebuild its KV
            victim.n_preemptions += 1
            self.n_preemptions += 1
            self.waiting.insert(0, victim)

    def _can_grow(self) -> bool:
        if self.cfg.policy != "dynamic" or self._grow_cooldown > 0:
            return False
        return self.device.backend.next_larger_profile(
            self.partition.profile) is not None

    def _begin_migration(self, kernel: EventKernel, crashed: bool,
                         predicted_gb: float | None = None,
                         pressure: SLOPressure | None = None) -> bool:
        """Checkpointless restart onto a larger slice, through the shared
        partition planner: the growth ladder (predictor need or OOM restart
        rung, compute as the paper's soft constraint) is scored under the
        serving cost weights, then the winning Grow action releases the
        current partition and fuses/fissions space into the target — paying
        the reconfiguration plus the KV rebuild (re-prefill of every
        in-flight sequence), and a crash penalty if this is a post-OOM
        restart.

        Memory-forced calls (OOM crash, converged predictor) leave
        ``pressure`` None — every rung ties on the trade tier and the
        ladder decides.  SLO-pressure calls carry the gauge's forecast:
        the plan scores an explicit stay candidate, so growth happens
        exactly when the predicted p99 miss outweighs the reconfiguration.
        Returns False when the engine stays — either the trade kept the
        slice (pressure keeps accumulating) or neighbours hold the space
        (the engine backs off for a cooldown)."""
        dev = self.device
        from_profile = self.partition.profile.name
        trade_cost_s = dev.reconfig_s
        if pressure is not None and self.gauge.trade_rebuild_cost:
            # the honest price of interrupting this engine: reconfiguration
            # plus re-prefilling every in-flight sequence's KV
            rebuild_tokens = sum(r.kv_tokens for r in self.running)
            trade_cost_s += rebuild_tokens / (
                self.model.prefill_tokens_per_s * max(self.compute, 1e-6))
        demand = self.cfg.engine_compute_demand
        if self.gauge.use_predicted_need:
            # SLO-aware compute sizing: hold the current compute and raise
            # it only as far as the gauge forecasts the SLO needs — a
            # memory-forced grow under low pressure takes the memory-tight
            # low-compute rung (Joules), and a later pressure grow raises
            # compute when the forecast says so (SLO)
            need = (pressure.needed_compute if pressure is not None
                    else (self.last_pressure.needed_compute
                          if self.last_pressure is not None else 0.0))
            demand = max(self.compute, need)
        plan = dev.planner.plan(grow_request(
            dev.backend, self.partition, predicted_gb,
            demand,
            reconfig_cost_s=trade_cost_s,
            queue_depth=pressure.queue_depth if pressure else 0.0,
            slo_violation_prob=(pressure.violation_prob if pressure
                                else 0.0),
            slo_relief=self.gauge.relief if pressure else None,
            needed_compute=pressure.needed_compute if pressure else 0.0,
            allow_stay=pressure is not None), model=self.grow_cost)
        if (not crashed and dev.admission is not None
                and plan.chosen is not None
                and not isinstance(plan.chosen.action, Wait)):
            # reachability-floor admission (the fleet's controller, reused):
            # a grow whose post-action |F_s| would break the guarantee that
            # forecast arrivals stay hostable *defers* — the engine backs
            # off instead of thrashing the FSM it shares with its
            # neighbours.  OOM restarts are never gated: a crashed engine
            # holds live KV that must land somewhere.
            decision = dev.admission.decide(dev.pm, plan, kernel.t,
                                            shares=max(len(dev.engines), 1))
            if not decision.admit:
                self.n_grow_deferrals += 1
                self._grow_cooldown = max(self.cfg.scale_up_queue_ticks, 10)
                if dev.tracer is not None:
                    dev.tracer.instant(
                        "grow.defer", device=dev.name,
                        lane=f"engine{self.eid}", cat="admission",
                        decision=decision.describe())
                return False
        result = dev.planner.execute(plan)
        assert result is not None and result.partition is not None
        self.partition = result.partition
        self.partition.busy = True
        if isinstance(result.action, Wait):
            if any(not isinstance(c.action, Wait) for c in plan.candidates):
                # the stay candidate won on cost: the predicted miss is
                # still cheaper than a reconfiguration — keep the slice,
                # keep measuring (no cooldown: pressure may keep building)
                return False
            # neighbours hold the space: back off and let the caller shed
            # load (the probe counted no reconfiguration)
            self._grow_cooldown = max(self.cfg.scale_up_queue_ticks, 10)
            return False
        for r in self.running:
            r.in_prefill = True              # KV is rebuilt on the new slice
        rebuild_tokens = sum(r.kv_tokens for r in self.running)
        c = max(self.compute, 1e-6)
        dur = (dev.reconfig_s
               + rebuild_tokens / (self.model.prefill_tokens_per_s * c)
               + (self.cfg.crash_penalty_s if crashed else 0.0))
        self.migrating = True
        self.gauge.reset()
        self.predictor = self._fresh_predictor()
        self.last_prediction = None
        # stale-state audit (provision→release cycles): the pressure
        # snapshot was measured on the slice being abandoned — a later
        # memory-forced grow reading its ``needed_compute`` would size the
        # new slice off a dead configuration
        self.last_pressure = None
        self._calm_ticks = 0
        self._requested_cum = 0.0
        kernel.schedule_reconfig(kernel.t + dur, self)
        if dev.tracer is not None:
            dev.tracer.span(
                kernel.t, kernel.t + dur, f"engine{self.eid}.grow",
                device=dev.name, lane=f"engine{self.eid}", cat="reconfig",
                from_profile=from_profile,
                to_profile=self.partition.profile.name,
                crashed=crashed, rebuild_tokens=rebuild_tokens)
        return True

    def _begin_shrink(self, kernel: EventKernel, head: float) -> bool:
        """Scale-down through the shared planner — :meth:`_begin_migration`
        run in reverse.  The shrink ladder holds every smaller profile
        that still fits the engine's live KV (plus the converged
        predictor's peak, if any); each rung carries the dynamic watts it
        surrenders and the probability the headroom forecast is wrong at
        that compute (regrow risk rises as the rung shrinks), and
        ``serving_shrink_cost`` trades the horizon's Joules against the
        reconfiguration + KV rebuild + risk-priced regrow.  The stay
        candidate scores zero on the whole trade, so a marginal saving
        never buys a migration.  Returns False when the engine keeps its
        slice (cooldown either way — a borderline forecast must not
        re-run the plan every iteration)."""
        dev = self.device
        self._calm_ticks = 0
        self._shrink_cooldown = max(self.cfg.scale_down_ticks, 10)
        floor_b = self.live_bytes(extra_tokens=len(self.running))
        if (self.cfg.use_prediction and self.last_prediction is not None
                and self.last_prediction.converged):
            floor_b = max(floor_b, self.last_prediction.peak_mem_bytes)
        floor_gb = floor_b / (self.cfg.admit_frac * GB)
        ladder = shrink_ladder(dev.backend, self.partition.profile, floor_gb)
        if not ladder:
            return False
        c = max(self.compute, 1e-6)
        util = max(0.0, 1.0 - head)
        span = dev.energy.model.p_peak_w - dev.energy.model.p_idle_w
        saved = {p.name: span * (c - p.compute_fraction) for p in ladder}
        # utilisation scales inversely with compute: the regrow risk at a
        # rung is the load it would run at, saturating at certainty
        risk = {p.name: min(1.0, util * c / max(p.compute_fraction, 1e-6))
                for p in ladder}
        rebuild_tokens = sum(r.kv_tokens for r in self.running)
        trade_cost_s = (dev.reconfig_s + rebuild_tokens
                        / (self.model.prefill_tokens_per_s * c))
        from_profile = self.partition.profile.name
        plan = dev.planner.plan(shrink_request(
            dev.backend, self.partition, floor_gb, saved, risk,
            reconfig_cost_s=trade_cost_s), model=self.shrink_cost)
        result = dev.planner.execute(plan)
        assert result is not None and result.partition is not None
        self.partition = result.partition
        self.partition.busy = True
        if isinstance(result.action, Wait):
            return False        # the trade kept the slice
        self.n_shrinks += 1
        for r in self.running:
            r.in_prefill = True          # KV is rebuilt on the new slice
        c_new = max(self.compute, 1e-6)
        dur = (dev.reconfig_s + rebuild_tokens
               / (self.model.prefill_tokens_per_s * c_new))
        self.migrating = True
        self.gauge.reset()
        self.predictor = self._fresh_predictor()
        self.last_prediction = None
        self.last_pressure = None
        self._requested_cum = 0.0
        kernel.schedule_reconfig(kernel.t + dur, self)
        if dev.tracer is not None:
            dev.tracer.span(
                kernel.t, kernel.t + dur, f"engine{self.eid}.shrink",
                device=dev.name, lane=f"engine{self.eid}", cat="reconfig",
                from_profile=from_profile,
                to_profile=self.partition.profile.name,
                headroom=head, rebuild_tokens=rebuild_tokens)
        return True

    def finish_migration(self, kernel: EventKernel) -> None:
        t = kernel.t
        self.migrating = False
        finished = []
        for r in self.running:
            # the rebuild re-ran prefill — credit it exactly as step()
            # credits a prefill iteration (the forward over the context
            # emits the next token), so migration does not skew TTFT/TPOT
            r.in_prefill = False
            if r.t_first_token is None:
                r.t_first_token = t
            r.generated += 1
            if r.generated >= r.decode_tokens:
                r.t_done = t
                finished.append(r)
        self._complete(finished, t)
        self._admit(kernel)
        self._schedule_tick(kernel)
        self.device.sync()


# ---------------------------------------------------------------------------
# The kernel policy: routing + engine lifecycle
# ---------------------------------------------------------------------------

class ServingPolicy(SchedulingPolicy):
    """Route each arriving request to the least-loaded engine in the fleet;
    engines then run themselves on TICK/RECONFIG events."""

    online = True

    def __init__(self, model: LLMServingModel, cfg: ServingConfig) -> None:
        self.model = model
        self.cfg = cfg
        self.name = cfg.name
        self.engines: list[EngineSim] = []
        self.stats = ServingStats(cfg)

    # -- engine construction ----------------------------------------------

    def on_init(self, kernel: EventKernel, jobs: list) -> None:
        eid = 0
        for dev in kernel.devices:
            for profile in self._initial_profiles(dev):
                part = dev.pm.allocate(profile)
                assert part is not None, (
                    f"cannot carve {profile.name} on {dev.name}")
                engine = EngineSim(dev, part, self.model, self.cfg, eid,
                                   stats=self.stats)
                dev.engines.append(engine)
                self.engines.append(engine)
                eid += 1

    def _initial_profiles(self, dev: ServingDevice) -> list[PartitionProfile]:
        backend = dev.backend
        if self.cfg.policy == "full":
            return [backend.profiles[-1]]
        if self.cfg.policy == "static":
            share = backend.total_mem_gb() / self.cfg.n_engines
            prof = backend.tightest_profile(share) or backend.profiles[-1]
            return [prof] * self.cfg.n_engines
        # dynamic: start on the smallest slice that holds the model at all
        floor_gb = (self.model.params_gb + self.model.activations_gb) * 1.25
        prof = backend.tightest_profile(floor_gb) or backend.profiles[-1]
        return [prof] * self.cfg.n_engines

    # -- request routing ---------------------------------------------------

    def _feasible(self, engine: EngineSim, req: ServingRequest) -> bool:
        """Whether this engine can EVER hold the request (the fleet batch
        router's ``fits`` filter, lifted to serving): its prompt KV within
        the largest slice the engine could grow to."""
        if self.cfg.policy == "dynamic":
            cap_gb = engine.device.backend.profiles[-1].mem_gb
        else:
            cap_gb = engine.partition.profile.mem_gb
        return (self.model.base_bytes() + self.model.kv_bytes(req.kv_tokens)
                <= self.cfg.admit_frac * cap_gb * GB)

    def _route(self, kernel: EventKernel, req: ServingRequest) -> None:
        feasible = [e for e in self.engines if self._feasible(e, req)]
        engine = min(feasible or self.engines,
                     key=lambda e: (e.load(), e.eid))
        engine.enqueue(kernel, req)
        engine.device.sync()

    def dispatch(self, kernel: EventKernel) -> bool:
        while kernel.queue:
            self._route(kernel, kernel.queue.pop(0))
        return False

    def on_arrival(self, kernel: EventKernel, req: ServingRequest) -> None:
        self._route(kernel, req)

    def on_tick(self, kernel: EventKernel, engine: EngineSim) -> None:
        engine.step(kernel)

    def on_reconfig(self, kernel: EventKernel, engine: EngineSim) -> None:
        engine.finish_migration(kernel)

    # -- metrics -----------------------------------------------------------

    def result(self, kernel: EventKernel,
               jobs: list) -> "ServingMetrics":
        reqs: list[ServingRequest] = list(jobs)
        makespan = max(kernel.t, 1e-9)
        if self.cfg.exact_quantiles:
            # legacy end-of-run sorts over the stored request list — the
            # bit-for-bit path the golden-parity tests pin
            completed = [r for r in reqs if r.done]
            ttfts = [r.ttft for r in completed]
            tpots = [r.tpot for r in completed]
            lats = [r.latency for r in completed]
            good = [r for r in completed
                    if r.ttft <= self.cfg.slo_ttft_s
                    and r.tpot <= self.cfg.slo_tpot_s]
            tokens = sum(r.generated for r in completed)
            n_completed, n_good = len(completed), len(good)
            mean_ttft = sum(ttfts) / max(len(ttfts), 1)
            p99_ttft = percentile(ttfts, 99)
            mean_tpot = sum(tpots) / max(len(tpots), 1)
            p99_tpot = percentile(tpots, 99)
            p99_latency = percentile(lats, 99)
        else:
            # streamed at completion time (ServingStats): P² tails, O(1)
            # memory in the number of requests
            st = self.stats
            n_completed, n_good, tokens = st.n_completed, st.n_good, st.tokens
            mean_ttft, p99_ttft = st.ttft.mean, st.ttft.percentile(99)
            mean_tpot, p99_tpot = st.tpot.mean, st.tpot.percentile(99)
            p99_latency = st.latency.percentile(99)
        return ServingMetrics(
            policy=self.name,
            fleet=", ".join(d.name for d in kernel.devices),
            n_requests=len(reqs),
            n_completed=n_completed,
            n_dropped=sum(e.n_dropped for e in self.engines),
            makespan=makespan,
            energy_j=sum(d.energy.joules for d in kernel.devices),
            mean_ttft=mean_ttft,
            p99_ttft=p99_ttft,
            mean_tpot=mean_tpot,
            p99_tpot=p99_tpot,
            p99_latency=p99_latency,
            goodput_rps=n_good / makespan,
            throughput_rps=n_completed / makespan,
            tokens_per_s=tokens / makespan,
            n_oom=sum(e.n_oom for e in self.engines),
            n_early_restarts=sum(e.n_early for e in self.engines),
            n_preemptions=sum(e.n_preemptions for e in self.engines),
            n_scaleups=sum(e.n_scaleups for e in self.engines),
            n_reconfigs=sum(d.pm.n_reconfigs for d in kernel.devices),
            n_shrinks=sum(e.n_shrinks for e in self.engines),
            n_grow_deferrals=sum(e.n_grow_deferrals
                                 for e in self.engines))


@dataclasses.dataclass
class ServingMetrics:
    policy: str
    fleet: str
    n_requests: int
    n_completed: int
    n_dropped: int
    makespan: float
    energy_j: float
    mean_ttft: float
    p99_ttft: float
    mean_tpot: float
    p99_tpot: float
    p99_latency: float
    goodput_rps: float
    throughput_rps: float
    tokens_per_s: float
    n_oom: int
    n_early_restarts: int
    n_preemptions: int
    n_scaleups: int
    n_reconfigs: int
    #: engine scale-downs committed (defaulted: metrics pinned before
    #: elasticity compare equal field-for-field)
    n_shrinks: int = 0
    #: pressure grows the reachability-floor admission gate deferred
    n_grow_deferrals: int = 0

    @property
    def energy_per_token(self) -> float:
        return self.energy_j / max(self.tokens_per_s * self.makespan, 1.0)

    @property
    def goodput_fraction(self) -> float:
        return (self.goodput_rps * self.makespan
                / max(self.n_requests, 1))

    def summary(self) -> str:
        return (f"{self.policy} on [{self.fleet}]: "
                f"{self.n_completed}/{self.n_requests} done "
                f"({self.n_dropped} dropped) in {self.makespan:.1f}s  "
                f"ttft={self.mean_ttft:.2f}s (p99 {self.p99_ttft:.2f})  "
                f"tpot={self.mean_tpot * 1e3:.0f}ms "
                f"(p99 {self.p99_tpot * 1e3:.0f})  "
                f"p99_lat={self.p99_latency:.1f}s  "
                f"goodput={self.goodput_rps:.3f}/s  "
                f"tok/s={self.tokens_per_s:.0f}  "
                f"energy={self.energy_j / 1e3:.1f}kJ  "
                f"oom={self.n_oom} early={self.n_early_restarts} "
                f"preempt={self.n_preemptions} scaleup={self.n_scaleups} "
                f"shrink={self.n_shrinks} defer={self.n_grow_deferrals} "
                f"reconf={self.n_reconfigs}")


def run_serving(device_models: Sequence[str], cfg: ServingConfig,
                requests: Iterable[ServingRequest],
                model: LLMServingModel | None = None,
                tracer=None, admission=None) -> ServingMetrics:
    """Simulate ``requests`` on a fleet of MIG devices under one serving
    policy; e.g. ``run_serving(["a100"], ServingConfig(policy="dynamic"),
    poisson_requests(200, rate_per_s=2.0))``.  ``admission`` (an
    :class:`~repro_torch.core.scheduler.admission.AdmissionController`) gates
    pressure-driven engine growth behind the fleet's reachability floor.

    Thin shim over :func:`repro_torch.api.simulate` — the facade owns
    construction, so facade and legacy callers share one code path."""
    from repro_torch.api import RunSpec, simulate
    return simulate(RunSpec(kind="serving", devices=list(device_models),
                            serving=cfg, requests=list(requests),
                            serving_model=model, tracer=tracer,
                            admission=admission))
