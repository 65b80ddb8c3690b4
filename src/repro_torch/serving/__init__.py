"""Serving: continuous-batching LLM inference on MIG slices; the port's
copy of ``repro.serving``'s exports.

* :mod:`repro_torch.serving.sim` — the event-kernel serving simulator
  (:class:`EngineSim` per slice: decode ticks, KV-cache growth,
  SLO-pressure growth, headroom-forecast shrink); host code that launches
  nothing on a card.
* :mod:`repro_torch.serving.slo` — TTFT gauges (:class:`QueueTickGauge`,
  :class:`PredictiveSLOGauge`) and the :class:`SLOPressure` signal.
* :mod:`repro_torch.serving.engine` — the torch single-engine runtime
  (imported lazily, as the reference imports its engine: the simulator's
  users need not load the model layer).
"""

from repro_torch.serving.sim import (EngineSim, LLMServingModel,
                                     ServingConfig, ServingDevice,
                                     ServingMetrics, ServingPolicy,
                                     ServingRequest, diurnal_requests,
                                     poisson_requests, run_serving)
from repro_torch.serving.slo import (PredictiveSLOGauge, QueueTickGauge,
                                     SLOGauge, SLOPressure, make_gauge)

#: names resolved lazily from the engine module.
_ENGINE_EXPORTS = ("EngineConfig", "Request", "ServeEngine")


def __getattr__(name: str):
    if name in _ENGINE_EXPORTS:
        from repro_torch.serving import engine
        value = getattr(engine, name)
        globals()[name] = value     # cache: __getattr__ runs once per name
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "EngineConfig", "EngineSim", "LLMServingModel", "PredictiveSLOGauge",
    "QueueTickGauge", "Request", "SLOGauge", "SLOPressure", "ServeEngine",
    "ServingConfig", "ServingDevice", "ServingMetrics", "ServingPolicy",
    "ServingRequest", "diurnal_requests", "make_gauge", "poisson_requests",
    "run_serving",
]
