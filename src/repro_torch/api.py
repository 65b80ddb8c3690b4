"""One entrypoint vocabulary for every simulation; the port's copy of
``repro.api``.

The six legacy entrypoints (``run_baseline`` / ``run_scheme_a`` /
``run_scheme_b`` / ``run_serving`` / ``run_fleet`` / ``run_cluster``) and
the two orchestrator classes grew inconsistent keyword surfaces —
``tracer=`` threaded differently everywhere, ``admission=`` existed only
on the fleet, ``FleetOrchestrator.run`` duplicated ``run_fleet``.  This
module is the redesign: a :class:`RunSpec` names *what* to simulate, and
:func:`simulate` owns all construction (device sims, policies, the event
kernel).  Every legacy entrypoint is now a thin shim building a RunSpec —
one code path, so facade-vs-legacy metric equality is structural, not
merely tested.

Imports are deliberately lazy inside :func:`simulate`: the legacy shims
live in the modules this facade drives, and a module-level import either
way would cycle.

The port runs the single-device batch kinds, the serving simulator and
the fleet.  The kind ``cluster`` drives a module the port has not copied
yet (ROADMAP item 16e), so it raises ``NotImplementedError`` naming the
item.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Sequence

#: RunSpec.kind values simulate() accepts, in documentation order.
KINDS = ("baseline", "scheme_a", "scheme_b", "serving", "fleet", "cluster")

#: the kinds whose modules the port has not copied yet -> the ROADMAP item
#: that brings them
_NOT_PORTED = {
    "cluster": "the cluster layer (ROADMAP item 16e)",
}


@dataclasses.dataclass
class RunSpec:
    """A declarative description of one simulation run.

    Only ``kind`` is always required; each kind reads its own subset of
    fields (documented per field) and ignores the rest.  ``tracer`` and
    ``admission`` mean the same thing for every kind that supports them
    — that uniformity is the point of the facade.
    """

    #: which simulation to run — one of :data:`KINDS`.
    kind: str
    #: batch / fleet / cluster workloads: the Job list (batch kinds,
    #: ``fleet``, ``cluster``).
    jobs: Iterable[Any] | None = None
    #: single-device batch kinds: the partition backend to schedule on.
    backend: Any = None
    #: single-device batch kinds: the device power model.
    power: Any = None
    #: ``scheme_a`` / ``scheme_b``: enable the peak-memory predictor.
    use_prediction: bool = True
    #: ``scheme_a``: pull-based dispatch instead of static division.
    work_steal: bool = False
    #: ``scheme_a``: beam width for k-step plan-ahead carving
    #: (:mod:`repro_torch.core.planner.lookahead`); 0 = the greedy seed loop.
    plan_ahead: int = 0
    #: ``serving``: device-model names (``["a100", "h100"]``);
    #: ``fleet``: the DeviceSim list.
    devices: Sequence[Any] | None = None
    #: ``fleet``: the device Router; ``cluster``: the ZoneRouter.
    router: Any = None
    #: ``cluster``: the Zone list.
    zones: Sequence[Any] | None = None
    #: ``cluster``: job name -> home zone name (data-gravity origins).
    origin: Mapping[str, str] | None = None
    #: ``fleet`` / ``cluster``: seconds to wake a power-gated device;
    #: None = the catalogue default (WAKE_LATENCY_S).
    wake_latency_s: float | None = None
    #: ``fleet`` / ``serving``: reachability-floor AdmissionController;
    #: None admits freely (the pre-elasticity behaviour).
    admission: Any = None
    #: ``fleet``: a pre-built FleetEnergyIntegrator (the orchestrator
    #: shim passes its own so repeated ``run`` calls keep accumulating).
    energy: Any = None
    #: ``serving``: the ServingConfig.
    serving: Any = None
    #: ``serving``: the ServingRequest iterable.
    requests: Iterable[Any] | None = None
    #: ``serving``: the LLMServingModel; None = the default 7B-class.
    serving_model: Any = None
    #: every kind: a repro_torch.obs Tracer, or None.
    tracer: Any = None


def simulate(spec: RunSpec):
    """Run the simulation ``spec`` describes and return its metrics.

    The return type matches the kind: ``Metrics`` for the single-device
    batch kinds, ``ServingMetrics`` for ``"serving"``, ``FleetMetrics``
    for ``"fleet"``, ``ClusterMetrics`` for ``"cluster"`` — exactly the
    dataclasses the legacy entrypoints returned, and (pinned by
    tests/test_torch_scheduler.py) dataclass-equal to them, because the
    legacy entrypoints are shims over this function.

    Raises ``ValueError`` for an unknown ``spec.kind`` and
    ``NotImplementedError`` for a kind whose modules are not ported yet.
    """
    kind = spec.kind
    if kind == "baseline":
        from repro_torch.core.scheduler.events import DeviceSim
        from repro_torch.core.scheduler.kernel import EventKernel
        from repro_torch.core.scheduler.policies import BaselinePolicy
        sim = DeviceSim(spec.backend, spec.power, use_prediction=False,
                        policy="baseline")
        return EventKernel([sim], BaselinePolicy(),
                           tracer=spec.tracer).run(spec.jobs)
    if kind == "scheme_a":
        from repro_torch.core.scheduler.events import DeviceSim
        from repro_torch.core.scheduler.kernel import EventKernel
        from repro_torch.core.scheduler.policies import SchemeAPolicy
        policy = SchemeAPolicy(spec.use_prediction, spec.work_steal,
                               plan_ahead=spec.plan_ahead)
        sim = DeviceSim(spec.backend, spec.power, spec.use_prediction,
                        policy=policy.name)
        return EventKernel([sim], policy, tracer=spec.tracer).run(spec.jobs)
    if kind == "scheme_b":
        from repro_torch.core.scheduler.events import DeviceSim
        from repro_torch.core.scheduler.kernel import EventKernel
        from repro_torch.core.scheduler.policies import SchemeBPolicy
        policy = SchemeBPolicy(spec.use_prediction)
        sim = DeviceSim(spec.backend, spec.power, spec.use_prediction,
                        policy=policy.name)
        return EventKernel([sim], policy, tracer=spec.tracer).run(spec.jobs)
    if kind == "serving":
        from repro_torch.core.scheduler.kernel import EventKernel
        from repro_torch.serving.sim import (LLMServingModel, ServingDevice,
                                             ServingPolicy)
        counts: dict[str, int] = {}
        devices = []
        for m in spec.devices or []:
            idx = counts.get(m, 0)
            counts[m] = idx + 1
            devices.append(ServingDevice(m, name=f"{m}-{idx}"))
        if spec.admission is not None:
            for dev in devices:
                dev.admission = spec.admission
        policy = ServingPolicy(spec.serving_model or LLMServingModel(),
                               spec.serving)
        return EventKernel(devices, policy,
                           tracer=spec.tracer).run(spec.requests)
    if kind == "fleet":
        from repro_torch.core.scheduler.kernel import EventKernel
        from repro_torch.fleet.devices import WAKE_LATENCY_S
        from repro_torch.fleet.energy import FleetEnergyIntegrator
        from repro_torch.fleet.orchestrator import FleetPolicy
        devices = list(spec.devices or [])
        wake = (WAKE_LATENCY_S if spec.wake_latency_s is None
                else spec.wake_latency_s)
        energy = spec.energy or FleetEnergyIntegrator(devices)
        policy = FleetPolicy(spec.router, wake, energy,
                             admission=spec.admission)
        return EventKernel(devices, policy,
                           tracer=spec.tracer).run(spec.jobs)
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"RunSpec.kind {kind!r} needs {_NOT_PORTED[kind]}, which the "
            f"port does not have yet")
    raise ValueError(f"unknown RunSpec.kind {kind!r}; known: {list(KINDS)}")
