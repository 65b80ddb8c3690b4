"""PyTorch/CUDA port of the MIG serving workload, held against ``repro``.

The JAX package ``repro`` is the reference; this package computes the same
functions in PyTorch, with every Pallas TPU kernel on its path rewritten by
hand for Hopper (``kernels/csrc``).  It imports neither JAX nor ``repro``.
Importing it builds and loads nothing: kernels compile at first use.

The curated top-level surface (everything in ``__all__``) is the
reference's and resolves lazily, so ``import repro_torch`` loads neither torch nor a
simulator until a name is touched: the host-only layers (the
simulators, ``python -m repro_torch.control``) never import torch.  The front
door for simulations is :class:`repro_torch.api.RunSpec` +
:func:`repro_torch.api.simulate`; for live provisioning it is
:class:`repro_torch.control.ControlPlane`.  ``resolve_device`` picks the
card unless the caller asks for the CPU.

The legacy per-layer entrypoints (``run_serving`` and friends) remain
supported *in their home modules*; their top-level aliases here are
deprecated and warn once, steering callers to ``simulate()``.
"""

from __future__ import annotations

import warnings

#: curated surface: public name -> home module (resolved lazily).
_EXPORTS = {
    # the facade
    "KINDS": "repro_torch.api",
    "RunSpec": "repro_torch.api",
    "simulate": "repro_torch.api",
    # the control plane
    "ControlPlane": "repro_torch.control",
    "Lease": "repro_torch.control",
    # planner actions — the typed vocabulary every layer shares
    "Grow": "repro_torch.core.planner",
    "Migrate": "repro_torch.core.planner",
    "Shrink": "repro_torch.core.planner",
    "Wait": "repro_torch.core.planner",
    # admission + routing
    "AdmissionController": "repro_torch.core.scheduler.admission",
    "make_router": "repro_torch.fleet.router",
    "make_zone_router": "repro_torch.cluster.policies",
    # serving gauges
    "PredictiveSLOGauge": "repro_torch.serving.slo",
    "QueueTickGauge": "repro_torch.serving.slo",
    "SLOGauge": "repro_torch.serving.slo",
    "make_gauge": "repro_torch.serving.slo",
    # telemetry
    "Tracer": "repro_torch.obs",
    # the port's device rule: the card unless the caller asks for the CPU
    "resolve_device": "repro_torch.device",
}

#: deprecated top-level aliases: name -> (home module, successor hint).
_DEPRECATED = {
    "run_baseline": ("repro_torch.core.scheduler.policies",
                     "repro_torch.api.simulate"),
    "run_scheme_a": ("repro_torch.core.scheduler.policies",
                     "repro_torch.api.simulate"),
    "run_scheme_b": ("repro_torch.core.scheduler.policies",
                     "repro_torch.api.simulate"),
    "run_serving": ("repro_torch.serving.sim", "repro_torch.api.simulate"),
    "run_fleet": ("repro_torch.fleet.orchestrator",
                  "repro_torch.api.simulate"),
    "run_cluster": ("repro_torch.cluster.orchestrator",
                    "repro_torch.api.simulate"),
}


def __getattr__(name: str):
    import importlib
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name]), name)
    elif name in _DEPRECATED:
        module, successor = _DEPRECATED[name]
        warnings.warn(
            f"repro_torch.{name} is deprecated; import it from {module} or "
            f"use {successor}(RunSpec(...))", DeprecationWarning,
            stacklevel=2)
        value = getattr(importlib.import_module(module), name)
    else:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value   # cache: resolve (and warn) only once
    return value


def __dir__() -> list[str]:
    return sorted(set(globals()) | set(_EXPORTS) | set(_DEPRECATED))


__all__ = sorted(_EXPORTS)
