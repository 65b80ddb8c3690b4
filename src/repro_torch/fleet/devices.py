"""Device catalogue: build a per-device simulator from a model name; the
port's copy of ``repro.fleet.devices``.

Each fleet device is an independent :class:`DeviceSim` — its own partition
FSM, clock, energy integrator and reconfiguration cost.  MIG reconfiguration
is an nvidia-smi round-trip on both generations; TPU slice reshaping goes
through the pod controller and costs noticeably more.
"""

from __future__ import annotations

from repro_torch.core.mig_a100 import MigA100Backend
from repro_torch.core.mig_h100 import MigH100Backend
from repro_torch.core.scheduler.energy import (A100_POWER, H100_POWER,
                                               DevicePowerModel,
                                               pod_power_model)
from repro_torch.core.scheduler.events import RECONFIG_COST_S, DeviceSim
from repro_torch.core.tpu_slices import TpuPodBackend

#: seconds to bring a power-gated device back (persistence mode and a
#: re-init of the GPU on MIG parts; pod controller handshake on TPU
#: slices).
WAKE_LATENCY_S = 1.5

#: model -> (backend factory, power model, reconfig seconds)
DEVICE_CATALOGUE = {
    "a100": (MigA100Backend, A100_POWER, RECONFIG_COST_S),
    "h100": (MigH100Backend, H100_POWER, RECONFIG_COST_S),
    "tpu-v5e": (TpuPodBackend, pod_power_model(256), 2.0),
}


def make_device(model: str, name: str | None = None,
                use_prediction: bool = True,
                power: DevicePowerModel | None = None,
                record_runs: bool = True) -> DeviceSim:
    """One fleet device, e.g. ``make_device("h100", name="h100-0")``."""
    try:
        backend_cls, default_power, reconfig_s = DEVICE_CATALOGUE[model]
    except KeyError:
        raise ValueError(f"unknown device model {model!r}; "
                         f"known: {sorted(DEVICE_CATALOGUE)}") from None
    return DeviceSim(backend_cls(), power or default_power,
                     use_prediction=use_prediction, policy=name or model,
                     name=name or model, reconfig_cost_s=reconfig_s,
                     record_runs=record_runs)


def make_fleet(shape: list[str] | dict[str, int],
               use_prediction: bool = True,
               record_runs: bool = True) -> list[DeviceSim]:
    """Build a fleet from ``["a100", "a100", "h100"]`` or ``{"a100": 2,
    "h100": 2}``; names are ``model-<index>``."""
    if isinstance(shape, dict):
        shape = [m for m, count in shape.items() for _ in range(count)]
    counts: dict[str, int] = {}
    devices = []
    for model in shape:
        idx = counts.get(model, 0)
        counts[model] = idx + 1
        devices.append(make_device(model, name=f"{model}-{idx}",
                                   use_prediction=use_prediction,
                                   record_runs=record_runs))
    return devices
