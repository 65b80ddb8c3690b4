"""Device power/energy model; the port's copy of
``repro.core.scheduler.energy``.

The paper's §5 polls nvidia-smi at 0.1s; here the discrete-event
simulator integrates the same quantity analytically:

    P(t) = P_idle + (P_peak - P_idle) * sum_j min(c_j, demand_j)

where the sum runs over jobs active at time t, ``c_j`` is the compute
fraction of job j's slice and ``demand_j`` its usable parallelism — idle
slices burn no dynamic power but the device's idle floor is always paid,
which is exactly why shorter makespans save energy (the paper's observation
that energy tracks throughput).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DevicePowerModel:
    name: str
    p_idle_w: float
    p_peak_w: float
    #: residual draw when the device is power-gated (persistence mode off /
    #: rail suspended) — a fleet orchestrator that consolidates load can
    #: drop idle devices to this floor instead of ``p_idle_w``.
    p_gated_w: float = 0.0

    def power(self, active_compute_fraction: float) -> float:
        u = min(max(active_compute_fraction, 0.0), 1.0)
        return self.p_idle_w + (self.p_peak_w - self.p_idle_w) * u


#: A100 40GB PCIe: 250W TDP, ~55W idle (measured ranges in the literature).
A100_POWER = DevicePowerModel("a100-40gb-pcie", p_idle_w=55.0, p_peak_w=250.0,
                              p_gated_w=7.0)

#: H100 80GB SXM: 700W TDP; Hopper idles higher than Ampere (~70-90W).
H100_POWER = DevicePowerModel("h100-80gb-sxm", p_idle_w=75.0, p_peak_w=700.0,
                              p_gated_w=10.0)

#: One v5e chip: ~200W peak, ~65W idle; a pod-slice model scales by chips.
V5E_CHIP_POWER = DevicePowerModel("tpu-v5e-chip", p_idle_w=65.0,
                                  p_peak_w=200.0, p_gated_w=8.0)


def pod_power_model(n_chips: int = 256) -> DevicePowerModel:
    return DevicePowerModel(
        f"tpu-v5e-pod-{n_chips}",
        p_idle_w=V5E_CHIP_POWER.p_idle_w * n_chips,
        p_peak_w=V5E_CHIP_POWER.p_peak_w * n_chips,
        p_gated_w=V5E_CHIP_POWER.p_gated_w * n_chips)


class EnergyIntegrator:
    """Piecewise-constant power integration over the event timeline.

    A gated device pays ``p_gated_w`` instead of the idle floor; gating is
    only legal while nothing runs (``active == 0``), which the fleet
    orchestrator guarantees by consolidating load first.
    """

    def __init__(self, model: DevicePowerModel) -> None:
        self.model = model
        self._t = 0.0
        self._active = 0.0
        self._gated = False
        self.joules = 0.0
        self.gated_seconds = 0.0

    @property
    def gated(self) -> bool:
        return self._gated

    def advance(self, t: float, active_compute_fraction: float) -> None:
        """Integrate up to ``t`` with the *previous* utilization, then switch
        to the new utilization."""
        if t < self._t - 1e-9:
            raise ValueError(f"time went backwards: {t} < {self._t}")
        if self._gated and active_compute_fraction > 0.0:
            raise ValueError("cannot run work on a power-gated device")
        p = (self.model.p_gated_w if self._gated
             else self.model.power(self._active))
        self.joules += p * (t - self._t)
        if self._gated:
            self.gated_seconds += t - self._t
        self._t = t
        self._active = active_compute_fraction

    def set_gated(self, gated: bool) -> None:
        """Flip the gate at the current time (advance to 'now' first)."""
        if gated and self._active > 0.0:
            raise ValueError("cannot power-gate a device with running work")
        self._gated = gated
