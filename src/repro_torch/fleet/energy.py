"""Fleet-level energy accounting; the port's copy of
``repro.fleet.energy``.

Each device integrates its own piecewise-constant power curve (dynamic over
kernel time + idle floor, or the gated floor when the orchestrator has
power-gated it).  The fleet integrator aggregates those curves and reports
where the joules went — in particular how much idle-floor energy
consolidation + gating avoided, which is exactly the quantity the
energy-aware router optimizes.  The priced variant additionally converts
joules to dollars through a time-of-day tariff, which is what a zone hands
the cluster-level router (arXiv:2501.17752: per-zone power pricing as a
first-class cost feature).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

from repro_torch.core.scheduler.events import DeviceSim


@dataclasses.dataclass(frozen=True)
class DeviceEnergyReport:
    device: str
    joules: float
    gated_seconds: float
    idle_joules_avoided: float   # (p_idle - p_gated) * gated time


class FleetEnergyIntegrator:
    """Charges idle power only to non-gated devices.

    The mechanism is per-device: a gated :class:`DeviceSim` integrates at
    ``p_gated_w`` instead of ``p_idle_w``, and the event kernel advances
    every device to each event's timestamp (so fleet totals are
    well-defined).  This aggregator sums/attributes the result.
    """

    def __init__(self, devices: Sequence[DeviceSim]) -> None:
        self.devices = list(devices)

    @property
    def joules(self) -> float:
        return sum(d.energy.joules for d in self.devices)

    @property
    def gated_seconds(self) -> float:
        return sum(d.energy.gated_seconds for d in self.devices)

    @property
    def idle_joules_avoided(self) -> float:
        return sum((d.energy.model.p_idle_w - d.energy.model.p_gated_w)
                   * d.energy.gated_seconds for d in self.devices)

    def breakdown(self) -> list[DeviceEnergyReport]:
        return [DeviceEnergyReport(
            device=d.name, joules=d.energy.joules,
            gated_seconds=d.energy.gated_seconds,
            idle_joules_avoided=(d.energy.model.p_idle_w
                                 - d.energy.model.p_gated_w)
            * d.energy.gated_seconds) for d in self.devices]

    def cost_summary(self) -> "FleetCostSummary":
        """The fleet's current standing as cost-model features — what an
        external (cluster-level) router reads when ranking this fleet
        against its peers."""
        awake = [d for d in self.devices if not d.gated]
        n = max(len(self.devices), 1)
        return FleetCostSummary(
            joules=self.joules,
            gated_seconds=self.gated_seconds,
            idle_joules_avoided=self.idle_joules_avoided,
            idle_power_w=sum(d.energy.model.p_idle_w for d in self.devices),
            awake_idle_power_w=sum(d.energy.model.p_idle_w for d in awake),
            load=sum(d.load_fraction() for d in self.devices) / n,
            free_mem_gb=sum(d.free_mem_gb() for d in self.devices))


@dataclasses.dataclass(frozen=True)
class FleetCostSummary:
    """One fleet condensed to the quantities zone ranking scores."""

    joules: float
    gated_seconds: float
    idle_joules_avoided: float
    idle_power_w: float          # idle floor of the whole fleet, watts
    awake_idle_power_w: float    # idle floor currently burning (non-gated)
    load: float                  # mean device load fraction
    free_mem_gb: float


class PricedEnergyIntegrator(FleetEnergyIntegrator):
    """A fleet integrator that also turns joules into dollars through a
    time-of-day price curve (``price_at(t)`` in $/J).

    Devices integrate power piecewise between kernel events; ``observe``
    must be called at every event timestamp (the cluster policy does this
    each dispatch round), so each joule delta is billed at the tariff
    midpoint of its interval — exact up to the tariff's variation within
    one event gap (seconds, against a curve that moves over hours).
    """

    def __init__(self, devices: Sequence[DeviceSim],
                 price_at: Callable[[float], float]) -> None:
        super().__init__(devices)
        self.price_at = price_at
        self.dollars = 0.0
        self._last_t = 0.0
        self._last_joules = self.joules

    def observe(self, t: float) -> None:
        delta = self.joules - self._last_joules
        if delta > 0.0:
            self.dollars += delta * self.price_at(0.5 * (self._last_t + t))
        if t > self._last_t:
            self._last_t = t
        self._last_joules = self.joules
