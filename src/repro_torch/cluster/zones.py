"""Zones: one fleet + one tariff + one local clock; the port's copy of
``repro.cluster.zones``.

A zone is the unit the hierarchical router ranks — a
:class:`~repro_torch.core.scheduler.events.DeviceSim` fleet with its own device
catalogue, an energy tariff in the zone's local time, an intra-zone device
router, and the diurnal phase offset its users submit work on.  Device
names are prefixed ``<zone>/`` so one event kernel can drive every zone's
devices on a single global clock.
"""

from __future__ import annotations

import dataclasses

from repro_torch.cluster.tariff import ZoneTariff
from repro_torch.core.scheduler.events import DeviceSim
from repro_torch.core.scheduler.job import Job
from repro_torch.fleet.devices import make_device
from repro_torch.fleet.router import Router, make_router

#: Inter-zone link bandwidth a checkpoint/input transfer sees (GB/s).
CROSS_ZONE_GBPS = 10.0

#: Fixed per-transfer handshake (connection + checkpoint manifest RTTs).
CROSS_ZONE_SETUP_S = 0.25


@dataclasses.dataclass
class Zone:
    """One energy zone of the cluster."""

    name: str
    devices: list[DeviceSim]
    router: Router
    tariff: ZoneTariff
    phase_s: float = 0.0  # local-clock offset of arrivals AND tariff

    def feasible(self, job: Job) -> bool:
        return any(d.fits(job) for d in self.devices)

    def load_fraction(self) -> float:
        if not self.devices:
            return 0.0
        return sum(d.load_fraction() for d in self.devices) / len(self.devices)

    def idle_power_w(self) -> float:
        """Mean idle floor of the zone's devices — the wattage the tariff
        weights when the cluster router prices this zone."""
        if not self.devices:
            return 0.0
        return sum(d.energy.model.p_idle_w for d in self.devices) / len(self.devices)


def make_zone(
    name: str,
    shape: list[str],
    tariff: ZoneTariff,
    router: str | Router = "energy_aware",
    phase_s: float = 0.0,
    use_prediction: bool = True,
) -> Zone:
    """Build a zone from a fleet shape, e.g. ``make_zone("eu-west",
    ["a100", "a100", "h100"], tariff, phase_s=200.0)``.

    ``phase_s`` places the zone on the globe: it shifts both the tariff
    (applied on top of any phase the tariff already carries) and, via
    :func:`repro_torch.cluster.workload.cluster_workload`, the zone's diurnal
    arrival clock.
    """
    counts: dict[str, int] = {}
    devices = []
    for model in shape:
        idx = counts.get(model, 0)
        counts[model] = idx + 1
        devices.append(
            make_device(
                model,
                name=f"{name}/{model}-{idx}",
                use_prediction=use_prediction,
            )
        )
    if isinstance(router, str):
        router = make_router(router)
    tariff = dataclasses.replace(
        tariff, name=f"{tariff.name}@{name}", phase_s=tariff.phase_s + phase_s
    )
    return Zone(
        name=name, devices=devices, router=router, tariff=tariff, phase_s=phase_s
    )


def checkpoint_movement_s(
    job: Job,
    from_zone: str | None,
    to_zone: str,
    gbps: float = CROSS_ZONE_GBPS,
) -> float:
    """Seconds to move a job's state between zones: proportional to its
    checkpoint size (the scheduler's memory estimate — what would actually
    be serialized) plus a fixed handshake.  Zero when the job stays where
    its data already lives or has no prior location."""
    if from_zone is None or from_zone == to_zone:
        return 0.0
    size_gb = job.est_mem_gb if job.est_mem_gb is not None else 0.0
    return CROSS_ZONE_SETUP_S + size_gb / max(gbps, 1e-9)
