"""Time-of-day energy tariffs — the price axis of cluster-level planning;
the port's copy of ``repro.cluster.tariff``.

The paper's energy wins come from partition decisions on one GPU; at
cluster scale the same joules cost different *dollars* depending on where
and when they burn (arXiv:2501.17752 motivates per-zone power pricing as a
first-class cost feature).  A :class:`ZoneTariff` is a sinusoidal $/kWh
curve between an off-peak trough (local midnight) and a daytime peak,
phase-shifted into the zone's local clock — the same shape as the diurnal
arrival generator, so a zone's expensive hours are exactly the hours its
own users submit the most work.
"""

from __future__ import annotations

import dataclasses
import math

#: $/kWh -> $/J (1 kWh = 3.6e6 J).
USD_PER_KWH_TO_USD_PER_J = 1.0 / 3.6e6


@dataclasses.dataclass(frozen=True)
class ZoneTariff:
    """A zone's electricity price curve, queryable in $/J at any sim time.

    ``price_at`` bottoms out at local t=0 ("night") and peaks half a period
    later, mirroring :func:`repro_torch.fleet.arrivals.diurnal_arrivals`;
    ``phase_s`` converts global sim time to the zone's local clock.
    """

    name: str
    trough_usd_per_kwh: float
    peak_usd_per_kwh: float
    period_s: float = 86400.0
    phase_s: float = 0.0

    def __post_init__(self) -> None:
        if not 0.0 < self.trough_usd_per_kwh <= self.peak_usd_per_kwh:
            raise ValueError(
                f"{self.name}: need 0 < trough <= peak, got "
                f"{self.trough_usd_per_kwh} / {self.peak_usd_per_kwh}"
            )
        if self.period_s <= 0.0:
            raise ValueError(f"{self.name}: period_s must be positive")

    @classmethod
    def flat(cls, usd_per_kwh: float, name: str = "flat") -> "ZoneTariff":
        """A constant price — the degenerate curve single-zone baselines
        and unit tests pin against."""
        return cls(name, usd_per_kwh, usd_per_kwh)

    def _mid_amp(self) -> tuple[float, float]:
        mid = 0.5 * (self.trough_usd_per_kwh + self.peak_usd_per_kwh)
        amp = 0.5 * (self.peak_usd_per_kwh - self.trough_usd_per_kwh)
        return mid, amp

    def price_at(self, t: float) -> float:
        """Instantaneous price in $ per JOULE at global sim time ``t``."""
        mid, amp = self._mid_amp()
        usd_kwh = mid - amp * math.cos(
            2.0 * math.pi * (t + self.phase_s) / self.period_s
        )
        return usd_kwh * USD_PER_KWH_TO_USD_PER_J

    def mean_price(self, t0: float, t1: float) -> float:
        """Exact mean $/J over ``[t0, t1]`` (closed-form sinusoid integral)
        — what follow-the-sun routing scores a job's whole run window with
        instead of the instantaneous price."""
        if t1 <= t0:
            return self.price_at(t0)
        mid, amp = self._mid_amp()
        w = 2.0 * math.pi / self.period_s
        sines = math.sin(w * (t1 + self.phase_s)) - math.sin(w * (t0 + self.phase_s))
        usd_kwh = mid - amp * sines / (w * (t1 - t0))
        return usd_kwh * USD_PER_KWH_TO_USD_PER_J
