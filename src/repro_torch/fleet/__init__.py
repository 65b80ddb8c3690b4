"""Fleet-level orchestration: N heterogeneous devices (A100 MIG, H100 MIG,
TPU slices) behind one global admission queue; the port's copy of
``repro.fleet``.  Host code that models the devices; nothing here
launches work on a card.

The paper manages partitions on a *single* A100; this package scales the
same machinery to a fleet: each device runs its own
:class:`~repro_torch.core.scheduler.events.DeviceSim` (clock, reconfig costs,
OOM/early-restart paths) and a pluggable router decides which device admits
each arriving job.  Consolidation routing packs load so idle devices can be
power-gated — the fleet-level energy headroom single-device scheduling
cannot reach (MISO, arXiv:2207.11428; optimal MIG placement,
arXiv:2409.06646).
"""

from repro_torch.core.scheduler.admission import (AdmissionController,
                                                  AdmissionDecision,
                                                  ArrivalForecast, reach_floor)
from repro_torch.fleet.arrivals import (diurnal_arrivals, iter_alibaba_csv,
                                        iter_jobs_from_trace,
                                        iter_synthetic_alibaba_rows,
                                        jobs_from_trace, load_alibaba_csv,
                                        poisson_arrivals,
                                        synthetic_alibaba_rows,
                                        write_alibaba_csv)
from repro_torch.fleet.devices import make_device, make_fleet
from repro_torch.fleet.energy import (FleetCostSummary, FleetEnergyIntegrator,
                                      PricedEnergyIntegrator)
from repro_torch.fleet.index import RoutingIndex
from repro_torch.fleet.orchestrator import (FleetMetrics, FleetOrchestrator,
                                            FleetPolicy, run_fleet)
from repro_torch.fleet.router import (BestFitRouter, CostRouter,
                                      EnergyAwareRouter, RandomRouter, Router,
                                      RoundRobinRouter, device_cost_terms,
                                      make_router)

__all__ = [
    "AdmissionController", "AdmissionDecision", "ArrivalForecast",
    "BestFitRouter", "CostRouter", "EnergyAwareRouter", "FleetCostSummary",
    "FleetEnergyIntegrator", "FleetMetrics", "FleetOrchestrator",
    "FleetPolicy", "PricedEnergyIntegrator", "RandomRouter", "Router",
    "RoundRobinRouter", "RoutingIndex", "device_cost_terms",
    "diurnal_arrivals",
    "iter_alibaba_csv", "iter_jobs_from_trace",
    "iter_synthetic_alibaba_rows", "jobs_from_trace", "load_alibaba_csv",
    "make_device", "make_fleet", "make_router", "poisson_arrivals",
    "reach_floor", "run_fleet", "synthetic_alibaba_rows",
    "write_alibaba_csv",
]
