"""The control plane: one facade over provisioning, leases and elasticity;
the port's copy of ``repro.control.plane``.

The SLO-aware serving work left the elasticity loop half-open: engines
could grow under SLO pressure and fleets could defer admission, but nothing owned the *lease*
— who holds which slice, for how long, and what happens when a holder
goes quiet.  :class:`ControlPlane` closes that loop behind five verbs:

``provision``
    carve a slice for a named workload through the shared partition
    planner (argmax-|F_s| placement, reshape when fragmented), gated by
    the fleet's reachability-floor
    :class:`~repro_torch.core.scheduler.admission.AdmissionController` so a
    grant that would collapse the guarantee floor is *deferred* (queued,
    retried on release/tick) instead of thrashing the FSM.
``heartbeat``
    renew a lease's liveness window.
``extend_lease``
    push a lease's expiry out without resetting the window.
``release``
    free the slice and retry the deferred queue against the recovered
    capacity.
``status``
    a JSON-able snapshot of every device FSM, lease and counter.

Everything is deterministic: the clock only moves when an operation
carries a timestamp (``tick`` for pure time passage), so a ledger of
operations replays to the identical plane — that is how the
``python -m repro_torch.control`` CLI persists state between invocations
(:mod:`repro_torch.control.__main__`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable, Mapping, Sequence

from repro_torch.core.partition_manager import Partition, PartitionManager
from repro_torch.core.planner import (SCHEME_B_COST, PartitionPlanner, Wait,
                                place_request)

#: liveness window granted to a lease when the caller does not pick one.
DEFAULT_LEASE_S = 60.0


@dataclasses.dataclass
class Lease:
    """One provisioned slice plus its liveness contract.

    A lease stays valid while heartbeats (or extensions) keep
    ``expires_t`` ahead of the plane clock; :meth:`ControlPlane.tick`
    reclaims the slice the moment the contract lapses.
    """

    #: workload name — the plane-wide unique handle for every verb.
    name: str
    #: device the slice was carved on.
    device: str
    #: FSM partition id backing the lease.
    pid: int
    #: granted profile name (may exceed the asked ``mem_gb``).
    profile: str
    #: memory the caller asked for, in GB.
    mem_gb: float
    #: compute fraction the caller asked for (soft constraint).
    compute: float
    #: plane time the slice was carved.
    granted_t: float
    #: liveness window a heartbeat renews, in seconds.
    duration_s: float
    #: plane time the lease lapses unless renewed.
    expires_t: float
    #: heartbeats received.
    n_heartbeats: int = 0
    #: explicit extensions received.
    n_extensions: int = 0

    def remaining_s(self, t: float) -> float:
        """Seconds of liveness left at plane time ``t`` (0 when lapsed)."""
        return max(self.expires_t - t, 0.0)

    def to_dict(self) -> dict[str, Any]:
        """The lease as a JSON-able dict (CLI ``status`` payload)."""
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class _Ask:
    """A provision request as queued on the deferred list."""

    name: str
    mem_gb: float
    compute: float
    duration_s: float
    #: getattr'd by ArrivalForecast.observe — keep the fleet's spelling.
    @property
    def est_mem_gb(self) -> float:
        return self.mem_gb


class _PlaneDevice:
    """One FSM-backed device under plane control (no event kernel — the
    plane is an operator surface, not a simulator)."""

    def __init__(self, model: str, name: str) -> None:
        from repro_torch.fleet.devices import DEVICE_CATALOGUE
        try:
            backend_cls, power, reconfig_s = DEVICE_CATALOGUE[model]
        except KeyError:
            raise ValueError(
                f"unknown device model {model!r}; "
                f"known: {sorted(DEVICE_CATALOGUE)}") from None
        self.model = model
        self.name = name
        self.backend = backend_cls()
        self.pm = PartitionManager(self.backend)
        self.planner = PartitionPlanner(self.pm, SCHEME_B_COST)
        self.power = power
        self.reconfig_s = reconfig_s

    def snapshot(self, holders: Mapping[tuple[str, int], str]
                 ) -> dict[str, Any]:
        return {
            "name": self.name,
            "model": self.model,
            "state": str(self.pm.state),
            "reach": self.pm.reach(self.pm.state),
            "n_reconfigs": self.pm.n_reconfigs,
            "partitions": [
                {"pid": p.pid, "profile": p.profile.name,
                 "lease": holders.get((self.name, p.pid), "")}
                for p in self.pm.live.values()
            ],
        }


class ControlPlane:
    """Provision / heartbeat / extend / release leases over MIG devices.

    ``devices`` is a sequence of catalogue model names (``["a100",
    "h100"]``); names are ``model-<index>``.  ``admission`` is an
    optional :class:`~repro_torch.core.scheduler.admission.AdmissionController`
    shared across the plane's devices; ``tracer`` an optional
    :class:`repro_torch.obs.Tracer` receiving ``lease.*`` instants.
    """

    def __init__(self, devices: Sequence[str] = ("a100",), *,
                 admission: Any = None, tracer: Any = None,
                 default_lease_s: float = DEFAULT_LEASE_S) -> None:
        counts: dict[str, int] = {}
        self.devices: list[_PlaneDevice] = []
        for model in devices:
            idx = counts.get(model, 0)
            counts[model] = idx + 1
            self.devices.append(_PlaneDevice(model, f"{model}-{idx}"))
        if not self.devices:
            raise ValueError("a control plane needs at least one device")
        self.admission = admission
        self.tracer = tracer
        self.default_lease_s = default_lease_s
        self.t = 0.0
        self.leases: dict[str, Lease] = {}
        self._parts: dict[str, tuple[_PlaneDevice, Partition]] = {}
        self.deferred: list[_Ask] = []
        self.n_provisioned = 0
        self.n_released = 0
        self.n_expired = 0
        self.n_deferred = 0

    # -- plumbing ----------------------------------------------------------

    def _advance(self, t: float | None) -> float:
        """The plane clock is monotone: explicit timestamps may only move
        it forward, and omitted ones reuse the current time — both keep
        ledger replay deterministic."""
        if t is not None:
            self.t = max(self.t, float(t))
        return self.t

    def _instant(self, name: str, **args: Any) -> None:
        if self.tracer is not None:
            self.tracer.instant(name, t=self.t, lane="control",
                                cat="lease", **args)

    def _ranked(self) -> list[_PlaneDevice]:
        """Devices in deterministic preference order: highest current
        |F_s| first (the plane-level mirror of Algorithm 3), name as the
        tiebreak."""
        return sorted(self.devices,
                      key=lambda d: (-d.pm.reach(d.pm.state), d.name))

    def _attempt(self, ask: _Ask) -> Lease | None:
        """Try to carve ``ask`` on the best willing device; None when
        every device is infeasible or admission-deferred right now."""
        for dev in self._ranked():
            request = place_request(dev.backend, ask.mem_gb, ask.compute,
                                    dev.reconfig_s)
            plan = dev.planner.plan(request)
            if plan.chosen is None or isinstance(plan.chosen.action, Wait):
                continue
            if self.admission is not None:
                decision = self.admission.decide(
                    dev.pm, plan, self.t, shares=len(self.devices))
                if not decision.admit:
                    self._instant("lease.defer", device=dev.name,
                                  lease=ask.name,
                                  reason=decision.describe())
                    continue
            result = dev.planner.execute(plan)
            assert result is not None
            part = result.partition
            part.busy = True
            lease = Lease(name=ask.name, device=dev.name, pid=part.pid,
                          profile=part.profile.name, mem_gb=ask.mem_gb,
                          compute=ask.compute, granted_t=self.t,
                          duration_s=ask.duration_s,
                          expires_t=self.t + ask.duration_s)
            self.leases[ask.name] = lease
            self._parts[ask.name] = (dev, part)
            self.n_provisioned += 1
            self._instant("lease.grant", device=dev.name, lease=ask.name,
                          profile=part.profile.name, pid=part.pid,
                          expires_t=lease.expires_t)
            return lease
        return None

    def _free(self, name: str) -> Lease:
        lease = self.leases.pop(name)
        dev, part = self._parts.pop(name)
        part.busy = False
        dev.pm.release(part)
        return lease

    def _retry_deferred(self) -> None:
        """One pass over the deferred queue (FIFO) against whatever
        capacity the triggering release/tick just recovered."""
        pending, self.deferred = self.deferred, []
        for ask in pending:
            if self._attempt(ask) is None:
                self.deferred.append(ask)

    # -- the five verbs ----------------------------------------------------

    def provision(self, name: str, mem_gb: float, compute: float = 0.0,
                  lease_s: float | None = None,
                  t: float | None = None) -> Lease | None:
        """Carve a slice for workload ``name`` and grant a lease.

        Placement goes through the shared partition planner on the
        highest-|F_s| device; when an
        :class:`~repro_torch.core.scheduler.admission.AdmissionController` is
        attached, a grant that would drop the post-action |F_s| below
        the reachability floor is **deferred**: the request queues and
        is retried on every :meth:`release` / :meth:`tick`.  Returns the
        :class:`Lease`, or ``None`` when deferred.  Raises
        ``ValueError`` for a duplicate name or a request no device
        could *ever* host.
        """
        self._advance(t)
        if name in self.leases:
            raise ValueError(f"lease {name!r} already exists")
        if any(a.name == name for a in self.deferred):
            raise ValueError(f"lease {name!r} is already queued")
        if all(mem_gb > dev.backend.profiles[-1].mem_gb
               for dev in self.devices):
            raise ValueError(
                f"{mem_gb}GB exceeds every device's largest profile")
        ask = _Ask(name=name, mem_gb=float(mem_gb), compute=float(compute),
                   duration_s=(self.default_lease_s if lease_s is None
                               else float(lease_s)))
        if self.admission is not None:
            self.admission.note_arrival(self.t, ask)
        lease = self._attempt(ask)
        if lease is None:
            self.deferred.append(ask)
            self.n_deferred += 1
        return lease

    def heartbeat(self, name: str, t: float | None = None) -> Lease:
        """Renew ``name``'s liveness: expiry becomes now + its window.

        Raises ``KeyError`` for an unknown (or already-lapsed) lease —
        a late heartbeat after :meth:`tick` reclaimed the slice is the
        caller's signal to re-provision.
        """
        self._advance(t)
        lease = self.leases[name]
        lease.expires_t = self.t + lease.duration_s
        lease.n_heartbeats += 1
        self._instant("lease.heartbeat", device=lease.device, lease=name,
                      expires_t=lease.expires_t)
        return lease

    def extend_lease(self, name: str, extra_s: float,
                     t: float | None = None) -> Lease:
        """Push ``name``'s expiry out by ``extra_s`` seconds (additive —
        unlike :meth:`heartbeat` it does not reset the window, so a
        loaded holder can bank time ahead of a known quiet period)."""
        self._advance(t)
        lease = self.leases[name]
        lease.expires_t += float(extra_s)
        lease.n_extensions += 1
        self._instant("lease.extend", device=lease.device, lease=name,
                      extra_s=extra_s, expires_t=lease.expires_t)
        return lease

    def release(self, name: str, t: float | None = None) -> Lease:
        """Free ``name``'s slice back to its device FSM and retry the
        deferred queue against the recovered capacity.  Raises
        ``KeyError`` for an unknown lease; releasing a queued-but-never-
        granted name just drops it from the deferred queue."""
        self._advance(t)
        if name not in self.leases:
            before = len(self.deferred)
            self.deferred = [a for a in self.deferred if a.name != name]
            if len(self.deferred) == before:
                raise KeyError(name)
            self._instant("lease.release", lease=name, deferred=True)
            return Lease(name=name, device="", pid=-1, profile="",
                         mem_gb=0.0, compute=0.0, granted_t=self.t,
                         duration_s=0.0, expires_t=self.t)
        lease = self._free(name)
        self.n_released += 1
        self._instant("lease.release", device=lease.device, lease=name,
                      pid=lease.pid)
        self._retry_deferred()
        return lease

    def tick(self, t: float | None = None) -> list[str]:
        """Advance the plane clock, reclaim every lapsed lease and retry
        the deferred queue.  Returns the expired lease names (expiry
        order, name-tiebroken — deterministic for ledger replay)."""
        self._advance(t)
        lapsed = sorted((l for l in self.leases.values()
                         if l.expires_t <= self.t),
                        key=lambda l: (l.expires_t, l.name))
        for lease in lapsed:
            self._free(lease.name)
            self.n_expired += 1
            self._instant("lease.expire", device=lease.device,
                          lease=lease.name, expired_t=lease.expires_t)
        if lapsed or self.deferred:
            self._retry_deferred()
        return [l.name for l in lapsed]

    # -- reporting ---------------------------------------------------------

    def status(self) -> dict[str, Any]:
        """A JSON-able snapshot: clock, per-device FSM state (+ which
        lease holds each partition), live leases, the deferred queue and
        the lifetime counters."""
        # pids are per-device counters, so holders key on (device, pid)
        holders = {(lease.device, lease.pid): name
                   for name, lease in self.leases.items()}
        return {
            "t": self.t,
            "devices": [dev.snapshot(holders) for dev in self.devices],
            "leases": [self.leases[n].to_dict()
                       for n in sorted(self.leases)],
            "deferred": [{"name": a.name, "mem_gb": a.mem_gb,
                          "compute": a.compute,
                          "lease_s": a.duration_s}
                         for a in self.deferred],
            "counters": {"provisioned": self.n_provisioned,
                         "released": self.n_released,
                         "expired": self.n_expired,
                         "deferred": self.n_deferred},
        }

    def describe(self) -> str:
        """Human-readable ``status`` (the CLI's default rendering)."""
        snap = self.status()
        lines = [f"t={snap['t']:.1f}s  " + "  ".join(
            f"{k}={v}" for k, v in snap["counters"].items())]
        for dev in snap["devices"]:
            parts = ", ".join(
                f"{p['profile']}<-{p['lease'] or '?'}"
                for p in dev["partitions"]) or "idle"
            lines.append(f"  {dev['name']} ({dev['model']}) "
                         f"reach={dev['reach']}: {parts}")
        for lease in snap["leases"]:
            lines.append(
                f"  lease {lease['name']}: {lease['profile']} on "
                f"{lease['device']} expires t={lease['expires_t']:.1f}s "
                f"(hb={lease['n_heartbeats']})")
        for ask in snap["deferred"]:
            lines.append(f"  deferred {ask['name']}: {ask['mem_gb']}GB")
        return "\n".join(lines)

    # -- ledger replay -----------------------------------------------------

    def apply(self, op: Mapping[str, Any]) -> Any:
        """Apply one ledger operation (dict with an ``op`` key naming a
        verb plus that verb's keyword arguments) and return its result.
        The CLI persists plane state as the operation list itself —
        :meth:`replay` rebuilds the identical plane because every verb
        is deterministic in (current state, operation)."""
        kind = op.get("op")
        args = {k: v for k, v in op.items() if k != "op"}
        verbs = {"provision": self.provision, "heartbeat": self.heartbeat,
                 "extend_lease": self.extend_lease, "release": self.release,
                 "tick": self.tick}
        try:
            verb = verbs[kind]
        except KeyError:
            raise ValueError(f"unknown ledger op {kind!r}; "
                             f"known: {sorted(verbs)}") from None
        return verb(**args)

    def replay(self, ops: Iterable[Mapping[str, Any]]) -> None:
        """Re-apply a recorded operation list in order (see :meth:`apply`)."""
        for op in ops:
            self.apply(op)
