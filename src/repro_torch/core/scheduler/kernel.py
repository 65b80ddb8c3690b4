"""The unified event-driven scheduling kernel; the port's copy of
``repro.core.scheduler.kernel``.

Every simulation in this repo — the paper's single-device batch policies
(baseline / scheme A / scheme B), the multi-device fleet orchestrator, and
the request-level LLM serving layer — used to carry its own hand-rolled
event loop.  This module is the one loop they all share: a single event
queue over

* **arrivals**  — jobs (or serving requests) joining the admission queue,
* **finishes**  — a device run completing (done / OOM / early restart),
* **reconfig completions** — a partition fission/fusion or engine
  migration becoming effective, and
* **admission ticks** — policy-scheduled wakeups (the serving layer's
  continuous-batching iteration boundaries).

Policy/mechanism split (MISO, arXiv:2207.11428; optimal MIG placement,
arXiv:2409.06646): the kernel owns time, the event queue and the admission
queue; a :class:`SchedulingPolicy` owns *what to start where* via small
hooks (``dispatch`` / ``on_finish`` / ``on_tick`` / ...).  Adding a policy
or a workload layer is a new policy class, not a new event loop.

Determinism contract: events at equal times order FINISH < RECONFIG <
ARRIVAL < TICK (a finish frees capacity before a simultaneous arrival is
routed — the tie-break every legacy loop used), then by device index, then
by submission sequence.  The kernel performs device operations in exactly
the order the reference's kernel does, which is what makes the port's
metrics equal the reference's bit for bit
(tests/test_torch_scheduler.py).

Trace-scale machinery (million-event replays):

* :class:`IndexedEventQueue` — a tuple-keyed binary heap with live counts
  per event kind (O(1) ``has_events``), lazy deletion with compaction once
  cancelled entries dominate, and per-kind / per-device next-event peeks.
* **Staged arrivals** — online runs feed arrivals from a sorted iterator
  one event at a time instead of pushing the entire trace into the heap
  up front; ``run(jobs, stream=True)`` accepts a lazy job iterator so a
  million-row trace is never materialized as a second list.
* **Lazy device advancement** — policies that declare
  ``lazy_advance = True`` (the fleet) stop paying an N-device
  ``advance_to`` sweep per event.  The kernel instead records the clock's
  event times and *replays* them per device on :meth:`sync`, so every
  device still executes the exact same sequence of ``advance_to`` calls
  the eager sweep would have made — which is what keeps the energy /
  memory integrals bit-for-bit with the goldens.  The replay buffer is
  compacted (forced ``sync_all``) before it can grow unboundedly.
* ``capacity_epoch`` / ``device_epoch`` — monotonic counters bumped
  whenever placement-relevant state changes (a start, a finish, a
  reconfiguration, power gating).  Policies key their queue-rescan
  fast-paths off these; the kernel only provides the fact of change.
"""

from __future__ import annotations

import heapq
import itertools
from collections import Counter
from typing import Any, Iterable, Iterator, Sequence

FINISH = "finish"
RECONFIG = "reconfig"
ARRIVAL = "arrival"
TICK = "tick"

#: tie-break rank at equal event times; see module docstring.
_PRIO = {FINISH: 0, RECONFIG: 1, ARRIVAL: 2, TICK: 3}

#: force a ``sync_all`` once this many clock advances are pending replay —
#: bounds the lazy-advancement buffer so a million-event run holds a few
#: thousand floats, not a per-event list.
_REPLAY_COMPACT_AT = 4096


class Event:
    """One scheduled occurrence.  Heap ordering lives in the queue's tuple
    keys, not here — comparing plain tuples is measurably faster than
    dataclass rich comparison on the million-event path."""

    __slots__ = ("t", "prio", "sub", "seq", "kind", "payload",
                 "_cancelled", "_popped", "_owner")

    def __init__(self, t: float, prio: int, sub: int, seq: int,
                 kind: str, payload: Any = None) -> None:
        self.t = t
        self.prio = prio
        self.sub = sub    # device index for finishes; 0 otherwise
        self.seq = seq    # per-device run sequence for finishes, else global
        self.kind = kind
        self.payload = payload
        self._cancelled = False
        self._popped = False
        self._owner: IndexedEventQueue | None = None

    @property
    def cancelled(self) -> bool:
        """A cancelled event is skipped without advancing the clock — heap
        entries cannot be removed cheaply, so policies mark instead (e.g. a
        fleet admission-recheck tick whose deferred job was admitted by an
        earlier finish: popping it live would integrate phantom idle time).
        Assigning this property keeps the owning queue's live counts
        honest; entries are physically dropped at the next compaction."""
        return self._cancelled

    @cancelled.setter
    def cancelled(self, value: bool) -> None:
        value = bool(value)
        if value == self._cancelled:
            return
        self._cancelled = value
        owner = self._owner
        if owner is not None:
            if value:
                owner._note_cancel(self)
            else:
                owner._note_uncancel(self)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        flags = "cancelled" if self._cancelled else ""
        return (f"Event(t={self.t}, kind={self.kind}, sub={self.sub}, "
                f"seq={self.seq}{', ' + flags if flags else ''})")


class IndexedEventQueue:
    """Binary heap of ``(t, prio, sub, seq, Event)`` tuples with

    * **live counts per kind** — ``has()`` / ``count()`` are O(1) instead
      of the seed's O(heap) scans (the fleet stall path calls them per
      dispatch),
    * **lazy deletion + compaction** — cancelling marks the event and
      decrements the counts; once cancelled entries exceed both a floor
      and half the heap, the heap is rebuilt without them, and
    * **per-kind / per-device next-event peeks** — secondary lazily-pruned
      heaps answer "when is the next TICK" / "when does device 3 next
      finish" without touching the main heap's order.
    """

    #: never compact below this many cancelled entries — rebuilding a tiny
    #: heap per cancel would be quadratic in the pathological cancel loop
    COMPACT_MIN = 64

    __slots__ = ("_heap", "_live", "_n_cancelled", "_by_kind", "_by_sub")

    def __init__(self) -> None:
        self._heap: list[tuple[float, int, int, int, Event]] = []
        self._live: Counter[str] = Counter()
        self._n_cancelled = 0
        self._by_kind: dict[str, list[tuple[float, int, int, Event]]] = {}
        self._by_sub: dict[int, list[tuple[float, int, int, Event]]] = {}

    def __len__(self) -> int:
        return len(self._heap) - self._n_cancelled

    def push(self, ev: Event) -> None:
        ev._owner = self
        self._live[ev.kind] += 1
        heapq.heappush(self._heap, (ev.t, ev.prio, ev.sub, ev.seq, ev))
        # (t, sub, seq) is unique per kind — FINISH seqs are per-device
        # run counters, so sub must outrank seq or the tuple falls through
        # to comparing Events
        heapq.heappush(self._by_kind.setdefault(ev.kind, []),
                       (ev.t, ev.sub, ev.seq, ev))
        if ev.kind == FINISH:
            heapq.heappush(self._by_sub.setdefault(ev.sub, []),
                           (ev.t, ev.sub, ev.seq, ev))

    def pop(self) -> Event | None:
        heap = self._heap
        while heap:
            ev = heapq.heappop(heap)[4]
            if ev._cancelled:
                self._n_cancelled -= 1
                ev._owner = None
                continue
            self._live[ev.kind] -= 1
            ev._popped = True
            ev._owner = None
            self._drop_stale(self._by_kind.get(ev.kind))
            if ev.kind == FINISH:
                self._drop_stale(self._by_sub.get(ev.sub))
            return ev
        return None

    @staticmethod
    def _drop_stale(side: list[tuple[float, int, int, Event]] | None) -> None:
        """Physically free the just-popped event's side-heap entries.

        Within one kind the main-heap key ``(t, prio, sub, seq)`` collapses
        to the side key ``(t, sub, seq)`` (prio is constant per kind), so a
        live event popped from the main heap is the minimum live entry of
        its side heaps: it sits at the top behind at most older stale
        entries, and popping the stale prefix removes it.  Without this, a
        cancel-free run never compacts and the side heaps retain every
        Event — and its Job payload — for the whole replay.
        """
        while side and (side[0][3]._cancelled or side[0][3]._popped):
            heapq.heappop(side)

    def peek(self) -> Event | None:
        heap = self._heap
        while heap:
            ev = heap[0][4]
            if not ev._cancelled:
                return ev
            heapq.heappop(heap)
            self._n_cancelled -= 1
            ev._owner = None
        return None

    def has(self, kind: str | None = None) -> bool:
        if kind is None:
            return len(self._heap) > self._n_cancelled
        return self._live[kind] > 0

    def count(self, kind: str | None = None) -> int:
        if kind is None:
            return len(self)
        return self._live[kind]

    @staticmethod
    def _prune_peek(side: list[tuple[float, int, int, Event]]) -> Event | None:
        while side:
            ev = side[0][3]
            if not (ev._cancelled or ev._popped):
                return ev
            heapq.heappop(side)
        return None

    def next_time(self, kind: str | None = None) -> float | None:
        """Earliest live event time, optionally restricted to one kind."""
        if kind is None:
            ev = self.peek()
        else:
            ev = self._prune_peek(self._by_kind.get(kind, []))
        return ev.t if ev is not None else None

    def next_finish_for(self, sub: int) -> float | None:
        """When device ``sub`` next finishes, or None — per-device
        next-event awareness without scanning the main heap."""
        ev = self._prune_peek(self._by_sub.get(sub, []))
        return ev.t if ev is not None else None

    # -- cancellation bookkeeping (driven by Event.cancelled) --------------

    def _note_cancel(self, ev: Event) -> None:
        self._live[ev.kind] -= 1
        self._n_cancelled += 1
        self._maybe_compact()

    def _note_uncancel(self, ev: Event) -> None:
        self._live[ev.kind] += 1
        self._n_cancelled -= 1

    def _maybe_compact(self) -> None:
        if (self._n_cancelled >= self.COMPACT_MIN
                and self._n_cancelled * 2 > len(self._heap)):
            live = []
            for entry in self._heap:
                if entry[4]._cancelled:
                    entry[4]._owner = None
                else:
                    live.append(entry)
            heapq.heapify(live)
            self._heap = live
            self._n_cancelled = 0
            for side in (*self._by_kind.values(), *self._by_sub.values()):
                side[:] = [e for e in side
                           if not (e[3]._cancelled or e[3]._popped)]
                heapq.heapify(side)


class SchedulingPolicy:
    """What to start where.  Subclass and override the hooks you need.

    ``online=False`` policies (batch schedulers) receive every job in the
    kernel queue up front regardless of ``arrival``; ``online=True``
    policies see jobs with ``arrival > 0`` only when their ARRIVAL event
    fires — exactly the legacy scheme-B/fleet admission semantics.

    ``lazy_advance=False`` (the default) keeps the seed behaviour: every
    device is advanced to every event time before any hook runs.  A policy
    may set it True only if its ``on_arrival`` / ``on_tick`` /
    ``on_reconfig`` hooks never read device clocks or integrals — the
    kernel then defers advancement and replays it on :meth:`EventKernel
    .sync`, which the policy must call before mutating a device.
    """

    name = "policy"
    online = False
    lazy_advance = False

    def on_init(self, kernel: "EventKernel", jobs: list) -> None:
        """Called once before the loop, after the queue is seeded."""

    def dispatch(self, kernel: "EventKernel") -> bool:
        """Place queued work onto devices; return True if anything started."""
        return False

    def on_finish(self, kernel: "EventKernel", device, run) -> None:
        """A device run completed (``run.plan.outcome`` says how)."""

    def on_arrival(self, kernel: "EventKernel", item) -> None:
        kernel.queue.append(item)

    def on_reconfig(self, kernel: "EventKernel", payload) -> None:
        """A scheduled reconfiguration (fission/fusion, migration) landed."""

    def on_tick(self, kernel: "EventKernel", payload) -> None:
        """A policy-scheduled admission tick fired."""

    def on_stall(self, kernel: "EventKernel") -> None:
        """Queue is non-empty, nothing could be placed, nothing is running.
        Raise to abort (deadlock) or return to wait for a future event."""
        head = kernel.queue[0]
        raise RuntimeError(f"deadlock: cannot place "
                           f"{getattr(head, 'name', head)!s}")

    def result(self, kernel: "EventKernel", jobs: list):
        """Build the run's metrics object after the heap drains."""
        return None


class EventKernel:
    """One event queue, one clock, N devices, one pluggable policy.

    A *device* is anything with ``name``, ``has_running``, ``advance_to(t)``
    and — if the policy starts :class:`~repro_torch.core.scheduler.job.Job`
    runs on it — the :class:`~repro_torch.core.scheduler.events.DeviceSim`
    surface (``start`` / ``pop_next_finish``).  The reference's serving
    layer plugs in its own lighter device type and drives everything
    through ticks + reconfigs.
    """

    #: this kernel maintains real per-device epochs and the ``awake_idle``
    #: set, so a fleet may bind a routing index (the reference's
    #: ``repro.fleet.index.RoutingIndex``) to it; the legacy benchmark
    #: kernel (fresh epochs on every read) lacks the marker and keeps the
    #: seed rank path.
    supports_routing_index = True

    def __init__(self, devices: Sequence, policy: SchedulingPolicy,
                 tracer=None) -> None:
        if not devices:
            raise ValueError("the kernel needs at least one device")
        names = [d.name for d in devices]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate device names: {names}")
        self.devices = list(devices)
        self.policy = policy
        self.t = 0.0
        self.events = IndexedEventQueue()
        self._seq = itertools.count()
        self._dev_index = {id(d): i for i, d in enumerate(self.devices)}
        self.queue: list = []   # admitted, not yet placed
        self.tracer = tracer    # repro_torch.obs.Tracer, or None
        #: bumped whenever placement-relevant state changes anywhere
        #: (start / finish / reconfig / gate); policies key queue-rescan
        #: fast-paths off it
        self.capacity_epoch = 0
        #: same, per device — lets a policy retry a previously-unplaceable
        #: job against only the devices that changed since it last failed
        self.device_epoch = [0] * len(self.devices)
        #: kernel indices of devices that are awake (not power-gated) and
        #: fully idle — maintained on start/finish so consolidation gating
        #: (``gate_idle_devices``) reads a set instead of rescanning the
        #: fleet on every dispatch round
        self.awake_idle = {i for i, d in enumerate(self.devices)
                           if not getattr(d, "gated", False)
                           and not d.has_running}
        self._pool_cache: dict[int, tuple] = {}  # id(seq) -> (seq, indices)
        #: kernel loop iterations (events processed); benchmark currency
        self.n_events = 0
        #: arrivals admitted (staged events + queue-seeded) — the job count
        #: for streamed runs, where no jobs list survives the loop
        self.n_jobs_seen = 0
        self._lazy = bool(getattr(policy, "lazy_advance", False))
        self._times: list[float] = []       # clock advances pending replay
        self._cursor = [0] * len(self.devices)
        self._pending: Iterator | None = None   # staged-arrival source
        self._next_job = None                   # lookahead from stream peel
        self._stream = False
        self._names_seen: set = set()
        self._last_arrival = 0.0
        if tracer is not None:
            tracer.bind_clock(lambda: self.t)
            tracer.meta.setdefault("policy", policy.name)
            tracer.meta.setdefault("devices", names)
            for dev in self.devices:
                dev.tracer = tracer
                planner = getattr(dev, "planner", None)
                if planner is not None:
                    planner.tracer = tracer
                    planner.owner = dev.name

    # -- event plumbing ----------------------------------------------------

    def push(self, t: float, kind: str, payload: Any = None,
             sub: int = 0, seq: int | None = None) -> Event:
        ev = Event(t=t, prio=_PRIO[kind], sub=sub,
                   seq=next(self._seq) if seq is None else seq,
                   kind=kind, payload=payload)
        self.events.push(ev)
        return ev

    def schedule_tick(self, t: float, payload: Any = None) -> Event:
        return self.push(t, TICK, payload)

    def schedule_reconfig(self, t: float, payload: Any = None) -> Event:
        return self.push(t, RECONFIG, payload)

    def cancel(self, ev: Event) -> None:
        ev.cancelled = True

    def has_events(self, kind: str | None = None) -> bool:
        return self.events.has(kind)

    def next_event_time(self, kind: str | None = None) -> float | None:
        return self.events.next_time(kind)

    # -- placement-epoch bookkeeping ---------------------------------------

    def bump_epoch(self, device=None) -> None:
        """Placement-relevant state changed (on ``device``, if given)."""
        self.capacity_epoch += 1
        if device is not None:
            self.device_epoch[self._dev_index[id(device)]] += 1

    def pool_indices(self, devices: Sequence) -> frozenset:
        """Kernel indices of a stable device subset (a cluster zone's
        pool), cached by list identity — the kept reference pins ``id()``
        so the cache entry can never be aliased by a recycled address."""
        hit = self._pool_cache.get(id(devices))
        if hit is not None and hit[0] is devices:
            return hit[1]
        indices = frozenset(self._dev_index[id(d)] for d in devices)
        self._pool_cache[id(devices)] = (devices, indices)
        return indices

    # -- lazy device advancement -------------------------------------------

    def sync(self, device) -> None:
        """Replay every recorded clock advance this device has not seen.

        The replay makes the exact ``advance_to(t)`` sequence the eager
        per-event sweep would have — same calls, same order, same floats —
        so energy/memory integrals are bitwise identical to eager mode.
        Idempotent and O(pending) per device."""
        i = self._dev_index[id(device)]
        cur = self._cursor[i]
        times = self._times
        if cur < len(times):
            advance = device.advance_to
            for t in times[cur:]:
                advance(t)
            self._cursor[i] = len(times)

    def sync_all(self) -> None:
        """Bring every device to the current clock and clear the replay
        buffer (the compaction that keeps memory flat at a million
        events)."""
        for dev in self.devices:
            self.sync(dev)
        self._times.clear()
        self._cursor = [0] * len(self.devices)

    def _record_time(self, t: float) -> None:
        times = self._times
        if not times or t > times[-1]:
            times.append(t)
            if len(times) >= _REPLAY_COMPACT_AT:
                self.sync_all()

    # -- device runs -------------------------------------------------------

    def start(self, device, job, partition, setup_s: float = 0.0):
        """Start ``job`` on ``device`` and register its finish event."""
        self.sync(device)   # lazy mode: the device may lag the clock
        run = device.start(job, partition, setup_s=setup_s)
        i = self._dev_index[id(device)]
        self.push(run.t_end, FINISH, device, sub=i, seq=run.seq)
        self.awake_idle.discard(i)
        self.bump_epoch(device)
        if self.tracer is not None:
            from repro_torch.obs.audit import encode_handle
            profile = partition.profile
            self.tracer.span(
                run.t_start, run.t_end, job.name, device=device.name,
                lane=f"{profile.name}#{partition.pid}", cat="run",
                outcome=run.plan.outcome, profile=profile.name,
                mem_gb=job.mem_gb, setup_s=setup_s,
                handle=encode_handle(partition.handle))
        return run

    # -- staged arrivals ---------------------------------------------------

    def _trace_job(self, job) -> None:
        """One ``{"type": "job", ...}`` record per admitted batch job — the
        workload spec (true peak memory, kernel/IO seconds, compute demand)
        that makes a trace self-contained for the regret oracle's replay.
        Non-Job queue items (serving requests) are skipped."""
        tracer = self.tracer
        if tracer is None or getattr(job, "t_kernel", None) is None:
            return
        traj = getattr(job, "trajectory", None)
        if traj is not None:
            mem_gb = traj.peak_phys / 1024 ** 3
            t_kernel_s = traj.n_iters * traj.t_per_iter
            t_io_s = 0.0
        else:
            mem_gb = job.mem_gb
            t_kernel_s = job.t_kernel
            t_io_s = job.t_io
        tracer.emit({
            "type": "job", "name": job.name, "arrival": job.arrival,
            "mem_gb": mem_gb, "est_mem_gb": job.est_mem_gb,
            "t_fixed": job.t_fixed, "t_kernel_s": t_kernel_s,
            "t_io_s": t_io_s, "compute_demand": job.compute_demand,
            "dynamic": traj is not None})

    def _admit_job(self, job) -> None:
        self._trace_job(job)
        if self._stream:
            name = getattr(job, "name", None)
            if name in self._names_seen:
                raise ValueError(f"duplicate job names: [{name!r}]")
            self._names_seen.add(name)
            if job.arrival < self._last_arrival:
                raise ValueError(
                    f"streamed jobs must be sorted by arrival: "
                    f"{name!r} at {job.arrival} after {self._last_arrival}")
            self._last_arrival = job.arrival
        self.n_jobs_seen += 1

    def _stage_next_arrival(self) -> None:
        """Keep exactly one future arrival in the event queue.  Arrival
        events are staged in sorted order, so their relative seq order —
        the same-time tie-break — matches the seed's push-all-upfront
        behaviour while the heap holds one arrival instead of a million."""
        it = self._pending
        if it is None:
            return
        job = self._next_job
        self._next_job = None
        if job is None:
            job = next(it, None)
        if job is None:
            self._pending = None
            return
        self._admit_job(job)
        self.push(job.arrival, ARRIVAL, job)

    # -- the loop ----------------------------------------------------------

    def _any_running(self) -> bool:
        return any(d.has_running for d in self.devices)

    def run(self, jobs: Iterable, stream: bool = False):
        """Drive the policy over ``jobs`` until the event queue drains.

        ``stream=True`` (online policies only) treats ``jobs`` as a lazy
        iterator already sorted by ``arrival``: jobs are admitted one
        event at a time and never materialized as a list — the path that
        keeps a million-row trace replay's memory flat.  The policy's
        ``result`` hook then receives an empty jobs list and must fall
        back to per-device accounting (the fleet policy does).
        """
        self._stream = stream
        if stream:
            if not self.policy.online:
                raise ValueError("stream=True requires an online policy")
            it = iter(jobs)
            # jobs at/before t=0 are queue-seeded, not arrival events —
            # peel them off the sorted stream's head
            for job in it:
                if job.arrival > 0.0:
                    self._next_job = job
                    break
                self._admit_job(job)
                self.queue.append(job)
            self._pending = it
            self._stage_next_arrival()
            jobs = []
        else:
            jobs = list(jobs)
            counts = Counter(getattr(j, "name", None) for j in jobs)
            dupes = sorted((n for n, c in counts.items() if c > 1),
                           key=str)
            if dupes:
                # completion/turnaround accounting is keyed by name;
                # duplicates would silently overwrite each other
                raise ValueError(f"duplicate job names: {dupes[:5]}")
            if self.policy.online:
                self.queue = [j for j in jobs if j.arrival <= 0.0]
                self.n_jobs_seen = len(self.queue)
                for j in self.queue:
                    self._trace_job(j)
                self._pending = iter(sorted(
                    (j for j in jobs if j.arrival > 0.0),
                    key=lambda j: j.arrival))
                self._stage_next_arrival()
            else:
                self.queue = list(jobs)
                self.n_jobs_seen = len(jobs)
                for j in self.queue:
                    self._trace_job(j)
        self.policy.on_init(self, jobs)

        policy = self.policy
        events = self.events
        lazy = self._lazy
        while True:
            progressed = policy.dispatch(self)
            if self.queue and not progressed and not self._any_running():
                policy.on_stall(self)
            ev = events.pop()
            if ev is None:
                break
            self.t = ev.t
            self.n_events += 1
            kind = ev.kind
            if kind == FINISH:
                dev = ev.payload
                # replay strictly-earlier advances first: pop_next_finish
                # integrates [dev.t, t_end] itself, with the seed's exact
                # accounting (the finishing run excluded from that
                # interval's active-compute — popping before advancing is
                # the golden-pinned order)
                self.sync(dev)
                run = dev.pop_next_finish()
                if not dev.has_running:
                    self.awake_idle.add(self._dev_index[id(dev)])
                self._record_time(ev.t)
                if not lazy:
                    self.sync_all()
                self.bump_epoch(dev)
                policy.on_finish(self, dev, run)
            elif kind == ARRIVAL:
                self._record_time(ev.t)
                if not lazy:
                    self.sync_all()
                self._stage_next_arrival()
                self._trace_queued(ev.payload)
                policy.on_arrival(self, ev.payload)
                # admit simultaneous arrivals together, as the legacy loops
                # did (`arrival <= t + eps`): dispatching between two
                # tied arrivals would let a consolidating policy gate a
                # device for zero seconds and charge a spurious wake
                while True:
                    nxt = events.peek()
                    if (nxt is None or nxt.kind != ARRIVAL
                            or nxt.t > ev.t + 1e-12):
                        break
                    events.pop()
                    self.n_events += 1
                    self._stage_next_arrival()
                    self._trace_queued(nxt.payload)
                    policy.on_arrival(self, nxt.payload)
            elif kind == RECONFIG:
                self._record_time(ev.t)
                if not lazy:
                    self.sync_all()
                self.bump_epoch()
                policy.on_reconfig(self, ev.payload)
            else:  # TICK
                self._record_time(ev.t)
                if not lazy:
                    self.sync_all()
                policy.on_tick(self, ev.payload)

        self.sync_all()   # lazy stragglers: final integrals need every t
        if self.tracer is not None:
            self.tracer.finish(self.t)
        return policy.result(self, jobs)

    def _trace_queued(self, item) -> None:
        if self.tracer is not None:
            self.tracer.instant("queued", lane="queue",
                                job=str(getattr(item, "name", item)))
