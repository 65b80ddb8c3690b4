"""Fleet-scale routing index: sub-linear dispatch over hundreds of devices;
the port's copy of ``repro.fleet.index``.

``CostRouter.rank`` is the fleet's per-dispatch hot path: the seed
implementation re-derives every device's cost features (free memory, load,
reachability — each a walk over the partition manager's live table) and
full-sorts the pool on every call, O(N · cost_eval) per dispatch.  That is
what stalls the fleet axis at the hundreds of devices the trace-scale
policy comparison needs (arXiv:2409.06646 frames MIG placement as search
over a compact feasibility structure; Helix makes the same argument at
cluster scale).

:class:`RoutingIndex` makes the common dispatch O(k log N) with three
cooperating pieces, all keyed on the kernel's per-device ``device_epoch``
(the placement-state counter — bumped on every start/finish/gate, so a
cached value is provably current while the epoch stands still):

1. **feasibility index** — the per-device capability cap
   (``backend.profiles[-1].mem_gb``, a static fact of the backend) lets
   infeasible devices be excluded by one float compare, without touching
   the ``PartitionManager``;
2. **cached-terms layer** — the device-dependent cost features
   (wake latency, free GiB, normalized reachability, load) are snapshotted
   per device per epoch, and the job-dependent profile selection
   (``tightest_profile``) is memoized per (backend class, est, demand) —
   together they reproduce ``device_cost_terms`` without re-walking any
   partition table.  The tariff ``price_per_j`` is deliberately *not*
   part of any cache key: it scales the ``energy_price`` feature at rank
   time, so the cluster layer's per-round tariff refreshes invalidate
   nothing;
3. **lazy top-k heap** — ``rank`` heapifies ``(cost, position)`` pairs and
   yields devices on demand, so a dispatch that commits to the first or
   second candidate pays O(N + k log N), not a full sort.

Ordering is bitwise-identical to the seed sorted-rank path: the cached
features are the exact floats ``device_cost_terms`` would compute, the
compiled cost replicates ``CostModel.cost``'s arithmetic operation for
operation, and the heap tie-breaks on the candidate's position in the
feasible list — precisely the stable-sort order.
"""

from __future__ import annotations

import heapq
from typing import Callable, Iterator, Sequence

from repro_torch.core.planner.cost import CostModel, normalized_reachability
from repro_torch.core.reachability import reachability_cache_key
from repro_torch.core.scheduler.events import DeviceSim
from repro_torch.core.scheduler.job import Job
from repro_torch.fleet.devices import WAKE_LATENCY_S

#: the CostTerms fields ``device_cost_terms`` populates; every other field
#: keeps the dataclass default 0.0, which the compiled cost folds in as a
#: literal so custom models weighing unset features still match the seed
_DEVICE_FEATURES = ("wake_s", "mem_waste_gb", "free_after_gb", "reach_norm",
                    "compute_deficit", "load", "idle_power_w", "energy_price")

#: profile-memo size bound: trace-shaped memory estimates are continuous,
#: so the memo mostly serves retries of the same job — unbounded growth
#: over a million-job replay would buy nothing but memory
_PROF_MEMO_MAX = 4096


def _compile_device_cost(model: CostModel) -> Callable[..., tuple]:
    """Specialize ``model.cost(device_cost_terms(...))`` into one function
    over the eight device features.

    ``CostModel.cost`` pays a ``CostTerms`` construction, a ``getattr``
    per weighted field, and a generator frame per tier — ~4 µs that the
    per-candidate loop cannot afford at 256 devices.  The weights are
    fixed per model, so the whole evaluation compiles to a tuple literal
    with the weights folded in (same trick as the planner's compiled
    transition graph).  ``repr`` round-trips floats exactly and the
    emitted arithmetic mirrors ``_tier_value`` operation for operation —
    including ``sum()``'s int-0 start for group tiers — so the resulting
    floats are bitwise those of the seed path.
    """
    def term(f: str, w) -> str:
        var = f if f in _DEVICE_FEATURES else "0.0"
        return f"({w!r} * {var})"

    tiers = []
    for tier in model.weights:
        if isinstance(tier[0], str):
            tiers.append(term(*tier))
        else:
            tiers.append("(0 + " + " + ".join(term(f, w) for f, w in tier)
                         + ")")
    src = (f"def _cost({', '.join(_DEVICE_FEATURES)}):\n"
           f"    return ({', '.join(tiers)},)")
    ns: dict = {}
    exec(src, ns)  # noqa: S102 - closed vocabulary: field names + weights
    return ns["_cost"]


class RoutingIndex:
    """Epoch-invalidated per-device caches for one kernel's fleet.

    Bound to a ``CostRouter`` by the fleet policy once the kernel is
    known (``router.index = RoutingIndex(kernel)``); ``rank`` then serves
    every stateless cost ranking from the caches.  ``n_hits`` /
    ``n_misses`` count cached-terms lookups, ``n_skips`` counts devices
    excluded by the feasibility cap — surfaced as ``router.index_hit`` /
    ``router.index_skip`` counters plus a per-dispatch ``router.candidates``
    gauge when the kernel carries a tracer.
    """

    def __init__(self, kernel) -> None:
        devices = kernel.devices
        n = len(devices)
        self.kernel = kernel
        # static per-device facts (the backend and power model never change
        # under the kernel; partitions do, and those live in the snapshots)
        self._cap = [d.backend.profiles[-1].mem_gb for d in devices]
        self._idle_w = [d.energy.model.p_idle_w for d in devices]
        self._bkey = [reachability_cache_key(d.backend) for d in devices]
        self._backend = [d.backend for d in devices]
        # per-device epoch-keyed snapshot: (wake_s, free_gb, reach_norm,
        # load) — exactly the device-dependent device_cost_terms inputs
        self._snap_epoch = [-1] * n
        self._snap: list[tuple | None] = [None] * n
        # (backend key, est, demand) -> (profile mem_gb, compute_fraction);
        # shared across same-model devices, whose profile tables are
        # float-identical by construction
        self._prof: dict = {}
        # (backend key, FSM state) -> normalized reachability; the same
        # cross-device sharing — under consolidation most of the fleet
        # sits in the same (idle, gated) state, so an epoch miss costs a
        # dict hit instead of a reachability walk
        self._reach: dict = {}
        self._cost_fns: dict[int, Callable[..., tuple]] = {}
        self._models: list[CostModel] = []   # pins id() keys of _cost_fns
        self.n_hits = 0
        self.n_misses = 0
        self.n_skips = 0

    # -- cached pieces -----------------------------------------------------

    def _cost_fn(self, model: CostModel) -> Callable[..., tuple]:
        fn = self._cost_fns.get(id(model))
        if fn is None:
            fn = _compile_device_cost(model)
            self._cost_fns[id(model)] = fn
            self._models.append(model)
        return fn

    def _profile(self, i: int, est: float, demand: float
                 ) -> tuple[float, float]:
        key = (self._bkey[i], est, demand)
        p = self._prof.get(key)
        if p is None:
            if len(self._prof) >= _PROF_MEMO_MAX:
                self._prof.clear()
            backend = self._backend[i]
            prof = (backend.tightest_profile(est, demand)
                    or backend.profiles[-1])
            p = (prof.mem_gb, prof.compute_fraction)
            self._prof[key] = p
        return p

    def _refresh(self, i: int, dev: DeviceSim) -> tuple:
        state = dev.pm.state
        rkey = (self._bkey[i], state)
        reach_norm = self._reach.get(rkey)
        if reach_norm is None:
            if len(self._reach) >= _PROF_MEMO_MAX:
                self._reach.clear()
            reach_norm = normalized_reachability(
                dev.backend, state, reach=dev.pm.reach(state))
            self._reach[rkey] = reach_norm
        snap = (
            WAKE_LATENCY_S if dev.gated else 0.0,
            dev.free_mem_gb(),
            reach_norm,
            dev.load_fraction())
        self._snap[i] = snap
        self._snap_epoch[i] = self.kernel.device_epoch[i]
        return snap

    def terms_snapshot(self, i: int, dev: DeviceSim) -> tuple:
        """The device-dependent cost features ``(wake_s, free_gb,
        reach_norm, load)`` of kernel device ``i``, recomputed only when
        its placement epoch moved."""
        if self._snap_epoch[i] == self.kernel.device_epoch[i]:
            self.n_hits += 1
            return self._snap[i]
        self.n_misses += 1
        return self._refresh(i, dev)

    # -- the indexed rank --------------------------------------------------

    def rank(self, router, job: Job, devices: Sequence[DeviceSim]
             ) -> list[DeviceSim] | Iterator[DeviceSim] | None:
        """Devices of ``devices`` feasible for ``job``, in the exact order
        of the seed full-sort rank — lazily, cheapest first.

        Returns None when the pool contains a device this index's kernel
        does not know (an externally-assembled pool); the router then
        falls back to the seed path, which handles any pool.  The loop
        body is deliberately inlined — at 256 devices even a method call
        per candidate is the difference between sub-linear dispatch and
        another linear scan.
        """
        kernel = self.kernel
        epochs = kernel.device_epoch
        caps = self._cap
        idle_ws = self._idle_w
        bkeys = self._bkey
        snaps = self._snap
        snap_epochs = self._snap_epoch
        est = job.est_mem_gb if job.est_mem_gb is not None else 0.0
        demand = job.compute_demand
        price = router.price_per_j
        cost = self._cost_fn(router.cost_model)
        if devices is kernel.devices:
            # the common full-pool rank: positions ARE kernel indices
            pairs = enumerate(devices)
        else:
            get = kernel._dev_index.get
            idxs = []
            for dev in devices:
                i = get(id(dev))
                if i is None:
                    return None
                idxs.append(i)
            pairs = zip(idxs, devices)
        profiles: dict = {}   # backend key -> (mem_gb, compute_fraction)
        entries: list = []
        hits = misses = skips = 0
        pos = 0
        for i, dev in pairs:
            if est > caps[i]:   # cannot EVER host: d.fits(job) is False
                skips += 1
                continue
            if snap_epochs[i] == epochs[i]:
                hits += 1
                wake_s, free_gb, reach_norm, load = snaps[i]
            else:
                misses += 1
                wake_s, free_gb, reach_norm, load = self._refresh(i, dev)
            bkey = bkeys[i]
            p = profiles.get(bkey)
            if p is None:
                p = profiles[bkey] = self._profile(i, est, demand)
            idle_w = idle_ws[i]
            # the feasible-list position tie-breaks equal costs — heap
            # order == stable-sort order, bitwise
            entries.append((
                cost(wake_s, p[0] - est, free_gb - p[0], reach_norm,
                     max(0.0, demand - p[1]), load, idle_w, price * idle_w),
                pos, dev))
            pos += 1
        self.n_hits += hits
        self.n_misses += misses
        self.n_skips += skips
        tracer = kernel.tracer
        if tracer is not None:
            tracer.counter("router.candidates", float(pos))
            tracer.counter("router.index_hit", float(self.n_hits))
            tracer.counter("router.index_skip", float(self.n_skips))
        if pos <= 1:
            # mirrors the seed's singleton fast-path: the changed-device
            # retry ladder hands the router one-device pools constantly
            return [e[2] for e in entries]
        heapq.heapify(entries)
        return self._pop_in_order(entries)

    @staticmethod
    def _pop_in_order(entries: list) -> Iterator[DeviceSim]:
        pop = heapq.heappop
        while entries:
            yield pop(entries)[2]
