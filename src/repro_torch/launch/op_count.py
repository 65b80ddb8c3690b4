"""Dispatch-level op counting: the port's counterpart of the reference's
``repro/launch/hlo_parse.py``.

The reference parses the optimized HLO text of a compiled step; the port
produces no HLO, so :func:`analyze` runs the step once, eagerly, on
``meta`` tensors (local shards of DTensors when the arguments are
sharded) under a ``TorchDispatchMode`` that sees every op each device
would run, and aggregates

* ``flops``: matmul-class FLOPs by ``torch.utils.flop_counter``'s formulas
  (``FlopCounterMode``'s registry), on the local shapes;
* ``out_bytes``: the sum of every op's output bytes (an HBM-traffic proxy);
* ``collectives``: result bytes of each collective, mapped onto the
  reference's five kinds (``all_gather_into_tensor`` -> ``all-gather``,
  ``all_reduce`` -> ``all-reduce``, ``reduce_scatter_tensor`` ->
  ``reduce-scatter``, ``all_to_all_single`` -> ``all-to-all``) plus
  ``total``, with ``CommDebugMode``'s op counts under ``counts``;
* ``n_ops``: the ops dispatched;
* ``peak_bytes``: the most bytes of live ``meta`` storage at any point of
  the call, arguments included, each storage counted once and freed when
  the last tensor on it dies (a weakref finalizer, checked against the
  storage's own weak reference).

With ``sites=True`` it also names where the figures come from, each op by
its code site (the innermost function of the port's ``models/`` or
``sharding/`` on the stack): ``sites``, the collectives' bytes by
``"kind | site"``; ``largest``, the largest single collective of each
kind; ``peak_temps``, the storages the call made that are live at the
peak, as (bytes, what made them).

All figures are per device (the local shard's), as the reference's are.
Eager execution runs every layer and every microbatch, so the while-loop
trip-count correction that ``hlo_parse`` exists for has no counterpart.
DTensor's sharding propagation runs each new op once more on fake tensors
of the global shape; those calls are not counted.

On a mesh of device type ``"cpu"`` DTensor runs a Shard->Shard
all-to-all as an all-gather and a chunk (``shard_dim_alltoall``'s
fallback); such an all-gather is counted as the all-to-all it stands for,
with the all-to-all's result bytes (the input's), and its all-gather
bytes are kept under ``alltoall_as_allgather_bytes``.
"""

from __future__ import annotations

import sys
import weakref

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: functional-collective op name -> the reference's collective kind
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "permute_tensor": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "c10d_functional", "_dtensor")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _kind(func) -> str | None:
    packet = func._overloadpacket
    ns = getattr(packet, "_qualified_op_name", "").split("::")[0]
    if ns not in _COLLECTIVE_NS:
        return None
    return _KIND.get(packet.__name__)


def _in_alltoall_fallback(depth: int = 12) -> bool:
    frame = sys._getframe(2)
    for _ in range(depth):
        if frame is None:
            return False
        if frame.f_code.co_name == "shard_dim_alltoall":
            return True
        frame = frame.f_back
    return False


class _LiveStorage:
    """Bytes of live storages, each counted once, and their peak; with
    ``track``, what made each storage and those live at the peak."""

    def __init__(self, track: bool = False) -> None:
        self.entries: dict[int, list] = {}   # key -> [weakref, nbytes, n]
        self.pending: list = []
        self.bytes = 0
        self.peak = 0
        self.track = track
        self.made: dict[int, str] = {}
        self.at_peak: list[tuple[int, str]] = []

    def add(self, t: torch.Tensor, made_by: str | None = None) -> None:
        st = t.untyped_storage()
        key = st._cdata
        ent = self.entries.get(key)
        if ent is None or ent[0].expired():
            if ent is not None:
                self._drop(key, ent)
            ent = self.entries[key] = [StorageWeakRef(st), st.nbytes(), 0]
            self.bytes += ent[1]
            if self.track:
                if made_by is None:
                    self.made.pop(key, None)
                else:
                    self.made[key] = made_by
            if self.bytes > self.peak:
                self.peak = self.bytes
                if self.track:
                    self.at_peak = [(e[1], self.made[k]) for k, e in
                                    self.entries.items() if k in self.made]
        ent[2] += 1
        weakref.finalize(t, self._tensor_died, key, ent)

    def _tensor_died(self, key: int, ent: list) -> None:
        ent[2] -= 1
        if ent[2] == 0:
            self.pending.append((key, ent))

    def _drop(self, key: int, ent: list) -> None:
        if self.entries.get(key) is ent:
            del self.entries[key]
            self.bytes -= ent[1]

    def sweep(self) -> None:
        """Free the storages whose tensors died, unless something that
        holds no tracked tensor (a tensor autograd saved) keeps them."""
        keep = []
        for key, ent in self.pending:
            if ent[2] > 0 or self.entries.get(key) is not ent:
                continue
            if ent[0].expired():
                self._drop(key, ent)
            else:
                keep.append((key, ent))
        self.pending = keep


def code_site(depth: int = 64) -> str:
    """The innermost function of the port's ``models/`` or ``sharding/``
    on the stack, as ``file.py::function``."""
    frame = sys._getframe(1)
    for _ in range(depth):
        if frame is None:
            break
        name = frame.f_code.co_filename.replace("\\", "/")
        if "/repro_torch/models/" in name or "/repro_torch/sharding/" in name:
            return f"{name.rsplit('/', 1)[-1]}::{frame.f_code.co_name}"
        frame = frame.f_back
    return "?"


class _Counter(TorchDispatchMode):
    def __init__(self, sites: bool = False) -> None:
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import FlopCounterMode
        self.dtensor = DTensor
        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.out_bytes = 0
        self.n_ops = 0
        self.coll = {c: 0 for c in COLLECTIVES}
        self.alltoall_as_allgather = 0
        self.n_alltoall_as_allgather = 0
        self.live = _LiveStorage(track=sites)
        self.sites: dict[str, int] | None = {} if sites else None
        self.largest = {c: 0 for c in COLLECTIVES}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self.dtensor) for t in types):
            return NotImplemented   # DTensor: count its local ops instead
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return func(*args, **kwargs)   # sharding propagation's fake run
        if func not in self.registry and not isinstance(
                func, torch._ops.HigherOrderOperator):
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        self.live.sweep()
        out = func(*args, **kwargs)
        self.n_ops += 1
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs, out_val=out)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        where = code_site() if self.sites is not None else None
        kind = _kind(func)
        if kind is not None:
            got = sum(_nbytes(t) for t in outs)
            if kind == "all-gather" and _in_alltoall_fallback():
                self.alltoall_as_allgather += got
                self.n_alltoall_as_allgather += 1
                kind, got = "all-to-all", sum(
                    _nbytes(t) for t in tree_flatten(args)[0]
                    if isinstance(t, torch.Tensor))
            self.coll[kind] += got
            self.largest[kind] = max(self.largest[kind], got)
            if where is not None:
                at = f"{kind} | {where}"
                self.sites[at] = self.sites.get(at, 0) + got
        for t in outs:
            self.out_bytes += _nbytes(t)
            self.live.add(t, where and f"{tuple(t.shape)} {t.dtype} "
                                       f"{packet.__name__} @ {where}")
        return out


def local(t):
    """The local shard of a DTensor; any other tensor as it is."""
    return t._local_tensor if hasattr(t, "_local_tensor") else t


def tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def local_nbytes(tree) -> int:
    """Bytes of the local shards of every tensor in ``tree``, each storage
    counted once."""
    seen, total = set(), 0
    for t in tensors(tree):
        st = local(t).untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def analyze(fn, *args, sites: bool = False) -> dict:
    """Run ``fn(*args)`` once and return its counts (see the module
    docstring; ``sites`` adds where they come from), plus
    ``argument_bytes`` (local bytes of ``args``),
    ``output_bytes`` (of the result) and ``alias_bytes`` (the result's
    bytes that live in an argument's storage: the state or caches a step
    updates in place, as the reference's donated buffers)."""
    from torch.distributed.tensor.debug import CommDebugMode

    arg_storages = {local(t).untyped_storage()._cdata
                    for t in tensors(args)}
    counter = _Counter(sites)
    for t in tensors(args):
        counter.live.add(local(t))
    with CommDebugMode() as comm, counter:
        result = fn(*args)
    outs = tensors(result)
    output_bytes = sum(_nbytes(local(t)) for t in outs)
    alias_bytes = sum(_nbytes(local(t)) for t in outs
                      if local(t).untyped_storage()._cdata in arg_storages)
    counts = {c: 0 for c in COLLECTIVES}
    for op, n in comm.get_comm_counts().items():
        kind = _KIND.get(getattr(op, "__name__", str(op)).split(".")[-1])
        if kind is not None:
            counts[kind] += n
    counts["all-gather"] -= counter.n_alltoall_as_allgather
    counts["all-to-all"] += counter.n_alltoall_as_allgather
    where = {} if counter.sites is None else {
        "sites": dict(sorted(counter.sites.items())),
        "largest": dict(counter.largest),
        "peak_temps": sorted(counter.live.at_peak, reverse=True)}
    return {
        **where,
        "flops": float(counter.flops),
        "out_bytes": float(counter.out_bytes),
        "collectives": {**counter.coll, "total": sum(counter.coll.values()),
                        "counts": counts,
                        "alltoall_as_allgather_bytes":
                            counter.alltoall_as_allgather},
        "n_ops": counter.n_ops,
        "peak_bytes": counter.live.peak,
        "argument_bytes": local_nbytes(args),
        "output_bytes": output_bytes,
        "alias_bytes": alias_bytes,
    }
