"""Streaming counters, gauges and P² quantile estimators; the port's copy
of ``repro.obs.counters``.

Stored-latency lists are the memory cliff between a benchmark run and a
month-long production trace: a million-request replay cannot hold (let
alone sort) every TTFT sample just to report a p99.  This module is the
replacement — a zero-dependency registry of

* :class:`Counter` — monotonic event counts (requests completed, OOMs),
* :class:`Gauge` — last-value instruments (queue depth, violation prob),
* :class:`P2Quantile` — the P² streaming quantile estimator (Jain &
  Chlamtac, CACM 1985): five markers, O(1) memory and O(1) update,
  converging on any fixed quantile of an unbounded stream, and
* :class:`TailStats` — the stored-latency-list facade: count / mean /
  min / max exactly, p50/p95/p99 via P² — the drop-in the serving, fleet
  and cluster metrics stream into (``exact=True`` keeps the full sample
  list for the bit-for-bit golden paths).

Everything is deterministic: the same observation sequence always yields
the same estimates, so seeded simulations remain reproducible with the
streaming path enabled.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable


@dataclasses.dataclass
class Counter:
    """A monotonic counter."""

    name: str
    value: float = 0.0

    def inc(self, by: float = 1.0) -> None:
        if by < 0:
            raise ValueError(f"counter {self.name}: negative increment {by}")
        self.value += by


@dataclasses.dataclass
class Gauge:
    """A last-value instrument (plus the running extremes)."""

    name: str
    value: float = 0.0
    max: float = -math.inf
    min: float = math.inf

    def set(self, value: float) -> None:
        self.value = value
        if value > self.max:
            self.max = value
        if value < self.min:
            self.min = value


#: exact-sample seed size before the five P² markers take over.  The
#: textbook algorithm seeds from five samples; on heavy-tailed streams an
#: early outlier then lands *on* the quantile marker and takes thousands
#: of rank-at-a-time adjustments to drain back out.  Seeding from a
#: larger sorted buffer places every marker near its true quantile first.
SEED_SAMPLES = 32


class P2Quantile:
    """The P² algorithm: estimate one quantile of a stream in O(1) space.

    Five markers track (min, q/2, q, (1+q)/2, max); on every observation
    the middle markers drift toward their desired rank positions via a
    piecewise-parabolic (fallback: linear) height adjustment.  Until
    :data:`SEED_SAMPLES` samples have arrived the estimate is exact
    (computed over the sorted buffer the markers are then seeded from).
    """

    __slots__ = ("q", "_buf", "_heights", "_pos", "_desired", "_incr",
                 "count")

    def __init__(self, q: float) -> None:
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0, 1), got {q}")
        self.q = q
        self._buf: list[float] | None = []  # sorted seed buffer
        self._heights: list[float] = []     # marker heights (sorted)
        self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self._desired = [1.0, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5.0]
        self._incr = [0.0, q / 2, q, (1 + q) / 2, 1.0]
        self.count = 0

    def _seed_markers(self) -> None:
        """Place the five markers on the sorted seed buffer, each as close
        to its desired rank as strict monotonicity allows."""
        b = self._buf
        assert b is not None
        n = len(b)
        q = self.q
        self._desired = [1.0, (n - 1) * q / 2 + 1, (n - 1) * q + 1,
                         (n - 1) * (1 + q) / 2 + 1, float(n)]
        pos = [1, 0, 0, 0, n]
        hi = n - 1
        for i in (3, 2, 1):      # clamp backward: ints, strictly increasing
            p = min(hi, max(i + 1, round(self._desired[i])))
            pos[i] = p
            hi = p - 1
        self._pos = [float(p) for p in pos]
        self._heights = [b[p - 1] for p in pos]
        self._buf = None

    def observe(self, x: float) -> None:
        self.count += 1
        if self._buf is not None:
            # seed phase: exact sorted buffer, markers placed on the last
            b = self._buf
            lo, hi = 0, len(b)
            while lo < hi:            # insort, dependency-free
                mid = (lo + hi) // 2
                if b[mid] < x:
                    lo = mid + 1
                else:
                    hi = mid
            b.insert(lo, x)
            if self.count >= SEED_SAMPLES:
                self._seed_markers()
            return
        h = self._heights

        # locate the cell k such that h[k] <= x < h[k+1]
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            while k < 3 and x >= h[k + 1]:
                k += 1
        for i in range(k + 1, 5):
            self._pos[i] += 1.0
        for i in range(5):
            self._desired[i] += self._incr[i]

        # adjust the three middle markers toward their desired positions
        for i in (1, 2, 3):
            d = self._desired[i] - self._pos[i]
            n, n_lo, n_hi = self._pos[i], self._pos[i - 1], self._pos[i + 1]
            if (d >= 1.0 and n_hi - n > 1.0) or (d <= -1.0 and n_lo - n < -1.0):
                step = 1.0 if d >= 1.0 else -1.0
                cand = self._parabolic(i, step)
                if h[i - 1] < cand < h[i + 1]:
                    h[i] = cand
                else:
                    h[i] = self._linear(i, step)
                self._pos[i] = n + step

    def _parabolic(self, i: int, d: float) -> float:
        h, n = self._heights, self._pos
        return h[i] + d / (n[i + 1] - n[i - 1]) * (
            (n[i] - n[i - 1] + d) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
            + (n[i + 1] - n[i] - d) * (h[i] - h[i - 1]) / (n[i] - n[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        h, n = self._heights, self._pos
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (n[j] - n[i])

    @property
    def value(self) -> float:
        """The current quantile estimate (exact while still seeding)."""
        if self._buf is not None:
            b = self._buf
            if not b:
                return math.nan
            # exact small-sample percentile over the seed buffer
            pos = (len(b) - 1) * self.q
            lo = math.floor(pos)
            hi = math.ceil(pos)
            if lo == hi:
                return b[lo]
            return b[lo] + (b[hi] - b[lo]) * (pos - lo)
        return self._heights[2]


#: the tail quantiles every latency facade tracks by default
DEFAULT_QUANTILES = (0.50, 0.95, 0.99)


class TailStats:
    """The stored-latency-list facade: stream observations, read tails.

    ``exact=True`` keeps the raw sample list and computes percentiles by
    sorting (the legacy behaviour the golden tests pin); the default
    streams through one :class:`P2Quantile` per tracked quantile at O(1)
    memory.  ``count``/``mean``/``min``/``max`` are exact either way.
    """

    def __init__(self, name: str = "",
                 quantiles: Iterable[float] = DEFAULT_QUANTILES,
                 exact: bool = False) -> None:
        self.name = name
        self.exact = exact
        self.count = 0
        self._sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._samples: list[float] | None = [] if exact else None
        self._estimators = {} if exact else {
            q: P2Quantile(q) for q in quantiles}

    def observe(self, x: float) -> None:
        self.count += 1
        self._sum += x
        if x < self.min:
            self.min = x
        if x > self.max:
            self.max = x
        if self._samples is not None:
            self._samples.append(x)
        else:
            for est in self._estimators.values():
                est.observe(x)

    @property
    def mean(self) -> float:
        return self._sum / self.count if self.count else 0.0

    def percentile(self, pct: float) -> float:
        """Percentile in [0, 100] — exact when ``exact=True``, else the P²
        estimate for a tracked quantile (untracked quantiles raise)."""
        if self._samples is not None:
            from repro_torch.core.scheduler.metrics import percentile
            return percentile(self._samples, pct)
        if self.count == 0:
            return math.nan
        q = pct / 100.0
        est = self._estimators.get(q)
        if est is None:
            raise KeyError(
                f"tail {self.name!r} does not track q={q} "
                f"(tracked: {sorted(self._estimators)}); construct it with "
                f"that quantile or use exact=True")
        return est.value

    def snapshot(self) -> dict:
        out = {"count": self.count, "mean": self.mean,
               "min": self.min if self.count else math.nan,
               "max": self.max if self.count else math.nan}
        qs = (sorted(self._estimators) if self._samples is None
              else list(DEFAULT_QUANTILES))
        for q in qs:
            out[f"p{100 * q:g}"] = self.percentile(100 * q)
        return out


class MetricsRegistry:
    """A flat name -> instrument registry every layer can stream into.

    ``counter``/``gauge``/``tail`` create-or-return, so call sites never
    pre-declare; ``snapshot()`` folds the whole registry into one plain
    dict (the shape the trace report and the bench JSON payloads embed).
    """

    def __init__(self) -> None:
        self._instruments: dict[str, Counter | Gauge | TailStats] = {}

    def _get(self, name: str, cls, factory):
        inst = self._instruments.get(name)
        if inst is None:
            inst = factory()
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(f"{name!r} already registered as "
                            f"{type(inst).__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name))

    def tail(self, name: str,
             quantiles: Iterable[float] = DEFAULT_QUANTILES,
             exact: bool = False) -> TailStats:
        return self._get(name, TailStats,
                         lambda: TailStats(name, quantiles, exact=exact))

    def snapshot(self) -> dict:
        out: dict = {}
        for name, inst in sorted(self._instruments.items()):
            if isinstance(inst, TailStats):
                out[name] = inst.snapshot()
            elif isinstance(inst, Gauge):
                out[name] = {"value": inst.value, "max": inst.max,
                             "min": inst.min}
            else:
                out[name] = inst.value
        return out
