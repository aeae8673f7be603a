"""Streaming metrics: counters, gauges, and fixed-bucket histograms.

Zero-dependency (stdlib + the host's float math), zero-retention: a
:class:`Histogram` folds every observation into a fixed geometric bucket
grid at ``observe`` time and answers p50/p95/p99 by interpolating inside
the bucket the requested rank lands in — memory is O(buckets) forever,
never O(samples), which is what lets the serving engine keep latency
percentiles on every step of a long-lived drain without growing state.

Accuracy contract: with bucket ``factor`` f (adjacent bucket edges are a
ratio f apart), any percentile estimate is within a factor of f of the
exact sample quantile — the default ``f = 2**0.25`` bounds the relative
error at ~19% of the value, far below the run-to-run noise of host wall
timings, for 120-odd int buckets per histogram.  Estimates are clamped
to the observed ``[min, max]``, so single-sample histograms are exact.

Reset semantics (the registry's per-metric ``scope``):

- ``"drain"`` (the default) — the metric measures a *serving window*:
  it accumulates until the owner explicitly resets it
  (``MetricsRegistry.reset()``; the engine exposes this as
  ``Engine.telemetry(reset=True)``, typically called once per drain).
  Nothing resets implicitly — two back-to-back drains without a reset
  read as one window, by design, never double-counted.
- ``"lifetime"`` — never reset: monotone totals and peaks that mirror
  the classic ``stats()`` counters.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """A monotone event count (``inc``).  ``scope`` says who resets it."""

    __slots__ = ("name", "scope", "value")

    def __init__(self, name: str, *, scope: str = "drain"):
        assert scope in ("drain", "lifetime"), scope
        self.name = name
        self.scope = scope
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0

    def snapshot(self):
        return self.value


class Gauge:
    """A momentary level (``set``) — queue depth, live slots, pool pages.
    A gauge has no window to reset: it always reads the last value."""

    __slots__ = ("name", "scope", "value")

    def __init__(self, name: str):
        self.name = name
        self.scope = "lifetime"      # momentary; reset would be meaningless
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def reset(self) -> None:
        pass

    def snapshot(self):
        return self.value


class Histogram:
    """Fixed-bucket streaming histogram over positive reals.

    Buckets are geometric: edges ``lo * factor**i`` spanning ``[lo, hi]``,
    plus an underflow bucket ``[0, lo)`` and an overflow bucket
    ``[hi, inf)``.  ``observe`` is a bisect plus counter bumps; percentiles
    walk the cumulative counts once and interpolate log-linearly inside
    the landing bucket (linearly inside the underflow bucket, whose lower
    edge is 0).  No samples are retained.
    """

    __slots__ = ("name", "scope", "_edges", "_counts", "count", "total",
                 "_min", "_max")

    def __init__(self, name: str, *, lo: float = 1e-6, hi: float = 1e3,
                 factor: float = 2 ** 0.25, scope: str = "drain"):
        assert scope in ("drain", "lifetime"), scope
        assert 0 < lo < hi and factor > 1
        self.name = name
        self.scope = scope
        edges: List[float] = [lo]
        while edges[-1] < hi:
            edges.append(edges[-1] * factor)
        self._edges = edges                       # len(edges)+1 buckets
        self._counts = [0] * (len(edges) + 1)
        self.count = 0
        self.total = 0.0
        self._min: Optional[float] = None
        self._max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        if v < 0.0:
            v = 0.0                 # clock skew guard; latencies are >= 0
        self._counts[bisect_right(self._edges, v)] += 1
        self.count += 1
        self.total += v
        if self._min is None or v < self._min:
            self._min = v
        if self._max is None or v > self._max:
            self._max = v

    def percentile(self, q: float) -> float:
        """Estimate the ``q``-quantile (``0 <= q <= 1``) of everything
        observed so far; 0.0 on an empty histogram."""
        if self.count == 0:
            return 0.0
        need = q * self.count
        cum = 0.0
        for i, c in enumerate(self._counts):
            if c and cum + c >= need:
                frac = min(1.0, max(0.0, (need - cum) / c))
                lo = 0.0 if i == 0 else self._edges[i - 1]
                hi = (self._edges[i] if i < len(self._edges)
                      else (self._max if self._max is not None else lo))
                if lo <= 0.0 or hi <= lo:
                    est = lo + (hi - lo) * frac
                else:
                    est = lo * (hi / lo) ** frac       # log-linear
                return min(max(est, self._min), self._max)
            cum += c
        return self._max if self._max is not None else 0.0

    def reset(self) -> None:
        self._counts = [0] * len(self._counts)
        self.count = 0
        self.total = 0.0
        self._min = self._max = None

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "mean": self.total / self.count if self.count else 0.0,
            "min": self._min if self._min is not None else 0.0,
            "max": self._max if self._max is not None else 0.0,
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }


class MetricsRegistry:
    """The one named home for every streaming metric the telemetry layer
    keeps (counters, gauges, histograms), with uniform get-or-create
    accessors, one ``snapshot()`` and one explicit ``reset()``.

    Scope contract (see the module docstring): ``"drain"`` metrics are
    window counters the *caller* resets — ``reset()`` zeroes exactly
    those and nothing else; ``"lifetime"`` metrics and gauges survive.
    A metric's scope is fixed at first registration; re-registering with
    a different kind or scope is a bug and asserts.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, kind, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = kind(name, **kw)
            self._metrics[name] = m
        else:
            assert type(m) is kind, \
                f"metric {name!r} already registered as {type(m).__name__}"
            want = kw.get("scope")
            assert want is None or m.scope == want, \
                f"metric {name!r} registered with scope {m.scope!r}, " \
                f"asked for {want!r}"
        return m

    def counter(self, name: str, *, scope: str = "drain") -> Counter:
        return self._get(name, Counter, scope=scope)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, **kw) -> Histogram:
        return self._get(name, Histogram, **kw)

    def snapshot(self) -> dict:
        """``{name: value-or-histogram-summary}`` plus a ``_scope`` map
        so a reader can tell window counters from lifetime ones."""
        out = {name: m.snapshot() for name, m in self._metrics.items()}
        out["_scope"] = {name: m.scope for name, m in self._metrics.items()}
        return out

    def reset(self, scope: str = "drain") -> None:
        """Zero every metric of ``scope`` (the explicit per-drain reset —
        nothing in this module resets implicitly)."""
        for m in self._metrics.values():
            if m.scope == scope:
                m.reset()
