"""Chrome ``trace_event`` recorder — drains become Perfetto timelines.

The recorder accumulates a flat list of trace-event dicts in the format
consumed by Perfetto and ``chrome://tracing`` (the Trace Event Format's
JSON flavour: ``{"traceEvents": [...]}``).  Events used here:

- ``"X"`` **complete** spans — a named interval with ``ts`` + ``dur``
  (microseconds).  Used for everything that nests cleanly on one track:
  per-slot prefill chunks and decode runs, per-step ``step`` spans and
  their ``device`` / ``draft`` sub-spans on the engine track.
- ``"b"`` / ``"e"`` **async** spans — id-matched begin/end pairs that may
  overlap on a track.  Used for queue-wait episodes on the scheduler
  track (many requests wait concurrently) — ``cat`` + ``id`` pair them.
- ``"i"`` **instant** events — point markers: preemptions, pauses,
  reclaims, CoW copies, spec rollbacks, sheds, timeouts, quarantines,
  injected faults, prefix-cache hits and evictions.
- ``"C"`` **counter** events — stacked series (pool pages in use, queue
  depth, running slots) sampled once per engine step.
- ``"M"`` **metadata** — ``thread_name`` records, one per track, so the
  UI shows ``slot 3`` / ``scheduler`` / ``pool`` instead of bare tids.

Track model: one process (``pid`` 1), one thread (track) per serving
slot plus dedicated ``engine`` / ``scheduler`` / ``pool`` tracks.
Timestamps are ``time.perf_counter()`` deltas from recorder birth,
scaled to integer microseconds — monotone by construction, which is what
the schema test asserts per track.

The recorder is bounded: ``max_events`` (default 1 << 20) caps memory on
unbounded drains; when full, new events are dropped and counted
(``dropped``) rather than growing without limit.
"""

from __future__ import annotations

import json
import time
from typing import Dict, List, Optional

__all__ = ["TraceRecorder"]

_PID = 1


class TraceRecorder:
    """Accumulates Chrome trace events host-side; :meth:`export` writes
    the ``{"traceEvents": [...]}`` JSON Perfetto loads directly."""

    def __init__(self, *, clock=time.perf_counter, max_events: int = 1 << 20):
        self._clock = clock
        self._t0 = clock()
        self._events: List[dict] = []
        self._tracks: Dict[str, int] = {}
        self._next_tid = 1
        self._max_events = max_events
        self.dropped = 0

    # ------------------------------------------------------------------
    def now_us(self) -> int:
        """Current trace timestamp (µs since recorder birth)."""
        return int((self._clock() - self._t0) * 1e6)

    def to_us(self, t: float) -> int:
        """Convert an absolute ``perf_counter()`` reading to trace µs."""
        return int((t - self._t0) * 1e6)

    def track(self, name: str) -> int:
        """Get-or-create the tid for a named track (emits the
        ``thread_name`` metadata record on first use)."""
        tid = self._tracks.get(name)
        if tid is None:
            tid = self._next_tid
            self._next_tid += 1
            self._tracks[name] = tid
            self._events.append({
                "ph": "M", "name": "thread_name", "pid": _PID, "tid": tid,
                "args": {"name": name},
            })
        return tid

    def _emit(self, ev: dict) -> None:
        if len(self._events) >= self._max_events:
            self.dropped += 1
            return
        self._events.append(ev)

    # ------------------------------------------------------------------
    def complete(self, track: str, name: str, t0: float, t1: float,
                 args: Optional[dict] = None) -> None:
        """A closed ``"X"`` span from absolute clock readings ``t0..t1``."""
        ts = self.to_us(t0)
        ev = {"ph": "X", "name": name, "pid": _PID, "tid": self.track(track),
              "ts": ts, "dur": max(0, self.to_us(t1) - ts)}
        if args:
            ev["args"] = args
        self._emit(ev)

    def instant(self, track: str, name: str, t: Optional[float] = None,
                args: Optional[dict] = None) -> None:
        ev = {"ph": "i", "name": name, "pid": _PID, "tid": self.track(track),
              "ts": self.now_us() if t is None else self.to_us(t), "s": "t"}
        if args:
            ev["args"] = args
        self._emit(ev)

    def async_begin(self, track: str, name: str, id_: int,
                    t: Optional[float] = None,
                    args: Optional[dict] = None) -> None:
        """Open an overlappable span (queue-wait episodes share a track)."""
        ev = {"ph": "b", "cat": "req", "name": name, "id": id_,
              "pid": _PID, "tid": self.track(track),
              "ts": self.now_us() if t is None else self.to_us(t)}
        if args:
            ev["args"] = args
        self._emit(ev)

    def async_end(self, track: str, name: str, id_: int,
                  t: Optional[float] = None) -> None:
        self._emit({"ph": "e", "cat": "req", "name": name, "id": id_,
                    "pid": _PID, "tid": self.track(track),
                    "ts": self.now_us() if t is None else self.to_us(t)})

    def counter(self, track: str, name: str, values: Dict[str, float],
                t: Optional[float] = None) -> None:
        """A ``"C"`` sample — ``values`` become stacked series in the UI."""
        self._emit({"ph": "C", "name": name, "pid": _PID,
                    "tid": self.track(track),
                    "ts": self.now_us() if t is None else self.to_us(t),
                    "args": dict(values)})

    # ------------------------------------------------------------------
    def events(self) -> List[dict]:
        """The event list (live reference; treat as read-only)."""
        return self._events

    def to_json(self) -> dict:
        """The full trace document, events sorted by timestamp (metadata
        first) as the viewers prefer."""
        order = {"M": 0}
        evs = sorted(self._events,
                     key=lambda e: (order.get(e["ph"], 1), e.get("ts", 0)))
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def export(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f)
