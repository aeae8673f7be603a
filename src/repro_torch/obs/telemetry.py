"""Telemetry hooks of the serving engine.  The port carries only the no-op
recorder so far: every event method does nothing.  Live metrics and
traces come with the port of ``obs/``."""

from __future__ import annotations

__all__ = ["NullTelemetry", "NULL"]


class NullTelemetry:
    # -- lifecycle --
    def request_queued(self, req) -> None: pass
    def request_admitted(self, req) -> None: pass
    def request_prefill_chunk(self, req, n) -> None: pass
    def request_prefill_done(self, req) -> None: pass
    def request_preempted(self, req) -> None: pass
    def request_paused(self, req) -> None: pass
    def request_reclaimed(self, req) -> None: pass
    def request_finished(self, req) -> None: pass
    def request_cancelled(self, req, reason) -> None: pass
    def request_shed(self, req, kind) -> None: pass

    # -- step phases --
    def step_begin(self) -> None: pass
    def step_end(self, scheduler, pool, finished, now=None) -> None: pass

    # -- component instants --
    def drafter_error(self) -> None: pass
    def fault(self, kind, step) -> None: pass


NULL = NullTelemetry()
