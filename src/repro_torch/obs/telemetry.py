"""The telemetry facade the serving stack calls into.

One :class:`Telemetry` instance per engine, threaded by reference into
the scheduler, KV pool, prefix cache, drafter, and fault layer.  Every
instrumentation point in the serving stack is a single method call on
this object; the default is the module-level :data:`NULL` —
a :class:`NullTelemetry` whose methods are all no-ops and whose
``clock()`` never reads the time — so a telemetry-off engine pays one
attribute load plus one no-op call per event and takes **no** clock
reads on the hot path.

Everything here is host-side Python over ``time.perf_counter()``; no
method ever touches a compiled step, a CUDA graph or a device tensor, and
none synchronizes the card (no ``torch.cuda.synchronize``, no ``.item()``,
no CUDA event): the engine's own ``.cpu()`` copy of a step's logits is
the only synchronizing point a device span closes after.  That is how the
on/off token-identity and no-new-program invariants hold by construction
(checked end-to-end in ``tests/test_torch_obs.py``).

Per-request event log: when telemetry is live, every lifecycle event is
also appended to ``request.obs_events`` as ``(label, t_seconds)`` — the
request's own latency ledger, readable after ``drain()`` without going
through the trace file.

See :mod:`repro_torch.obs` for the event taxonomy and the trace file
format, and :mod:`repro_torch.obs.metrics` for the drain-vs-lifetime reset
contract.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional

from repro_torch.obs.attrib import finalize_summary, \
    fresh_totals as _fresh_totals, update_aggregates
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.monitors import Monitors
from repro_torch.obs.trace import TraceRecorder

__all__ = ["NullTelemetry", "Telemetry", "NULL"]


class NullTelemetry:
    """The telemetry-off stand-in: every event method is an explicit
    no-op and :meth:`clock` returns 0.0 without reading the time — the
    disabled path costs one method call, never a syscall."""

    enabled = False
    registry = None
    tracer = None
    cost_model = None
    monitors = None
    alerts: tuple = ()

    def clock(self) -> float:
        return 0.0

    # -- lifecycle -----------------------------------------------------
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

    # -- step phases ---------------------------------------------------
    def step_begin(self) -> None: pass
    def device_span(self, t0) -> None: pass
    def draft_span(self, t0) -> None: pass
    def step_family(self, label, real, width) -> None: pass
    def step_end(self, scheduler, pool, finished, now=None) -> None: pass

    # -- attribution (repro_torch.obs.attrib) --------------------------------
    def attach_cost_model(self, cost_model) -> None: pass
    def attribution_summary(self) -> dict: return {}
    def reset_drain(self) -> None: pass

    # -- component instants --------------------------------------------
    def cow(self) -> None: pass
    def prefix_hit(self, tokens, pages) -> None: pass
    def prefix_evict(self, freed) -> None: pass
    def spec_rollback(self, req, pages) -> None: pass
    def draft_batch(self, rows, tokens) -> None: pass
    def drafter_error(self) -> None: pass
    def fault(self, kind, step) -> None: pass


NULL = NullTelemetry()


class Telemetry(NullTelemetry):
    """Live telemetry: streaming metrics always, trace recording unless
    ``trace=False``.  All timestamps come from one monotonic ``clock``
    (``time.perf_counter`` by default; injectable for tests)."""

    enabled = True

    def __init__(self, *, trace: bool = True, clock=time.perf_counter,
                 max_trace_events: int = 1 << 20):
        self._clock = clock
        self.registry = MetricsRegistry()
        self.tracer = (TraceRecorder(clock=clock,
                                     max_events=max_trace_events)
                       if trace else None)
        r = self.registry
        # latency histograms (seconds)
        self.h_ttft = r.histogram("ttft_s")
        self.h_itl = r.histogram("itl_s")
        self.h_queue_wait = r.histogram("queue_wait_s")
        self.h_e2e = r.histogram("e2e_s")
        # per-step phase breakdown (seconds).  Attribution completeness:
        # wall == sched + device + draft + host by construction (the
        # split is derived from the step's own span timestamps; asserted
        # within tolerance in tests/test_torch_attrib.py).  ``sched`` is the
        # host time before the first device/draft span (admission, page
        # growth, chunk planning); ``host`` is the interleaved + post-
        # device remainder (verify loop, numpy staging).
        self.h_step_wall = r.histogram("step_wall_s")
        self.h_step_host = r.histogram("step_host_s")
        self.h_step_device = r.histogram("step_device_s")
        self.h_step_draft = r.histogram("step_draft_s")
        self.h_step_sched = r.histogram("step_sched_s")
        # padding waste: padded-minus-real grid positions priced at the
        # step family's roofline per-token cost (needs the warmup-built
        # cost model; observes 0.0 until one is attached)
        self.h_step_waste = r.histogram("step_padding_waste_s")
        # event counters (drain-scoped: reset via Engine.telemetry(reset=True))
        self.c_queued = r.counter("requests_queued")
        self.c_admitted = r.counter("requests_admitted")
        self.c_finished = r.counter("requests_finished")
        self.c_tokens_out = r.counter("tokens_out")
        self.c_prefill_tokens = r.counter("prefill_tokens")
        self.c_preemptions = r.counter("preemptions")
        self.c_pauses = r.counter("pauses")
        self.c_reclaims = r.counter("reclaims")
        self.c_sheds = r.counter("sheds")
        self.c_timeouts = r.counter("timeouts")
        self.c_cancels = r.counter("cancels")
        self.c_quarantines = r.counter("quarantines")
        self.c_cow = r.counter("cow_copies")
        self.c_rollback_pages = r.counter("spec_rollback_pages")
        self.c_prefix_hits = r.counter("prefix_hits")
        self.c_prefix_hit_tokens = r.counter("prefix_hit_tokens")
        self.c_prefix_evictions = r.counter("prefix_evictions")
        self.c_faults = r.counter("faults_injected")
        self.c_drafter_errors = r.counter("drafter_errors")
        self.c_draft_rows = r.counter("draft_rows")
        self.c_draft_tokens = r.counter("draft_tokens")
        self.c_steps = r.counter("steps")
        self.c_goodput_tokens = r.counter("goodput_tokens")
        self.c_alerts = r.counter("alerts_emitted")
        # momentary levels, sampled once per step
        self.g_queue_depth = r.gauge("queue_depth")
        self.g_running = r.gauge("running_slots")
        self.g_pool_used = r.gauge("pool_pages_used")
        # live per-request records: rid -> phase bookkeeping
        self._live: Dict[int, dict] = {}
        # current step's accumulators
        self._step_t0: Optional[float] = None
        self._dev_s = 0.0
        self._draft_s = 0.0
        self._dev_window = None        # (t0, t1) of the latest device call
        # attribution state (repro_torch.obs.attrib): the warmup-frozen cost
        # model, this step's family tags, a bounded window of per-step
        # attribution records (tests + the HTML waterfall), and running
        # per-family aggregates that survive the window bound
        self.cost_model = None
        self.monitors = Monitors()
        self._families: list = []      # (label, real, width, dev_s) tags
        self._first_span_t0: Optional[float] = None
        self._last_dev = 0.0
        self.step_records: Deque[dict] = deque(maxlen=4096)
        self._agg_tot: dict = _fresh_totals()
        self._agg_fams: Dict[str, dict] = {}

    @property
    def alerts(self):
        return self.monitors.alerts

    # ------------------------------------------------------------------
    def clock(self) -> float:
        return self._clock()

    def _mark(self, req, label: str, t: float) -> None:
        req.obs_events.append((label, t))

    @staticmethod
    def _slot_track(req) -> str:
        return f"slot {req.slot}" if req.slot >= 0 else "scheduler"

    # -- lifecycle -----------------------------------------------------
    def request_queued(self, req) -> None:
        t = self._clock()
        self.c_queued.inc()
        self._live[req.rid] = {
            "born": t, "phase": "queued", "phase_t0": t,
            "emitted": 0, "last_emit": t,
        }
        self._mark(req, "queued", t)
        if self.tracer:
            self.tracer.async_begin("scheduler", "queue", req.rid, t,
                                    args={"rid": req.rid})

    def request_admitted(self, req) -> None:
        rec = self._live.get(req.rid)
        if rec is None:
            return
        t = self._clock()
        self.c_admitted.inc()
        self.h_queue_wait.observe(t - rec["phase_t0"])
        rec["phase"] = "prefill"
        rec["phase_t0"] = t
        self._mark(req, "admitted", t)
        if self.tracer:
            self.tracer.async_end("scheduler", "queue", req.rid, t)

    def request_prefill_chunk(self, req, n: int) -> None:
        rec = self._live.get(req.rid)
        if rec is None:
            return
        self.c_prefill_tokens.inc(n)
        t = self._clock()
        self._mark(req, "prefill_chunk", t)
        if self.tracer:
            w = self._dev_window or (t, t)
            self.tracer.complete(self._slot_track(req), "prefill",
                                 w[0], w[1],
                                 args={"rid": req.rid, "tokens": n,
                                       "cursor": req.prefill_cursor})

    def request_prefill_done(self, req) -> None:
        rec = self._live.get(req.rid)
        if rec is None:
            return
        t = self._clock()
        rec["phase"] = "decode"
        rec["phase_t0"] = t
        self._mark(req, "prefill_done", t)

    def _close_decode(self, req, rec, t: float) -> None:
        if rec["phase"] == "decode" and self.tracer:
            self.tracer.complete(self._slot_track(req), "decode",
                                 rec["phase_t0"], t,
                                 args={"rid": req.rid,
                                       "tokens": len(req.out_tokens)})

    def request_preempted(self, req) -> None:
        rec = self._live.get(req.rid)
        if rec is None:
            return
        t = self._clock()
        self.c_preemptions.inc()
        self._close_decode(req, rec, t)
        self._mark(req, "preempted", t)
        if self.tracer:
            self.tracer.instant(self._slot_track(req), "preempt", t,
                                args={"rid": req.rid})
            self.tracer.async_begin("scheduler", "queue", req.rid, t,
                                    args={"rid": req.rid, "requeue": True})
        rec["phase"] = "queued"
        rec["phase_t0"] = t

    def request_paused(self, req) -> None:
        rec = self._live.get(req.rid)
        if rec is None:
            return
        t = self._clock()
        self.c_pauses.inc()
        self._mark(req, "paused", t)
        if self.tracer:
            self.tracer.instant(self._slot_track(req), "pause", t,
                                args={"rid": req.rid,
                                      "cursor": req.prefill_cursor})
            self.tracer.async_begin("scheduler", "queue", req.rid, t,
                                    args={"rid": req.rid, "paused": True})
        rec["phase"] = "queued"
        rec["phase_t0"] = t

    def request_reclaimed(self, req) -> None:
        if req.rid not in self._live:
            return
        t = self._clock()
        self.c_reclaims.inc()
        self._mark(req, "reclaimed", t)
        if self.tracer:
            self.tracer.instant("scheduler", "reclaim", t,
                                args={"rid": req.rid})

    def request_finished(self, req) -> None:
        rec = self._live.get(req.rid)
        if rec is None:
            return
        t = self._clock()
        self.c_finished.inc()
        self.h_e2e.observe(t - rec["born"])
        self._close_decode(req, rec, t)
        rec["phase"] = "done"
        self._mark(req, "finished", t)

    def request_cancelled(self, req, reason: str) -> None:
        rec = self._live.get(req.rid)
        if rec is None:
            return
        t = self._clock()
        if reason == "timeout":
            self.c_timeouts.inc()
        elif reason == "error":
            self.c_quarantines.inc()
        else:
            self.c_cancels.inc()
        self._close_decode(req, rec, t)
        if self.tracer:
            if rec["phase"] == "queued":
                self.tracer.async_end("scheduler", "queue", req.rid, t)
            name = "quarantine" if reason == "error" else reason
            self.tracer.instant(self._slot_track(req), name, t,
                                args={"rid": req.rid})
        rec["phase"] = "done"
        self._mark(req, f"cancelled:{reason}", t)

    def request_shed(self, req, kind: str) -> None:
        # shed at add(): the request never entered the queue, so there is
        # no live record and no open queue span — just the mark
        t = self._clock()
        self.c_sheds.inc()
        self._mark(req, f"shed:{kind}", t)
        if self.tracer:
            self.tracer.instant("scheduler", "shed", t,
                                args={"rid": req.rid, "kind": kind})

    # -- step phases ---------------------------------------------------
    def step_begin(self) -> None:
        self._step_t0 = self._clock()
        self._dev_s = 0.0
        self._draft_s = 0.0
        self._dev_window = None
        self._families = []
        self._first_span_t0 = None
        self._last_dev = 0.0

    def device_span(self, t0: float) -> None:
        t1 = self._clock()
        self._dev_s += t1 - t0
        self._dev_window = (t0, t1)
        self._last_dev = t1 - t0
        if self._first_span_t0 is None:
            self._first_span_t0 = t0
        if self.tracer:
            self.tracer.complete("engine", "device", t0, t1)

    def draft_span(self, t0: float) -> None:
        t1 = self._clock()
        self._draft_s += t1 - t0
        if self._first_span_t0 is None:
            self._first_span_t0 = t0
        if self.tracer:
            self.tracer.complete("engine", "draft", t0, t1)

    def step_family(self, label: str, real: int, width: int) -> None:
        """Tag the device span just recorded with its compiled shape
        family (called by the engine right after ``device_span``):
        ``real`` useful tokens rode a ``width``-position grid."""
        self._families.append((label, int(real), int(width),
                               self._last_dev))

    def step_end(self, scheduler, pool, finished, now=None) -> None:
        t1 = self._clock()
        running = list(scheduler.running.values())
        # token accounting first: one TTFT observation per request (its
        # first emission), one ITL observation per emission *episode* —
        # a speculative burst of k tokens in one step is one episode
        for req in running + list(finished):
            rec = self._live.get(req.rid)
            if rec is None:
                continue
            cur = len(req.out_tokens)
            if cur > rec["emitted"]:
                if rec["emitted"] == 0:
                    ttft = t1 - rec["born"]
                    self.h_ttft.observe(ttft)
                    self.monitors.observe_ttft(ttft)
                else:
                    itl = t1 - rec["last_emit"]
                    self.h_itl.observe(itl)
                    self.monitors.observe_itl(itl)
                emitted = cur - rec["emitted"]
                self.c_tokens_out.inc(emitted)
                # goodput: emissions land inside the request deadline.
                # Judged on the *engine's* clock (``now``), the same one
                # deadline cancellation uses — no deadline or no engine
                # clock means every token counts.
                deadline = getattr(req, "deadline_s", None)
                if (deadline is None or now is None
                        or now - req.arrival <= deadline):
                    self.c_goodput_tokens.inc(emitted)
                rec["emitted"] = cur
                rec["last_emit"] = t1
        for req in finished:
            self._live.pop(req.rid, None)
        # momentary levels
        self.g_queue_depth.set(len(scheduler.waiting))
        self.g_running.set(len(running))
        if pool is not None:
            self.g_pool_used.set(pool.num_used)
        # a step that moved nothing (idle poll before arrivals) draws no
        # span and no wall-time sample, mirroring Engine._steps
        if not running and not finished:
            return
        t0 = self._step_t0 if self._step_t0 is not None else t1
        wall = t1 - t0
        # wall decomposition — complete by construction: ``sched`` is
        # host time before the first device/draft span, ``host`` is the
        # remainder after subtracting the measured spans, so the four
        # components sum back to wall exactly (up to float rounding;
        # asserted in tests/test_torch_attrib.py)
        first = self._first_span_t0
        sched = min(max(0.0, (first if first is not None else t1) - t0),
                    wall)
        host = max(0.0, wall - sched - self._dev_s - self._draft_s)
        waste = 0.0
        if self.cost_model is not None:
            for label, real, width, _dev in self._families:
                fc = self.cost_model.get(label)
                if fc is not None:
                    waste += (width - real) * fc.per_token_s
        self.c_steps.inc()
        self.h_step_wall.observe(wall)
        self.h_step_host.observe(host)
        self.h_step_device.observe(self._dev_s)
        self.h_step_draft.observe(self._draft_s)
        self.h_step_sched.observe(sched)
        self.h_step_waste.observe(waste)
        rec = {"wall": wall, "sched": sched, "device": self._dev_s,
               "draft": self._draft_s, "host": host,
               "families": tuple(self._families)}
        self.step_records.append(rec)
        update_aggregates(self._agg_tot, self._agg_fams, rec,
                          self.cost_model)
        alerts = self.monitors.observe_step(
            t=t1, scheduler=scheduler, telemetry=self,
            families=self._families, device_s=self._dev_s)
        for a in alerts:
            self.c_alerts.inc()
            if self.tracer:
                self.tracer.instant("monitor", f"alert:{a.kind}", a.t,
                                    args=a.to_dict())
        if self.tracer:
            self.tracer.complete(
                "engine", "step", t0, t1,
                args={"running": len(running),
                      "finished": len(finished),
                      "families": [f[0] for f in self._families]})
            if pool is not None:
                self.tracer.counter("pool", "pages",
                                    {"used": pool.num_used,
                                     "free": pool.num_free}, t1)
            self.tracer.counter("scheduler", "load",
                                {"waiting": len(scheduler.waiting),
                                 "running": len(running)}, t1)

    # -- attribution (repro_torch.obs.attrib) --------------------------------
    def attach_cost_model(self, cost_model) -> None:
        """Install the warmup-built :class:`~repro_torch.obs.
        attrib.StepCostModel`.  Called once, from ``Engine.warmup()`` — the
        warmup-only contract: nothing per-step ever builds a program."""
        self.cost_model = cost_model

    def attribution_summary(self) -> dict:
        """The per-drain attribution roll-up (totals, per-family
        predicted-vs-measured, MFU/MBU, goodput)."""
        return finalize_summary(
            self._agg_tot, self._agg_fams, self.cost_model,
            goodput_tokens=self.c_goodput_tokens.value,
            tokens_out=self.c_tokens_out.value)

    def reset_drain(self) -> None:
        """Drop drain-scoped state: metrics, per-step attribution
        records and aggregates.  Lifetime metrics, the cost model, the
        monitors' alert history and the trace all survive."""
        self.registry.reset("drain")
        self.step_records.clear()
        self._agg_tot = _fresh_totals()
        self._agg_fams = {}

    # -- component instants --------------------------------------------
    def cow(self) -> None:
        self.c_cow.inc()
        if self.tracer:
            self.tracer.instant("pool", "cow", self._clock())

    def prefix_hit(self, tokens: int, pages: int) -> None:
        self.c_prefix_hits.inc()
        self.c_prefix_hit_tokens.inc(tokens)
        if self.tracer:
            self.tracer.instant("pool", "prefix_hit", self._clock(),
                                args={"tokens": tokens, "pages": pages})

    def prefix_evict(self, freed: int) -> None:
        self.c_prefix_evictions.inc(freed)
        if self.tracer:
            self.tracer.instant("pool", "prefix_evict", self._clock(),
                                args={"pages": freed})

    def spec_rollback(self, req, pages: int) -> None:
        self.c_rollback_pages.inc(pages)
        if self.tracer:
            self.tracer.instant(self._slot_track(req), "spec_rollback",
                                self._clock(),
                                args={"rid": req.rid, "pages": pages})

    def draft_batch(self, rows: int, tokens: int) -> None:
        self.c_draft_rows.inc(rows)
        self.c_draft_tokens.inc(tokens)

    def drafter_error(self) -> None:
        self.c_drafter_errors.inc()
        if self.tracer:
            self.tracer.instant("engine", "drafter_error", self._clock())

    def fault(self, kind: str, step: int) -> None:
        self.c_faults.inc()
        if self.tracer:
            self.tracer.instant("engine", f"fault:{kind}", self._clock(),
                                args={"step": step})

    # ------------------------------------------------------------------
    def latency_summary(self) -> dict:
        """The headline percentiles — TTFT / ITL / queue wait / e2e."""
        return {name: h.snapshot() for name, h in
                (("ttft_s", self.h_ttft), ("itl_s", self.h_itl),
                 ("queue_wait_s", self.h_queue_wait),
                 ("e2e_s", self.h_e2e))}

    def export_trace(self, path) -> None:
        assert self.tracer is not None, "telemetry was built with trace=False"
        self.tracer.export(path)
