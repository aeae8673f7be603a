"""``repro_torch.obs`` — serving observability: lifecycle tracing, streaming
metrics, performance attribution, anomaly monitors, Perfetto trace
export, Prometheus/HTML exposition.

The port of the JAX package's ``repro.obs``, with the same event names,
metric names, family labels and Prometheus series.  Strictly host-side:
every event is a Python method call timed with ``time.perf_counter()``;
nothing here touches a compiled step, a CUDA graph, a device tensor or
the token math, and nothing synchronizes the card.  The standing serving
invariants therefore hold by construction — telemetry on/off is
token-identical, adds no step signature and captures no graph after
warmup, and the disabled default (:data:`~repro_torch.obs.telemetry.NULL`)
costs one no-op call per event with no clock reads (all checked in
``tests/test_torch_obs.py``).

Event taxonomy
==============

**Request lifecycle** (per-request; mirrors the scheduler's state
machine, see :mod:`repro_torch.serving.scheduler`).  Durations render as
spans, transitions as instants; each also lands in the request's own
``obs_events`` list as ``(label, t)``:

========================  ==========================================
event                     meaning
========================  ==========================================
``queued``                entered the scheduler's waiting queue
``admitted``              took a slot (queue-wait span closes)
``prefill_chunk``         one chunk of prompt KV written (span per
                          chunk on the slot's track)
``prefill_done``          prompt KV complete; decode span opens
``preempted``             pages released, tokens folded, requeued
``paused``                mid-prefill victim: slot surrendered,
                          pages + cursor kept, requeued
``reclaimed``             a paused request's pages were reclaimed
``finished``              happy-path exit (eos | length)
``cancelled:<reason>``    retired early: ``timeout`` | ``cancelled``
                          | ``error`` (the NaN-logit quarantine)
``shed:<kind>``           rejected at ``add()`` by admission control
                          (never queued)
========================  ==========================================

**Step phases** (per engine step, on the ``engine`` track): a ``step``
span wrapping ``device`` (the model call up to the host copy of its
logits) and ``draft`` (drafter
proposal) sub-spans; host planning time is the remainder.

**Component instants**: ``cow`` (copy-on-write page split),
``prefix_hit`` / ``prefix_evict`` (prefix cache), ``spec_rollback``
(rejected speculative pages truncated), ``drafter_error``,
``fault:<kind>`` (injected by :mod:`repro_torch.serving.faults`).

Streaming metrics
=================

A :class:`~repro_torch.obs.metrics.MetricsRegistry` of counters, gauges, and
fixed-bucket geometric histograms (p50/p95/p99 without retaining
samples): TTFT, ITL, queue wait, e2e latency, and the per-step
wall/host/device/draft breakdown.  Reset semantics are explicit and
documented in :mod:`repro_torch.obs.metrics` — drain-scoped metrics reset
only via ``Engine.telemetry(reset=True)``; lifetime metrics never.
``Engine.telemetry()`` is the one unified view: components' classic
``stats()`` dicts + the registry snapshot + headline percentiles.

Performance attribution
=======================

:mod:`repro_torch.obs.attrib` grounds the measured numbers in the
paper's predictability story.  ``Engine.warmup()`` (telemetry on) builds a
:class:`~repro_torch.obs.attrib.StepCostModel` — one roofline-priced
:class:`~repro_torch.obs.attrib.FamilyCost` per step family on the
engine's ladder, counted in closed form from the engine's geometry (the
JAX package's XLA dot FLOPs exactly, and the port's own byte count) — and
freezes it
(the warmup-only contract: the per-step hot path only ever does dict
lookups).  Each measured step is tagged with its family label(s) and
its wall split into ``sched + device + draft + host`` — complete by
construction, the components sum back to the wall (asserted in
``tests/test_torch_attrib.py``).  Drain roll-ups report MFU/MBU, padding
waste (padded-minus-real grid positions priced at the family's
roofline per-token cost), predicted-vs-measured per family, achieved-
vs roofline-tokens/s, and goodput (tokens emitted inside
``deadline_s``, surfaced via ``Engine.stats()["slo"]``).

Anomaly monitors
================

:mod:`repro_torch.obs.monitors` runs five host-side online detectors once per
step — ``step-outlier`` (per-family device time vs rolling median),
``preempt-storm``, ``prefix-churn``, ``queue-growth``, and ``slo-burn``
(TTFT/ITL target violation rate) — emitting typed
:class:`~repro_torch.obs.monitors.Alert`\\ s that land in
``Engine.telemetry()["alerts"]``, the ``alerts_emitted`` counter, and
the ``monitor`` trace track.  One alert per excursion (re-arm on
clearing), bounded retention.

Exposition formats
==================

:mod:`repro_torch.obs.export` renders the above without observing anything:
:func:`~repro_torch.obs.export.prometheus_text` (text format 0.0.4, linted by
the pure-python :func:`~repro_torch.obs.export.lint_prometheus`) and
:func:`~repro_torch.obs.export.html_report` (one self-contained file —
attribution waterfall, per-family table, latency percentiles, alert
log).  ``Engine.telemetry(report=path)`` writes the ``.html``/``.prom``
pair; ``chip_smoke.py``'s telemetry phase writes and lints both on the
card.

Trace file format
=================

Chrome ``trace_event`` JSON (the ``{"traceEvents": [...]}`` flavour),
loadable in Perfetto or ``chrome://tracing``; microsecond timestamps
relative to recorder birth.  One track (thread) per serving slot plus
``engine`` / ``scheduler`` / ``pool`` tracks; ``"X"`` complete spans
for prefill chunks, decode runs, and step phases; ``"b"``/``"e"``
async spans for (overlapping) queue waits keyed by rid; ``"i"``
instants for the transition events above; ``"C"`` counters for pool
occupancy and scheduler load.  Details in :mod:`repro_torch.obs.trace`.
"""

from repro_torch.obs.attrib import (FamilyCost, StepCostModel,
                                    build_cost_model, summarize)
from repro_torch.obs.export import (html_report, lint_prometheus,
                                    prometheus_text, write_report)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.monitors import Alert, Monitors
from repro_torch.obs.telemetry import NULL, NullTelemetry, Telemetry
from repro_torch.obs.trace import TraceRecorder

__all__ = [
    "Alert", "Counter", "FamilyCost", "Gauge", "Histogram",
    "MetricsRegistry", "Monitors", "NULL", "NullTelemetry",
    "StepCostModel", "Telemetry", "TraceRecorder", "build_cost_model",
    "html_report", "lint_prometheus", "prometheus_text", "summarize",
    "write_report",
]
