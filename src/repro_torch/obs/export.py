"""Exposition formats: Prometheus text and a single-file HTML report.

Zero-dependency (stdlib string building only) renderers over the
telemetry layer's already-computed state — nothing here observes, times,
or mutates anything; both functions are pure views a caller invokes
after (or between) drains, typically via ``Engine.telemetry(report=...)``.

**Prometheus** (:func:`prometheus_text`): the text exposition format,
version 0.0.4.  Counters become ``<prefix><name>_total`` counter
samples, gauges become gauges, histograms become *summaries* (quantile
label per percentile plus ``_sum``/``_count``) — the streaming
histograms already answer percentiles in O(buckets), so shipping ~120
cumulative ``le`` buckets per metric would cost exposition size for no
extra fidelity.  Per-family attribution rows ride a ``family`` label;
alerts ship as an ``alerts_total`` counter by ``kind``.  Metric and
label naming, sample uniqueness and counter monotonicity are linted by
:func:`lint_prometheus` (pure python, used by ``tests/test_torch_attrib``
and by ``chip_smoke.py``'s telemetry phase).

**HTML** (:func:`html_report`): one self-contained file — inline CSS,
no scripts, no external fetches — with the attribution waterfall
(sched/device/draft/host plus padding waste as a device sub-bar), the
per-family predicted-vs-measured table, latency percentiles, and the
alert log.  Opens from a file:// URL on an air-gapped box.
"""

from __future__ import annotations

import html
import re
from typing import List

__all__ = ["prometheus_text", "lint_prometheus", "html_report",
           "write_report"]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_QUANTILES = (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99"))


def _esc_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt(v) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return repr(f)


def prometheus_text(telemetry, *, prefix: str = "repro_") -> str:
    """Render a live :class:`~repro_torch.obs.telemetry.Telemetry` (its
    registry, attribution aggregates, and alerts) as Prometheus text."""
    from repro_torch.obs.metrics import Counter, Gauge, Histogram

    lines: List[str] = []

    def head(name: str, kind: str, help_: str) -> None:
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {kind}")

    reg = telemetry.registry
    for name in sorted(reg._metrics):
        m = reg._metrics[name]
        if isinstance(m, Counter):
            full = f"{prefix}{name}_total"
            head(full, "counter", f"{name} ({m.scope}-scoped counter)")
            lines.append(f"{full} {_fmt(m.value)}")
        elif isinstance(m, Gauge):
            full = f"{prefix}{name}"
            head(full, "gauge", f"{name} (momentary level)")
            lines.append(f"{full} {_fmt(m.value)}")
        elif isinstance(m, Histogram):
            full = f"{prefix}{name}"
            head(full, "summary", f"{name} (streaming histogram)")
            snap = m.snapshot()
            for q, key in _QUANTILES:
                lines.append(f'{full}{{quantile="{q}"}} {_fmt(snap[key])}')
            lines.append(f"{full}_sum {_fmt(m.total)}")
            lines.append(f"{full}_count {_fmt(m.count)}")

    summary = telemetry.attribution_summary()
    fams = summary.get("families", {})
    if fams:
        specs = [("family_steps_total", "counter", "steps", 1.0,
                  "steps executed per shape family"),
                 ("family_real_tokens_total", "counter", "real_tokens", 1.0,
                  "real tokens fed per shape family"),
                 ("family_padded_tokens_total", "counter", "padded_tokens",
                  1.0, "padded grid positions per shape family"),
                 ("family_device_seconds_total", "counter", "device_s", 1.0,
                  "measured device seconds per shape family"),
                 ("family_predicted_seconds_total", "counter", "predicted_s",
                  1.0, "roofline-predicted seconds per shape family"),
                 ("family_padding_waste_seconds_total", "counter",
                  "padding_waste_s", 1.0,
                  "padded-position device seconds per shape family")]
        for mname, kind, key, scale, help_ in specs:
            full = f"{prefix}{mname}"
            head(full, kind, help_)
            for label in sorted(fams):
                lines.append(
                    f'{full}{{family="{_esc_label(label)}"}} '
                    f"{_fmt(fams[label][key] * scale)}")
    for key in ("mfu", "mbu", "padding_waste_ratio", "goodput_ratio"):
        if key in summary:
            full = f"{prefix}{key}"
            head(full, "gauge", f"per-drain {key}")
            lines.append(f"{full} {_fmt(summary[key])}")

    counts: dict = {}
    for a in telemetry.alerts:
        counts[a.kind] = counts.get(a.kind, 0) + 1
    if telemetry.monitors is not None:
        full = f"{prefix}alerts_total"
        head(full, "counter", "anomaly alerts by kind")
        for kind in sorted(counts):
            lines.append(f'{full}{{kind="{_esc_label(kind)}"}} '
                         f"{_fmt(counts[kind])}")

    return "\n".join(lines) + "\n"


def lint_prometheus(text: str) -> List[str]:
    """Pure-python lint of the text exposition format.  Returns a list of
    problem strings (empty == clean): metric/label naming, TYPE declared
    before samples, no duplicate ``(name, labelset)`` samples, counters
    named ``_total`` with finite non-negative values, parseable floats."""
    problems: List[str] = []
    types: dict = {}
    seen: set = set()
    sample_re = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)(\s+\d+)?$")
    label_re = re.compile(r'([a-zA-Z0-9_]+)=("(?:[^"\\]|\\.)*")')
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "summary", "histogram", "untyped"):
                problems.append(f"line {i}: malformed TYPE line")
                continue
            types[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = sample_re.match(line)
        if not m:
            problems.append(f"line {i}: unparseable sample {line!r}")
            continue
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        if not _NAME_RE.match(name):
            problems.append(f"line {i}: bad metric name {name!r}")
        base = name
        for suffix in ("_sum", "_count", "_bucket", "_total"):
            if name.endswith(suffix) and name[:-len(suffix)] in types:
                base = name[:-len(suffix)]
                break
        mtype = types.get(base) or types.get(name)
        if mtype is None:
            problems.append(f"line {i}: sample {name!r} has no TYPE")
        if labels:
            body = labels[1:-1]
            if body and label_re.sub("", body).strip(", ") != "":
                problems.append(f"line {i}: malformed labels {labels!r}")
            for lname, _ in label_re.findall(body):
                if not _LABEL_RE.match(lname) or lname.startswith("__"):
                    problems.append(f"line {i}: bad label name {lname!r}")
        key = (name, labels)
        if key in seen:
            problems.append(f"line {i}: duplicate sample {name}{labels}")
        seen.add(key)
        try:
            v = float(value.replace("+Inf", "inf").replace("-Inf", "-inf"))
        except ValueError:
            problems.append(f"line {i}: unparseable value {value!r}")
            continue
        if mtype == "counter":
            if not name.endswith("_total"):
                problems.append(
                    f"line {i}: counter {name!r} must end in _total")
            if not (v >= 0.0):
                problems.append(
                    f"line {i}: counter {name!r} negative ({v})")
    return problems


# ----------------------------------------------------------------------
# HTML report
# ----------------------------------------------------------------------

_CSS = """
body{font-family:system-ui,sans-serif;margin:2em;max-width:70em;
     color:#1a1a2e}
h1{font-size:1.4em} h2{font-size:1.1em;margin-top:1.6em}
table{border-collapse:collapse;font-size:0.85em;font-variant-numeric:
      tabular-nums}
th,td{border:1px solid #ccc;padding:0.3em 0.6em;text-align:right}
th:first-child,td:first-child{text-align:left;font-family:monospace}
.bar{display:flex;height:1.6em;border:1px solid #999;max-width:60em}
.bar div{height:100%;overflow:hidden;font-size:0.7em;color:#fff;
         white-space:nowrap;padding-left:0.2em}
.sched{background:#6c5ce7}.device{background:#00896f}
.draft{background:#e17055}.host{background:#636e72}
.waste{background:#d63031}.useful{background:#00896f}
.crit{color:#d63031;font-weight:bold}.warn{color:#e17055}
.kv{color:#555;font-size:0.85em}
"""


def _bar(parts, total: float) -> str:
    if total <= 0:
        return "<div class='bar'></div>"
    cells = []
    for cls, label, v in parts:
        pct = 100.0 * v / total
        if pct < 0.05:
            continue
        cells.append(f"<div class='{cls}' style='width:{pct:.2f}%' "
                     f"title='{html.escape(label)}: {v:.4f}s "
                     f"({pct:.1f}%)'>{html.escape(label)}</div>")
    return "<div class='bar'>" + "".join(cells) + "</div>"


def html_report(telemetry, *, title: str = "serving report") -> str:
    """Render the attribution waterfall, per-family table, latency
    percentiles and alert log as one self-contained HTML page."""
    summary = telemetry.attribution_summary()
    tot = summary.get("totals", {})
    fams = summary.get("families", {})
    cm = telemetry.cost_model

    out = [f"<!doctype html><html><head><meta charset='utf-8'>"
           f"<title>{html.escape(title)}</title>"
           f"<style>{_CSS}</style></head><body>"
           f"<h1>{html.escape(title)}</h1>"]
    if cm is not None:
        out.append(f"<p class='kv'>cost model: {html.escape(cm.hw_name)} "
                   f"@ {html.escape(cm.dtype)} — peak "
                   f"{cm.peak_flops / 1e12:.1f} TFLOP/s, HBM "
                   f"{cm.hbm_bw / 1e9:.0f} GB/s (built at warmup; "
                   f"frozen since)</p>")

    out.append("<h2>Attribution waterfall (drain totals)</h2>")
    wall = tot.get("wall_s", 0.0)
    out.append(_bar([("sched", "sched", tot.get("sched_s", 0.0)),
                     ("device", "device", tot.get("device_s", 0.0)),
                     ("draft", "draft", tot.get("draft_s", 0.0)),
                     ("host", "host", tot.get("host_s", 0.0))], wall))
    dev = tot.get("device_s", 0.0)
    waste = min(tot.get("padding_waste_s", 0.0), dev)
    out.append("<p class='kv'>device time split: useful vs padding "
               "waste (padded grid positions priced at the family's "
               "roofline per-token cost)</p>")
    out.append(_bar([("useful", "useful", dev - waste),
                     ("waste", "padding waste", waste)], dev))
    rows = [("steps", f"{tot.get('steps', 0)}"),
            ("wall_s", f"{wall:.4f}"),
            ("real tokens", f"{tot.get('real_tokens', 0)}"),
            ("padded tokens", f"{tot.get('padded_tokens', 0)}")]
    for key in ("mfu", "mbu", "padding_waste_ratio",
                "achieved_tokens_per_s", "roofline_tokens_per_s",
                "goodput_ratio"):
        if key in summary:
            v = summary[key]
            rows.append((key, f"{v:.6g}"))
    rows.append(("goodput tokens",
                 f"{summary.get('goodput_tokens', 0)}"
                 f" / {summary.get('tokens_out', 0)}"))
    out.append("<table><tr><th>metric</th><th>value</th></tr>")
    for k, v in rows:
        out.append(f"<tr><td>{html.escape(k)}</td>"
                   f"<td>{html.escape(v)}</td></tr>")
    out.append("</table>")

    out.append("<h2>Per-family predicted vs measured</h2>")
    out.append("<table><tr><th>family</th><th>steps</th><th>fill</th>"
               "<th>device s</th><th>predicted s</th><th>pred/meas</th>"
               "<th>waste s</th><th>roof</th><th>KV gather MB/step</th>"
               "</tr>")
    for label in sorted(fams):
        f = fams[label]
        fc = cm.get(label) if cm is not None else None
        roof = html.escape(fc.bottleneck) if fc is not None else "-"
        gather = (f"{fc.kv_gather_bytes / 2 ** 20:.2f}"
                  if fc is not None else "-")
        out.append(
            f"<tr><td>{html.escape(label)}</td><td>{f['steps']}</td>"
            f"<td>{f['fill']:.3f}</td><td>{f['device_s']:.4f}</td>"
            f"<td>{f['predicted_s']:.6f}</td>"
            f"<td>{f['predicted_vs_measured']:.3g}</td>"
            f"<td>{f['padding_waste_s']:.6f}</td>"
            f"<td>{roof}</td><td>{gather}</td></tr>")
    out.append("</table>")

    out.append("<h2>Latency percentiles (s)</h2>")
    out.append("<table><tr><th>metric</th><th>count</th><th>p50</th>"
               "<th>p95</th><th>p99</th><th>max</th></tr>")
    for name, snap in telemetry.latency_summary().items():
        out.append(f"<tr><td>{html.escape(name)}</td>"
                   f"<td>{snap['count']}</td><td>{snap['p50']:.4f}</td>"
                   f"<td>{snap['p95']:.4f}</td><td>{snap['p99']:.4f}</td>"
                   f"<td>{snap['max']:.4f}</td></tr>")
    out.append("</table>")

    out.append("<h2>Alerts</h2>")
    alerts = list(telemetry.alerts)
    if not alerts:
        out.append("<p class='kv'>none</p>")
    else:
        out.append("<table><tr><th>kind</th><th>severity</th><th>step</th>"
                   "<th>value</th><th>threshold</th><th>message</th></tr>")
        for a in alerts:
            out.append(
                f"<tr><td>{html.escape(a.kind)}</td>"
                f"<td class='{html.escape(a.severity)}'>"
                f"{html.escape(a.severity)}</td><td>{a.step}</td>"
                f"<td>{a.value:.4g}</td><td>{a.threshold:.4g}</td>"
                f"<td style='text-align:left'>{html.escape(a.message)}"
                f"</td></tr>")
        out.append("</table>")
    out.append("</body></html>")
    return "".join(out)


def write_report(telemetry, path, *, title: str = "serving report") -> dict:
    """Write the HTML report to ``path`` (an ``.html`` suffix is kept,
    anything else gets one) and the Prometheus text next to it with a
    ``.prom`` suffix.  Returns ``{"html": ..., "prom": ...}`` paths."""
    import os

    path = os.fspath(path)
    base = path[:-5] if path.endswith(".html") else path
    html_path, prom_path = base + ".html", base + ".prom"
    with open(html_path, "w") as f:
        f.write(html_report(telemetry, title=title))
    with open(prom_path, "w") as f:
        f.write(prometheus_text(telemetry))
    return {"html": html_path, "prom": prom_path}
