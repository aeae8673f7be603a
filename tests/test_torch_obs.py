"""The port's serving telemetry (``repro_torch.obs``) against the JAX
package's (``repro.obs``), on the CPU.

Mirrors ``tests/test_obs.py`` on a reduced SmolLM2 (2 layers, f32, the
reference's weights carried across, prompts from a numpy seed):

- streaming histograms (percentiles against numpy within the geometric
  bucket bound, and snapshot for snapshot equal to the reference's),
  edge cases, the registry's reset scopes;
- ``NullTelemetry`` is inert and has every hook the reference's has;
- the trace recorder's schema and bound;
- the observer contract: telemetry on and off give identical tokens in
  the flat, dense chunked and monolithic families, greedy and sampled,
  and a warmed engine with telemetry on adds no step signature;
- parity: the same requests through a JAX engine and a port engine, both
  with telemetry on — an ample pool, undersized pools (preemption,
  pauses, reclaims), the prefix cache, n-gram speculation and a fault
  plan of ``scripts/chaos_smoke.py`` — give each request the same
  ``obs_events`` labels in order, equal counters (those no clock drives),
  equal histogram counts and gauges, the same Prometheus series (both
  lint clean) and schema-valid traces carrying the fault instants;
- ``Engine.telemetry()``'s percentiles and its explicit reset.
"""

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models.model import build_model as jbuild_model
from repro.obs import export as jexport
from repro.obs import metrics as jmetrics
from repro.obs import telemetry as jtelemetry
from repro.serving import faults as jfaults
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.models.model import build_model
from repro_torch.obs import (NULL, Histogram, MetricsRegistry, NullTelemetry,
                             Telemetry, TraceRecorder, lint_prometheus,
                             prometheus_text)
from repro_torch.serving import faults
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 3, "decode")
FAMILIES = {"flat": dict(chunk_tokens=16, token_budget=24),
            "dense": dict(chunk_tokens=16, flat=False),
            "monolithic": {}}
LENS, NEWS = [13, 21, 3, 16], [8, 6, 10, 7]


@pytest.fixture(scope="module")
def models():
    jm = jbuild_model(jreduced(jget_config("smollm2-135m"), layers=2), JRun(**F32),
                      JShape(*SHAPE))
    jparams = jm.init(jax.random.PRNGKey(0))
    m = build_model(reduced_config(get_config("smollm2-135m"), layers=2),
                    RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    return jm, jparams, m, from_jax_params(jax.tree.map(np.asarray, jparams))


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _drain(eng, prompts, news, *, plan=None, **kw):
    rids = [eng.add_request(p, n) for p, n in zip(prompts, news)]
    if plan is not None:
        with plan.on(eng):
            fin = {r.rid: r for r in eng.drain(**kw)}
    else:
        fin = {r.rid: r for r in eng.drain(**kw)}
    assert sorted(fin) == sorted(rids)
    return [fin[rid] for rid in rids]


# ---------------------------------------------------------------------------
# streaming histograms and registry scopes
# ---------------------------------------------------------------------------

def test_histogram_percentiles_match_numpy_and_reference():
    """Geometric buckets at factor 2**0.25 bound the relative error by
    ~19%; count/mean/min/max are exact, and every field equals the
    reference histogram's on the same observations."""
    rng = np.random.default_rng(0)
    xs = rng.lognormal(mean=-4.0, sigma=1.0, size=5000)
    h, jh = Histogram("lat"), jmetrics.Histogram("lat")
    for x in xs:
        h.observe(float(x))
        jh.observe(float(x))
    snap = h.snapshot()
    assert snap == jh.snapshot()
    assert snap["count"] == len(xs)
    assert snap["mean"] == pytest.approx(xs.mean())
    assert snap["min"] == pytest.approx(xs.min())
    assert snap["max"] == pytest.approx(xs.max())
    for q, key in [(0.50, "p50"), (0.95, "p95"), (0.99, "p99")]:
        want = float(np.quantile(xs, q))
        assert abs(snap[key] - want) / want < 0.19, (key, snap[key], want)
    assert abs(snap["p50"] / float(np.quantile(xs, 0.5)) - 1) < 0.05
    assert snap["p50"] <= snap["p95"] <= snap["p99"] <= snap["max"]


def test_histogram_edge_cases():
    h = Histogram("x")
    assert h.snapshot()["count"] == 0 and h.percentile(0.5) == 0.0
    h.observe(-1.0)                            # clamped, not dropped
    h.observe(0.0)
    h.observe(1e9)                             # beyond hi: overflow bucket
    s = h.snapshot()
    assert s["count"] == 3 and s["min"] == 0.0 and s["max"] == 1e9
    assert s["p99"] <= s["max"]
    one = Histogram("y")
    one.observe(0.25)                          # one sample: exact
    assert one.snapshot()["p50"] == one.snapshot()["p99"] == 0.25
    h.reset()
    assert h.snapshot() == Histogram("x").snapshot()


def test_registry_reset_scopes():
    r = MetricsRegistry()
    per_drain = r.counter("tokens_out")
    forever = r.counter("requests_total", scope="lifetime")
    g = r.gauge("queue_depth")
    h = r.histogram("ttft_s")
    per_drain.inc(7)
    forever.inc(3)
    g.set(5)
    h.observe(0.25)
    r.reset("drain")
    snap = r.snapshot()
    assert snap["tokens_out"] == 0
    assert snap["requests_total"] == 3
    assert snap["queue_depth"] == 5
    assert snap["ttft_s"]["count"] == 0
    assert snap["_scope"]["tokens_out"] == "drain"
    assert snap["_scope"]["requests_total"] == "lifetime"
    r.reset("lifetime")
    assert r.snapshot()["requests_total"] == 0
    with pytest.raises(AssertionError):
        r.counter("tokens_out", scope="lifetime")
    with pytest.raises(AssertionError):
        r.gauge("tokens_out")


def _hooks(cls):
    return {n for n in dir(cls) if not n.startswith("_")}


def test_null_telemetry_is_inert_and_has_every_reference_hook():
    """The default recorder reads no clock and touches nothing; the port's
    NullTelemetry and Telemetry carry exactly the reference's hooks."""
    assert _hooks(NullTelemetry) == _hooks(jtelemetry.NullTelemetry)
    assert _hooks(Telemetry) == _hooks(jtelemetry.Telemetry)
    assert not NULL.enabled
    assert NULL.registry is None and NULL.tracer is None
    assert NULL.cost_model is None and NULL.monitors is None
    assert NULL.clock() == 0.0
    NULL.step_begin()
    NULL.device_span(0.0)
    NULL.step_family("flat[1,8]/k1", 1, 8)
    NULL.step_end(None, None, [])              # no attribute access at all
    assert NULL.attribution_summary() == {}
    assert isinstance(Telemetry(), NullTelemetry)

    reads = []
    live = Telemetry(clock=lambda: reads.append(1) or float(len(reads)))
    live.step_begin()
    assert reads, "the live recorder reads its clock"


def test_trace_recorder_schema_and_bounds(tmp_path):
    clk = iter(x * 1e-3 for x in range(100))
    rec = TraceRecorder(clock=lambda: next(clk), max_events=6)
    rec.complete("slot 0", "prefill", 0.001, 0.003, {"tokens": 16})
    rec.async_begin("scheduler", "queue", 7)
    rec.async_end("scheduler", "queue", 7)
    rec.instant("pool", "cow")
    rec.counter("pool", "pages", {"used": 3, "free": 5})
    assert rec.dropped >= 1                    # 3 M-records + 5 events > 6
    assert len(rec.events()) == 6
    doc = rec.to_json()
    phs = [e["ph"] for e in doc["traceEvents"]]
    assert phs == sorted(phs, key=lambda p: p != "M")   # metadata first
    ts = [e["ts"] for e in doc["traceEvents"] if "ts" in e]
    assert ts == sorted(ts)
    rec.export(tmp_path / "t.json")
    assert json.loads((tmp_path / "t.json").read_text()) == doc


# ---------------------------------------------------------------------------
# the observer contract: on == off, no new signature
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_telemetry_token_identity_and_no_new_trace(models, family):
    _, _, m, params = models
    prompts = _prompts(LENS)
    for greedy, seed in [(True, 0), (False, 7)]:
        plain = Engine(m, params, device="cpu", max_slots=3, page_tokens=8,
                       **FAMILIES[family])
        want = [r.out_tokens for r in _drain(plain, prompts, NEWS,
                                             greedy=greedy, seed=seed)]
        obs = Engine(m, params, device="cpu", max_slots=3, page_tokens=8,
                     telemetry=True, **FAMILIES[family])
        obs.warmup()
        before = dict(m.trace_counts)
        got = [r.out_tokens for r in _drain(obs, prompts, NEWS,
                                            greedy=greedy, seed=seed)]
        assert got == want, (family, greedy)
        assert dict(m.trace_counts) == before
        assert obs.obs.enabled and obs.obs.tracer.events()
        assert not any(obs.stats()["captures"].values())


# ---------------------------------------------------------------------------
# parity with the JAX engine
# ---------------------------------------------------------------------------

def _validate_trace(doc):
    """Chrome trace_event schema checks; returns the event list."""
    assert set(doc) == {"traceEvents", "displayTimeUnit"}
    evs = doc["traceEvents"]
    by_track, open_async = {}, {}
    for e in evs:
        assert e["pid"] == 1 and isinstance(e["tid"], int)
        if e["ph"] == "M":
            assert e["name"] == "thread_name" and e["args"]["name"]
            continue
        assert isinstance(e["ts"], int) and e["ts"] >= 0
        by_track.setdefault(e["tid"], []).append(e["ts"])
        if e["ph"] == "X":
            assert e["dur"] >= 0
        elif e["ph"] in ("b", "e"):
            key = (e["cat"], e["id"])
            if e["ph"] == "b":
                open_async[key] = open_async.get(key, 0) + 1
            else:
                assert open_async.get(key, 0) > 0, f"orphan end {key}"
                open_async[key] -= 1
        elif e["ph"] == "i":
            assert e["s"] == "t"
        elif e["ph"] == "C":
            assert all(isinstance(v, (int, float)) for v in e["args"].values())
        else:
            raise AssertionError(f"unexpected phase {e['ph']!r}")
    for tid, ts in by_track.items():
        assert ts == sorted(ts), f"track {tid} not monotone"
    assert all(v == 0 for v in open_async.values()), open_async
    return evs


def _pressure_prompts():
    p = _prompts([4, 25, 6, 30, 4, 5], seed=3)
    return p + [p[1].copy()], [16, 10, 16, 8, 16, 16, 10]


def _long_prompts():
    """Long prompts for a pool of 7 pages: prefills pause, and paused
    requests' pages are reclaimed."""
    return _prompts([30, 40, 25, 35, 20], seed=0), [12, 8, 14, 6, 10]


def _motif_prompts():
    rng = np.random.default_rng(9)
    return ([np.tile(rng.integers(0, 512, 4).astype(np.int32), 4),
             np.tile(rng.integers(0, 512, 3).astype(np.int32), 5),
             rng.integers(0, 512, 7).astype(np.int32)], [10, 9, 8])


def _chaos_prompts():
    """The chaos trace of tests/test_torch_resilience.py: the fourth
    request repeats the first one's 16-token prompt and restarts inside
    its last cached page, which is copied first."""
    p = _prompts([16, 11, 8])
    return p + [p[0].copy()], [6, 4, 9, 7]


# name -> (engine kwargs, requests, fault events of the run or None)
PARITY = {
    "ample-flat": (dict(chunk_tokens=8), lambda: (_prompts(LENS), NEWS), None),
    "ample-monolithic": ({}, lambda: (_prompts(LENS), NEWS), None),
    "tight-dense": (dict(chunk_tokens=8, flat=False, num_pages=1 + 7),
                    _long_prompts, None),
    "tight-flat-cache": (dict(chunk_tokens=8, num_pages=1 + 8, prefix_cache=True),
                         _pressure_prompts, None),
    "spec-ngram-flat": (dict(chunk_tokens=8, spec_tokens=2), _motif_prompts, None),
    "chaos-nan-logits": (dict(chunk_tokens=8, spec_tokens=3, prefix_cache=True),
                         _chaos_prompts, [(3, "nan")]),
}
_CLOCKED = {"alerts_emitted"}             # counters a clock drives


def _series(text):
    """(name, labels) of every sample but the timing-driven step-outlier
    alert count."""
    out = set()
    for line in text.splitlines():
        if line.startswith("#") or not line.strip():
            continue
        key = line.rsplit(" ", 1)[0]
        if 'kind="step-outlier"' not in key:
            out.add(key)
    return out


@pytest.mark.parametrize("config", sorted(PARITY))
def test_telemetry_matches_jax_engine(models, config):
    jm, jparams, m, params = models
    kwargs, reqs, events = PARITY[config]
    prompts, news = reqs()
    kw = dict(max_slots=3, page_tokens=8, telemetry=True, **kwargs)
    eng, jeng = Engine(m, params, device="cpu", **kw), JEngine(jm, jparams, **kw)
    eng.warmup()
    jeng.warmup()
    plan = None if events is None else faults.FaultPlan(
        [faults.FaultEvent(s, k) for s, k in events])
    jplan = None if events is None else jfaults.FaultPlan(
        [jfaults.FaultEvent(s, k) for s, k in events])
    fin = _drain(eng, prompts, news, plan=plan)
    jfin = _drain(jeng, prompts, news, plan=jplan)

    # every request's lifecycle marks, in order
    for r, jr in zip(fin, jfin):
        assert [e[0] for e in r.obs_events] == [e[0] for e in jr.obs_events], r.rid
        assert r.out_tokens == jr.out_tokens and r.finish_reason == jr.finish_reason
    # the registry: counters and gauges equal, histograms equally fed
    snap, jsnap = eng.obs.registry.snapshot(), jeng.obs.registry.snapshot()
    assert snap["_scope"] == jsnap["_scope"]
    for name, v in snap.items():
        if name == "_scope" or name in _CLOCKED:
            continue
        if isinstance(v, dict):
            assert v["count"] == jsnap[name]["count"], name
        else:
            assert v == jsnap[name], name
    assert snap["steps"] > 0
    # the exposition: the same series, both clean
    text, jtext = prometheus_text(eng.obs), jexport.prometheus_text(jeng.obs)
    for t in (text, jtext):
        assert lint_prometheus(t) == [] and jexport.lint_prometheus(t) == []
    assert _series(text) == _series(jtext)
    fams = eng.obs.attribution_summary()["families"]
    jfams = jeng.obs.attribution_summary()["families"]
    assert set(fams) == set(jfams)
    for label, f in fams.items():
        for key in ("steps", "real_tokens", "padded_tokens"):
            assert f[key] == jfams[label][key], (label, key)
    # both traces are schema-valid and carry the same instants
    evs = _validate_trace(eng.obs.tracer.to_json())
    jevs = _validate_trace(jeng.obs.tracer.to_json())
    names = sorted(e["name"] for e in evs if e["ph"] == "i"
                   and not e["name"].startswith("alert:"))
    assert names == sorted(e["name"] for e in jevs if e["ph"] == "i"
                           and not e["name"].startswith("alert:"))
    if config.startswith("tight"):
        assert snap["preemptions"] >= 1, "no pool pressure"
    if config == "tight-dense":
        assert snap["pauses"] >= 1 and snap["reclaims"] >= 1
    if "cache" in config:
        assert snap["prefix_hits"] >= 1
    if config.startswith("chaos"):
        assert snap["cow_copies"] >= 1
    if "spec" in config:
        assert snap["draft_tokens"] > 0 and snap["step_draft_s"]["count"] > 0
    if events is not None:
        assert plan.fired == jplan.fired and snap["faults_injected"] > 0
        assert {"fault:nan", "quarantine"} <= set(names)


def test_trace_export_covers_lifecycle_under_pressure(models, tmp_path):
    """A pool at about half the working set, the prefix cache and a
    repeated prompt: the exported trace is schema-valid and holds queue,
    prefill and decode spans, a preempt and a prefix_hit instant."""
    _, _, m, params = models
    prompts, news = _pressure_prompts()
    eng = Engine(m, params, device="cpu", max_slots=3, page_tokens=8,
                 num_pages=1 + 8, chunk_tokens=8, prefix_cache=True,
                 telemetry=True)
    fin = _drain(eng, prompts, news)
    assert eng.num_preemptions >= 1 and eng.stats()["prefix_cache"]["hits"] >= 1
    path = tmp_path / "drain.trace.json"
    eng.obs.export_trace(path)
    evs = _validate_trace(json.loads(path.read_text()))
    names = {e["name"] for e in evs}
    tracks = {e["args"]["name"] for e in evs if e["ph"] == "M"}
    assert {"engine", "scheduler", "pool"} <= tracks
    assert any(t.startswith("slot ") for t in tracks)
    queues = [e for e in evs if e["ph"] == "b" and e["name"] == "queue"]
    assert {e["id"] for e in queues} >= {r.rid for r in fin}
    for span in ("prefill", "decode", "step", "device"):
        assert span in names, span
    instants = {e["name"] for e in evs if e["ph"] == "i"}
    assert {"preempt", "prefix_hit"} <= instants
    assert {e["name"] for e in evs if e["ph"] == "C"} >= {"pages", "load"}
    marks = [ev[0] for ev in fin[0].obs_events]
    assert marks[0] == "queued" and marks[-1] == "finished"
    assert "prefill_chunk" in marks and "prefill_done" in marks


def test_chaos_drain_lands_fault_events_in_trace(models):
    """A NaN fault and a bounded queue: the quarantine and the sheds show
    as registry counters and as trace instants; survivors finish."""
    _, _, m, params = models
    eng = Engine(m, params, device="cpu", max_slots=2, chunk_tokens=8,
                 queue_limit=2, telemetry=True)
    plan = faults.FaultPlan([faults.FaultEvent(1, "nan")])
    fin = _drain(eng, _prompts([4] * 6, seed=5), [3] * 6, plan=plan)
    assert plan.fired["nan"] == 1
    reasons = [r.finish_reason for r in fin]
    assert reasons.count("rejected") == 4 and reasons.count("error") == 1
    snap = eng.obs.registry.snapshot()
    assert snap["quarantines"] == 1 and snap["sheds"] == 4
    assert snap["faults_injected"] == 1
    evs = _validate_trace(eng.obs.tracer.to_json())
    assert {"fault:nan", "quarantine", "shed"} <= {e["name"] for e in evs
                                                 if e["ph"] == "i"}


# ---------------------------------------------------------------------------
# Engine.telemetry(): percentiles and the explicit reset
# ---------------------------------------------------------------------------

def test_engine_telemetry_percentiles_and_reset(models):
    _, _, m, params = models
    prompts = _prompts(LENS)
    eng = Engine(m, params, device="cpu", max_slots=3, page_tokens=8,
                 telemetry=True, **FAMILIES["flat"])
    _drain(eng, prompts, NEWS)
    tel = eng.telemetry(reset=True)
    assert tel["enabled"]
    lat = tel["latency"]
    assert lat["ttft_s"]["count"] == lat["e2e_s"]["count"] == len(prompts)
    assert lat["itl_s"]["count"] > 0
    for series in ("ttft_s", "itl_s", "queue_wait_s", "e2e_s"):
        s = lat[series]
        assert 0 <= s["p50"] <= s["p95"] <= s["p99"] <= s["max"]
    met = tel["metrics"]
    assert met["requests_finished"] == len(prompts)
    assert met["tokens_out"] == sum(NEWS)
    assert met["step_wall_s"]["count"] == met["steps"] > 0
    assert met["step_device_s"]["count"] == met["steps"]
    assert tel["components"]["slo"]["tokens_out"] == sum(NEWS)

    after = eng.telemetry()
    assert after["metrics"]["tokens_out"] == 0
    assert after["latency"]["ttft_s"]["count"] == 0
    _drain(eng, prompts, NEWS)
    again = eng.telemetry()
    assert again["metrics"]["requests_finished"] == len(prompts)


def test_telemetry_disabled_reports_so(models):
    _, _, m, params = models
    eng = Engine(m, params, device="cpu", max_slots=2, chunk_tokens=8)
    assert eng.obs is NULL and eng.pool.obs is NULL
    tel = eng.telemetry()
    assert not tel["enabled"]
    assert tel["metrics"] == {} and tel["latency"] == {}
    assert tel["attribution"] == {} and tel["alerts"] == []
    assert tel["components"]["finished"] == 0
    assert "slo" not in eng.stats()
    with pytest.raises(ValueError):
        eng.telemetry(report="unused")
    live = Telemetry(trace=False)
    assert Engine(m, params, device="cpu", max_slots=2, chunk_tokens=8,
                  telemetry=live).obs is live
