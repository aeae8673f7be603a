"""The port's performance attribution (``repro_torch.obs.attrib``,
``monitors``, ``export``) against the JAX package's, on the CPU.

Mirrors ``tests/test_attrib.py`` on a reduced SmolLM2 (2 layers, the
reference's weights carried across, prompts from a numpy seed):

- attribution completeness: every step record's ``sched + device + draft
  + host`` sums back to its wall, and so do the drain totals, in each
  engine grid of the reference's test and in the monolithic family;
- ``summarize`` equals the incremental aggregation, which survives the
  record window's eviction;
- the cost model, port against reference: the same family labels and
  widths, equal FLOPs (relative 1e-9), KV-gather bytes, FLOPs per token,
  peak rate and bandwidth, in every family, f32 and bf16, speculation on
  and off; the port's own HBM bytes equal a hand count; it is built only
  at warmup with telemetry on, and moves no ``trace_counts``;
- the monitors' rules, the per-family step outlier and slo-burn firing
  once per excursion;
- Prometheus text lint and counter monotonicity across scrapes, the HTML
  report and ``write_report``'s pair of files;
- goodput counts only tokens inside the deadline;
- the reference's AST invariant lint over the port's obs modules.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.core import presets as jpresets
from repro.models.model import build_model as jbuild_model
from repro.obs.attrib import build_cost_model as jbuild_cost_model
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.core.hardware import presets
from repro_torch.models.model import build_model
from repro_torch.models.transformer import tree_map
from repro_torch.obs.attrib import (StepCostModel, build_cost_model,
                                    fresh_totals, summarize, update_aggregates)
from repro_torch.obs.export import (html_report, lint_prometheus,
                                    prometheus_text)
from repro_torch.obs.monitors import Monitors
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

SHAPE = ("serve", 64, 3, "decode")
LENS, NEWS = [13, 21, 3, 16], [8, 6, 10, 7]
# the reference test's grids: dense chunked, flat, flat with an n-gram
# drafter; and the monolithic family
GRIDS = {"chunked": dict(chunk_tokens=16, flat=False),
         "flat": dict(chunk_tokens=16, token_budget=24),
         "flat-spec": dict(chunk_tokens=16, token_budget=24, spec_tokens=2),
         "monolithic": {}}
FLAT = GRIDS["flat"]


def _run(dtype):
    return dict(param_dtype=dtype, compute_dtype=dtype, remat=False)


def _pair(dtype, policy="scalable", hw="tpu_v5e", arch="smollm2-135m"):
    run = dict(_run(dtype), layout_policy=policy)
    jm = jbuild_model(jreduced(jget_config(arch), layers=2),
                      JRun(**run), JShape(*SHAPE), hw=jpresets[hw])
    jparams = jm.init(jax.random.PRNGKey(0))
    m = build_model(reduced_config(get_config(arch), layers=2),
                    RunConfig(**run), ShapeSpec(*SHAPE), hw=presets[hw],
                    device="cpu")
    # numpy has no bfloat16: carry the weights across in f32, then cast
    params = tree_map(lambda t: t.to(m.compute_dtype), from_jax_params(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)))
    return jm, jparams, m, params


@pytest.fixture(scope="module")
def models():
    return _pair("float32")


@pytest.fixture(scope="module")
def models_bf16():
    return _pair("bfloat16")


def _prompts(lens=LENS, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _drain(eng, prompts=None, news=NEWS, **kw):
    prompts = _prompts() if prompts is None else prompts
    rids = [eng.add_request(p, n) for p, n in zip(prompts, news)]
    fin = {r.rid: r for r in eng.drain(**kw)}
    assert sorted(fin) == sorted(rids)
    return [fin[rid] for rid in rids]


def _engine(models, **kw):
    _, _, m, params = models
    return Engine(m, params, device="cpu", max_slots=3, page_tokens=8, **kw)


# ---------------------------------------------------------------------------
# attribution completeness: components sum to wall
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_attribution_components_sum_to_wall(models, grid):
    """Every step record's four components reconstruct its measured wall
    (host is the remainder, so the tolerance only covers float rounding),
    and the drain totals inherit the identity."""
    eng = _engine(models, telemetry=True, **GRIDS[grid])
    eng.warmup()
    _drain(eng)
    recs = list(eng.obs.step_records)
    assert recs
    for rec in recs:
        parts = rec["sched"] + rec["device"] + rec["draft"] + rec["host"]
        assert abs(parts - rec["wall"]) <= 1e-9 + 1e-6 * rec["wall"], rec
        assert rec["sched"] >= 0 and rec["host"] >= 0
        assert rec["families"], "every moving step is family-tagged"
        assert all(label in eng.cost_model.families
                   for label, *_ in rec["families"])
    tot = eng.obs.attribution_summary()["totals"]
    comp = tot["sched_s"] + tot["device_s"] + tot["draft_s"] + tot["host_s"]
    assert comp == pytest.approx(tot["wall_s"], rel=1e-6)
    assert tot["steps"] == len(recs)
    if "spec_tokens" in GRIDS[grid]:
        assert tot["draft_s"] > 0
    if grid == "monolithic":
        # each prefill is tagged once, as a prefill, beside the decode
        labels = [label for rec in recs for label, *_ in rec["families"]]
        assert sum(label.startswith("prefill[") for label in labels) == len(LENS)
        assert any(label.startswith("decode[") for label in labels)


def test_summarize_matches_incremental_aggregation(models):
    eng = _engine(models, telemetry=True, **FLAT)
    eng.warmup()
    _drain(eng)
    live = eng.obs.attribution_summary()
    redo = summarize(list(eng.obs.step_records), eng.cost_model,
                     goodput_tokens=live["goodput_tokens"],
                     tokens_out=live["tokens_out"])
    assert redo["totals"] == pytest.approx(live["totals"])
    assert set(redo["families"]) == set(live["families"])
    for label, f in redo["families"].items():
        assert f == pytest.approx(live["families"][label])
    for key in ("mfu", "mbu", "padding_waste_ratio", "goodput_ratio",
                "roofline_fraction"):
        assert redo[key] == pytest.approx(live[key])
    assert 0 < live["mfu"] < 1 and 0 < live["mbu"]
    assert 0 <= live["padding_waste_ratio"]
    assert live["goodput_ratio"] == 1.0


def test_update_aggregates_survives_window_eviction():
    recs = [{"wall": 0.5 + i * 0.01, "sched": 0.1, "device": 0.3,
             "draft": 0.0, "host": 0.1 + i * 0.01,
             "families": (("decode[3,1]", 2 + (i % 2), 3, 0.3),)}
            for i in range(10)]
    tot, fams = fresh_totals(), {}
    for rec in recs:
        update_aggregates(tot, fams, rec, None)
    assert tot["steps"] == 10
    assert tot["wall_s"] == pytest.approx(sum(r["wall"] for r in recs))
    assert tot["real_tokens"] == sum(r["families"][0][1] for r in recs)
    assert fams["decode[3,1]"]["padded_tokens"] == 30
    assert fams["decode[3,1]"]["predicted_s"] == 0.0
    # a window of 4 records drops the rest; the aggregates keep all ten
    window = recs[-4:]
    assert summarize(window, None)["totals"]["steps"] == 4
    assert summarize(recs, None)["totals"] == pytest.approx(tot)


# ---------------------------------------------------------------------------
# the cost model, port against reference
# ---------------------------------------------------------------------------

COST_GRIDS = {"flat": dict(chunk_tokens=16, token_budget=24),
              "chunked": dict(chunk_tokens=16, flat=False),
              "monolithic": {}}


# today's case (scalable tiles of tpu_v5e) in both dtypes, every grid, with
# and without speculation; the layouts of the other vector lengths and
# policies in float32 (the reference prices the same graphs in bfloat16);
# and two other dense configs in float32: Qwen2-7B (QKV bias) and Qwen3-8B
# (qk_norm, an untied head), reduced
COST_LAYOUTS = [("scalable", "tpu_vl512"), ("fixed", "tpu_vl512"),
                ("unpacked", "tpu_v5e")]
COST_ARCHS = ["qwen2-7b", "qwen3-8b"]
# reduced RWKV-6 (2 layers), served by the monolithic family only
COST_RECURRENT = ["rwkv6-1.6b"]
# the moe family, reduced (2 layers): the capacity-padded expert products
# and the router; arctic with its parallel dense branch
COST_MOE = ["qwen3-moe-235b-a22b", "arctic-480b"]
COST_CASES = [pytest.param(dt, grid, spec, None,
                           id=f"{dt}-{grid}-{'plain' if spec is None else 'spec'}")
              for dt in ("float32", "bfloat16") for grid in sorted(COST_GRIDS)
              for spec in (None, 2)] + \
             [pytest.param("float32", grid, None, lay, id=f"float32-{grid}-plain-"
                           f"{lay[0]}-{lay[1]}")
              for lay in COST_LAYOUTS for grid in sorted(COST_GRIDS)] + \
             [pytest.param("float32", grid, None, ("scalable", "tpu_v5e", arch),
                           id=f"float32-{grid}-plain-{arch}")
              for arch in COST_ARCHS for grid in sorted(COST_GRIDS)] + \
             [pytest.param(dt, "monolithic", None, ("scalable", "tpu_v5e", arch),
                           id=f"{dt}-monolithic-plain-{arch}")
              for arch in COST_RECURRENT for dt in ("float32", "bfloat16")] + \
             [pytest.param("float32", grid, None, ("scalable", "tpu_v5e", arch),
                           id=f"float32-{grid}-plain-{arch}")
              for arch in COST_MOE for grid in sorted(COST_GRIDS)] + \
             [pytest.param("float32", "flat", None, ("unpacked", "tpu_v5e", arch),
                           id=f"float32-flat-plain-unpacked-{arch}")
              for arch in COST_MOE]


def _linears_missed_in_fusions(m, label: str) -> float:
    """FLOPs of the layer linears the reference's count misses in a
    one-token unpacked flat step: with no tile to pad M to, XLA fuses each
    [1, K] x [K, N] dot into a fusion, and the reference's HLO parser
    (``repro.roofline.hlo_cost.parse_hlo``) counts dots outside fusions
    only (ROADMAP C6).  2 * L * sum(K * N), unpadded at m_r = 1.  A moe
    layer's one-row dots are its router's [1, d] x [d, E] and arctic's
    dense branch (its expert products run over the capacity's 8 rows)."""
    cfg, lay = m.cfg, m.ctx.layout(m.compute_dtype)
    if lay.m_r != 1 or label != "flat[1,1]/k1":
        return 0.0
    d, dh = cfg.d_model, cfg.d_head
    attn = [(d, cfg.n_heads * dh), (d, cfg.n_kv_heads * dh),
            (d, cfg.n_kv_heads * dh), (cfg.n_heads * dh, d)]
    mlp = [(d, cfg.d_ff), (cfg.d_ff, d)] + ([(d, cfg.d_ff)] if cfg.glu else [])
    total = 0
    for i in range(cfg.n_layers):
        mats = attn
        if not cfg.moe_on_layer(i):
            mats = mats + mlp
        else:
            mats = mats + [(d, cfg.n_experts)] + (mlp if cfg.dense_residual else [])
        total += sum(k * n for k, n in mats)
    return 2.0 * total


def _recurrent_work_not_dots(m, label: str) -> float:
    """FLOPs the port counts for a recurrent layer that the reference's
    dot count cannot see (ROADMAP C8): RWKV-6's state update (2 H dh^2 a
    token: w S + k v is no dot; its read-out einsum is one) and mamba's
    scan update (2 di N), over the step's tokens.  Mamba's convolution
    is elementwise and counted by neither (ROADMAP C12)."""
    cfg = m.cfg
    b, s = (int(x) for x in label[label.index("[") + 1:label.index("]")].split(","))
    per = 0
    for t in cfg.layer_types:
        if t == "rwkv":
            per += 2 * (cfg.d_model // cfg.rwkv_head_dim) * cfg.rwkv_head_dim ** 2
        elif t == "mamba":
            di = cfg.mamba_expand * cfg.d_model
            per += 2 * di * cfg.mamba_d_state
    return float(b * s * per)


@pytest.mark.parametrize("dtype,grid,spec,layout", COST_CASES)
def test_cost_model_matches_reference(models, models_bf16, dtype, grid, spec,
                                      layout):
    if layout is None:
        jm, jparams, m, params = models if dtype == "float32" else models_bf16
    else:
        jm, jparams, m, params = _pair(dtype, *layout)
    kw = dict(max_slots=3, page_tokens=8, spec_tokens=spec, **COST_GRIDS[grid])
    eng = Engine(m, params, device="cpu", **kw)
    before = dict(m.trace_counts)
    cm, jcm = build_cost_model(eng), jbuild_cost_model(JEngine(jm, jparams, **kw))
    assert dict(m.trace_counts) == before
    assert not any(eng.stats()["captures"].values())
    assert list(cm.families) == list(jcm.families)
    for label, fc in cm.families.items():
        jfc = jcm.families[label]
        assert fc.width == jfc.width, label
        assert fc.flops == pytest.approx(
            jfc.flops + _linears_missed_in_fusions(m, label)
            + _recurrent_work_not_dots(m, label), rel=1e-9), label
        assert fc.kv_gather_bytes == jfc.kv_gather_bytes, label
        assert fc.predicted_s == max(fc.compute_s, fc.memory_s) > 0
        assert fc.per_token_s == pytest.approx(fc.predicted_s / max(1, fc.width))
    assert cm.flops_per_token == jcm.flops_per_token
    assert (cm.peak_flops, cm.hbm_bw, cm.hw_name, cm.dtype) == \
        (jcm.peak_flops, jcm.hbm_bw, jcm.hw_name, jcm.dtype)


def test_hbm_bytes_hand_count(models):
    """flat[1,16]/k1 of the reduced SmolLM2 (d 64, 4 query heads and 1 KV
    head of 16, d_ff 128, vocab 512, 2 layers) in f32, 3 slots, 8-token
    pages of a 64-token window, tiles (8, 128, 128)."""
    eng = _engine(models, **FLAT)
    fc = build_cost_model(eng).families["flat[1,16]/k1"]
    tile = 128 * 128                           # every linear pads to one tile
    weights = 4 * (2 * 7 * tile + 512 * 128)   # 7 linears x 2 layers + head
    kv_per_token = 2 * (2 * 1 * 16 * 4)        # 2 layers x (K + V) x 16 f32
    gather = 3 * 64 * kv_per_token             # every slot's whole window
    logits = 4 * 8 * 512                       # R = ru(3 slots x 1, 8) rows
    assert fc.kv_gather_bytes == gather
    assert fc.hbm_bytes == weights + gather + logits
    flops = 2 * 16 * 2 * 7 * tile + 2 * 8 * 512 * 128 + 4 * 16 * 4 * 16 * 64 * 2
    assert fc.flops == flops
    assert fc.memory_s == fc.hbm_bytes / 819e9


def test_cost_model_built_at_warmup_only(models):
    _, _, m, _ = models
    eng = _engine(models, telemetry=True, **FLAT)
    assert eng.cost_model is None
    eng.warmup()
    cm = eng.cost_model
    assert isinstance(cm, StepCostModel) and cm is eng.obs.cost_model
    assert cm.flops_per_token == 2.0 * m.cfg.param_counts()["active"]
    assert set(cm.families) == {"flat[1,24]/k1", "flat[1,16]/k1",
                                "flat[1,8]/k1"}
    plain = _engine(models, **FLAT)
    plain.warmup()
    assert plain.cost_model is None


def test_attribution_is_an_observer(models):
    """Telemetry on and off give the same tokens after warmup, and the
    on engine's warmup (cost model included) and drain move no
    ``trace_counts`` that the off engine's did not."""
    _, _, m, _ = models
    plain = _engine(models, **FLAT)
    plain.warmup()
    off = dict(m.trace_counts)
    want = [r.out_tokens for r in _drain(plain)]
    eng = _engine(models, telemetry=True, **FLAT)
    eng.warmup()
    assert dict(m.trace_counts) == off
    got = [r.out_tokens for r in _drain(eng)]
    assert got == want
    assert dict(m.trace_counts) == off


# ---------------------------------------------------------------------------
# exposition formats
# ---------------------------------------------------------------------------

def test_prometheus_text_lints_clean_and_counters_monotone(models):
    eng = _engine(models, telemetry=True, **FLAT)
    eng.warmup()
    _drain(eng)

    def scrape():
        text = prometheus_text(eng.obs)
        assert lint_prometheus(text) == [], lint_prometheus(text)
        vals = {}
        for line in text.splitlines():
            if line.startswith("#") or not line.strip():
                continue
            name, val = line.rsplit(" ", 1)
            vals[name] = float(val)
        return vals

    first = scrape()
    assert first["repro_tokens_out_total"] == sum(NEWS)
    assert any(k.startswith("repro_family_steps_total{family=") for k in first)
    assert 0 < first["repro_mfu"] < 1
    assert first["repro_goodput_ratio"] == 1.0
    _drain(eng)
    second = scrape()
    for name, v in first.items():
        if name.endswith("_total") or "_total{" in name:
            assert second.get(name, 0.0) >= v, f"counter {name} regressed"


def test_prometheus_lint_catches_format_violations():
    assert lint_prometheus("# TYPE x counter\nx_total 1\n") == []
    bad = [
        "# TYPE x counter\nx 1\n",
        "# TYPE x counter\nx_total -1\n",
        "x_total 1\n",
        "# TYPE x gauge\nx 1\nx 2\n",
        '# TYPE x gauge\nx{__bad="y"} 1\n',
        "# TYPE x gauge\nx notafloat\n",
    ]
    for text in bad:
        assert lint_prometheus(text), f"lint missed: {text!r}"


def test_html_report_schema_and_write(models, tmp_path):
    eng = _engine(models, telemetry=True, **FLAT)
    eng.warmup()
    _drain(eng)
    page = html_report(eng.obs, title="t&t")
    assert page.startswith("<!doctype html>")
    assert "t&amp;t" in page
    for marker in ("Attribution waterfall", "Per-family predicted vs",
                   "Latency percentiles", "Alerts", "class='bar'",
                   "cost model: tpu_v5e @ float32"):
        assert marker in page, marker
    assert "<script" not in page
    for label in eng.obs.attribution_summary()["families"]:
        assert label in page
    tel = eng.telemetry(report=tmp_path / "drain")
    paths = tel["report"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["drain.html",
                                                          "drain.prom"]
    assert Path(paths["html"]).read_text() == html_report(eng.obs)
    assert lint_prometheus(Path(paths["prom"]).read_text()) == []
    assert tel["attribution"]["totals"]["steps"] > 0


# ---------------------------------------------------------------------------
# anomaly monitors
# ---------------------------------------------------------------------------

def test_slo_burn_alert_fires_once_per_excursion(models):
    eng = _engine(models, telemetry=True, **FLAT)
    eng.obs.monitors.slo_itl_s = 1e-12         # every emission violates
    eng.warmup()
    _drain(eng)
    burns = [a for a in eng.obs.alerts if a.kind == "slo-burn"]
    assert len(burns) == 1, [a.message for a in eng.obs.alerts]
    assert burns[0].severity == "crit" and burns[0].value > burns[0].threshold
    assert "itl" in burns[0].message
    assert any(d["kind"] == "slo-burn" for d in eng.telemetry()["alerts"])
    assert eng.obs.registry.snapshot()["alerts_emitted"] >= 1


class _FakeSched:
    max_slots = 2
    num_preemptions = 0
    waiting: list = []


class _FakeTel:
    class registry:
        class _C:
            value = 0

        @classmethod
        def counter(cls, name):
            return cls._C()


def test_monitor_rules_standalone():
    mon = Monitors(window=4)
    sched, tel = _FakeSched(), _FakeTel()
    fired = []
    for i in range(6):
        sched.num_preemptions += 2
        sched.waiting = list(range(3 * (i + 1)))
        fired += mon.observe_step(t=float(i), scheduler=sched, telemetry=tel,
                                  families=[], device_s=0.0)
    kinds = [a.kind for a in fired]
    assert kinds.count("preempt-storm") == 1
    assert kinds.count("queue-growth") == 1
    sched.waiting = []
    for i in range(6):
        fired += mon.observe_step(t=10.0 + i, scheduler=sched, telemetry=tel,
                                  families=[], device_s=0.0)
    sched.num_preemptions += 20
    fired += mon.observe_step(t=20.0, scheduler=sched, telemetry=tel,
                              families=[], device_s=0.0)
    assert [a.kind for a in fired].count("preempt-storm") == 2


def test_step_outlier_detects_spike_per_family():
    mon = Monitors(outlier_min=8)
    sched, tel = _FakeSched(), _FakeTel()
    for i in range(10):
        mon.observe_step(t=float(i), scheduler=sched, telemetry=tel,
                         families=[("flat[1,16]/k1", 8, 16, 0.010)],
                         device_s=0.010)
    fired = mon.observe_step(t=11.0, scheduler=sched, telemetry=tel,
                             families=[("flat[1,16]/k1", 8, 16, 0.100)],
                             device_s=0.100)
    assert [a.kind for a in fired] == ["step-outlier"]
    assert "flat[1,16]/k1" in fired[0].message
    fired = mon.observe_step(t=12.0, scheduler=sched, telemetry=tel,
                             families=[("chunk[3,16]", 8, 48, 0.500)],
                             device_s=0.500)
    assert fired == []


# ---------------------------------------------------------------------------
# goodput
# ---------------------------------------------------------------------------

def _timed_drain(eng, dt=1.0):
    t, fin = 0.0, []
    while eng.scheduler.has_work or eng._finished_oob:
        t += dt
        fin.extend(eng.step(now=t))
    return fin


def test_goodput_counts_only_in_deadline_tokens(models):
    prompts = _prompts()
    eng = _engine(models, telemetry=True, **FLAT)
    eng.warmup()
    rids = [eng.add_request(p, n, deadline_s=0.5) for p, n in zip(prompts, NEWS)]
    fin = {r.rid: r for r in _timed_drain(eng)}
    assert sorted(fin) == sorted(rids)
    assert all(fin[r].finish_reason == "timeout" for r in rids)
    slo = eng.stats()["slo"]
    assert slo["tokens_out"] == 0 and slo["goodput_tokens"] == 0
    assert slo["goodput_ratio"] == 0.0 and slo["ttft_p99_s"] >= 0.0

    eng2 = _engine(models, telemetry=True, **FLAT)
    eng2.warmup()
    rids = [eng2.add_request(p, n, deadline_s=3.5) for p, n in zip(prompts, NEWS)]
    fin2 = {r.rid: r for r in _timed_drain(eng2)}
    assert sorted(fin2) == sorted(rids)
    assert any(r.finish_reason == "timeout" for r in fin2.values())
    slo2 = eng2.stats()["slo"]
    assert slo2["tokens_out"] > 0
    assert slo2["goodput_tokens"] == slo2["tokens_out"]

    # tokens emitted after the deadline (its step's clock already past
    # it) are tokens out but not goodput
    tel = eng2.obs
    good, out = tel.c_goodput_tokens.value, tel.c_tokens_out.value
    late = _prompts([6], seed=4)[0]
    eng2.add_request(late, 3, arrival=0.0, deadline_s=1e9)
    eng2.step(now=1.0)                      # admitted and prefilled: 1 token
    req = next(iter(eng2.scheduler.running.values()))
    req.deadline_s = 0.5                    # expire it from now on
    tel.step_begin()
    tel.step_end(eng2.scheduler, eng2.pool, [], now=2.0)   # no emission
    assert tel.c_goodput_tokens.value == good + 1
    req.out_tokens.append(0)                # one more emission past it
    tel.step_begin()
    tel.step_end(eng2.scheduler, eng2.pool, [], now=2.0)
    assert tel.c_tokens_out.value == out + 2
    assert tel.c_goodput_tokens.value == good + 1

    eng3 = _engine(models, telemetry=True, **FLAT)
    _drain(eng3, prompts)
    slo3 = eng3.stats()["slo"]
    assert slo3["goodput_ratio"] == 1.0
    assert slo3["goodput_tokens"] == slo3["tokens_out"] > 0


def test_telemetry_reset_clears_attribution(models):
    eng = _engine(models, telemetry=True, **FLAT)
    eng.warmup()
    _drain(eng)
    assert eng.obs.attribution_summary()["totals"]["steps"] > 0
    eng.telemetry(reset=True)
    after = eng.obs.attribution_summary()
    assert after["totals"] == fresh_totals()
    assert after["families"] == {}
    assert len(eng.obs.step_records) == 0
    assert eng.cost_model is not None


# ---------------------------------------------------------------------------
# the reference's AST invariant lint, aimed at the port
# ---------------------------------------------------------------------------

def test_port_obs_modules_pass_reference_ast_lint():
    """Monotonic clocks and no unseeded randomness, by the JAX package's
    own lint (pure ``ast``), over the port's obs modules and the shape
    linter; the port itself imports nothing of ``repro``."""
    from repro.analysis.ast_lint import lint_paths

    root = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
    obs, serving = root / "obs", root / "serving"
    targets = [obs, root / "analysis" / "shapes.py"]
    assert all(p.exists() for p in targets)
    assert len(list(obs.glob("*.py"))) == 7
    findings = lint_paths(targets, serving_root=serving,
                          clock_roots=(serving, obs))
    assert findings == [], [f.format() for f in findings]


def cost_table(dtypes=("float32", "bfloat16")) -> None:
    """Print each family's FLOPs and bytes from both cost models on the
    reduced configuration of this file (the port's analytic count beside
    XLA's), speculation on (its families include those without):
    ``PYTHONPATH=src python tests/test_torch_attrib.py``."""
    print("dtype | grid | family | FLOPs port | FLOPs XLA | bytes port | "
          "bytes XLA | KV gather")
    for dtype in dtypes:
        jm, jparams, m, params = _pair(dtype)
        for grid, kw in COST_GRIDS.items():
            kw = dict(max_slots=3, page_tokens=8, spec_tokens=2, **kw)
            cm = build_cost_model(Engine(m, params, device="cpu", **kw))
            jcm = jbuild_cost_model(JEngine(jm, jparams, **kw))
            for label, fc in cm.families.items():
                j = jcm.families[label]
                print(f"{dtype} | {grid} | {label} | {fc.flops:.6g} | "
                      f"{j.flops:.6g} | {fc.hbm_bytes:.6g} | {j.hbm_bytes:.6g} | "
                      f"{fc.kv_gather_bytes:.6g}")


if __name__ == "__main__":
    cost_table()
