"""The port's allocator audit and runtime sanitizer against the JAX
package's, on the CPU.

Each test drives the port's engine and the JAX engine in lockstep on the
same requests, with the port's sanitizer (``repro_torch.analysis.
sanitize``) on the one and the reference's (``repro.analysis.sanitize``)
on the other:

- a clean drain of each step family (prefix cache on, one copy-on-write,
  a NaN quarantine) passes both, with the same counts of model calls,
  write pages and quarantines checked, and both audits are empty;
- a planted write into a shared page, a planted retired rid still
  scheduled or holding pages, a planted write into the trash page and a
  step width outside the ladder each raise ``SanitizerError`` in both, at
  the same page; a planted refcount the audit finds in both;
- ``REPRO_SANITIZE=1`` installs the sanitizer at construction;
- the shape-ladder linter (``repro_torch.analysis.shapes``) beside the
  reference's ``lint_engine_shapes``: both clean on the same engines, with
  the same step families, with and without the traced audit of every
  family (``trace=True``), and a planted off-ladder width or mis-aligned
  chunk found by both;
- the KV-write aliasing pass (``lint_engine_aliasing``) clean on every
  configuration of both packages' ``CONFIG_MATRIX``; a flat update with
  its ``where`` guard removed flagged ``unguarded-write`` by both, and a
  step with an ``.item()`` flagged ``static-dims`` by the port.
"""

import re

import jax
import numpy as np
import pytest
import torch

from repro.analysis import sanitize as jsanitize
from repro.analysis import shapes as jshapes
from repro.analysis.aliasing import check_pool_consistency as jcheck_pool
from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models.model import build_model as jbuild_model
from repro.serving import faults as jfaults
from repro.serving import kv_cache as jkv
from repro.serving.engine import Engine as JEngine
from repro_torch.analysis import sanitize, shapes
from repro_torch.analysis.aliasing import check_pool_consistency
from repro_torch.analysis.report import Finding
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.models.model import build_model
from repro_torch.serving import faults
from repro_torch.serving import kv_cache as kv
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 3, "decode")
FAMILIES = {"flat": dict(chunk_tokens=8), "dense": dict(chunk_tokens=8, flat=False),
            "monolithic": {}}
T = 8                                    # page tokens


@pytest.fixture(scope="module")
def models():
    jm = jbuild_model(jreduced(jget_config("smollm2-135m"), layers=2), JRun(**F32),
                      JShape(*SHAPE))
    jparams = jm.init(jax.random.PRNGKey(0))
    m = build_model(reduced_config(get_config("smollm2-135m"), layers=2),
                    RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    return jm, jparams, m, from_jax_params(jax.tree.map(np.asarray, jparams))


def _pair(models, family, **kw):
    """(port engine, its sanitizer), (JAX engine, its sanitizer)."""
    jm, jparams, m, params = models
    kw = dict(max_slots=3, page_tokens=T, prefix_cache=True, **FAMILIES[family],
              **kw)
    eng, jeng = Engine(m, params, device="cpu", **kw), JEngine(jm, jparams, **kw)
    return (eng, sanitize.install(eng)), (jeng, jsanitize.install(jeng))


def _requests():
    """A 16-token prompt, two others, and the first repeated: admitted
    once a slot frees, with both of its pages cached, it copies the last
    one before its prefill writes there."""
    rng = np.random.default_rng(3)
    p = [rng.integers(0, 512, n).astype(np.int32) for n in (16, 11, 6)]
    return [(p[0], 6), (p[1], 5), (p[2], 9), (p[0].copy(), 4)]


def _decoding_mid_page(eng):
    """Step until a row decodes with its next write inside a page it
    already holds; returns that request."""
    while True:
        for r in sorted(eng.scheduler.running.values(), key=lambda r: r.rid):
            if r.status == "running" and r.len % T:
                return r
        eng.step()


def _both_raise(pair, plant):
    """Plant the same fault in both engines and step: each sanitizer
    raises; returns the two messages."""
    msgs = []
    for (eng, _), error in zip(pair, (sanitize.SanitizerError,
                                      jsanitize.SanitizerError)):
        plant(eng, _decoding_mid_page(eng))
        with pytest.raises(error) as e:
            eng.step()
        msgs.append(str(e.value))
    return msgs


@pytest.mark.parametrize("family", list(FAMILIES))
def test_clean_drain_passes_both_sanitizers(models, family):
    (eng, san), (jeng, jsan) = _pair(models, family)
    outs = []
    for e, pkg in ((eng, faults), (jeng, jfaults)):
        rids = [e.add_request(p, n) for p, n in _requests()]
        with pkg.FaultPlan([pkg.FaultEvent(2, "nan")]).on(e):
            fin = {r.rid: (r.out_tokens, r.finish_reason) for r in e.drain()}
        outs.append([fin[r] for r in rids])
    assert outs[0] == outs[1]
    assert [reason for _, reason in outs[0]].count("error") == 1
    assert eng.pool.cow_copies == jeng.pool.cow_copies == 1
    assert (san.checks, san.pages_checked, san.cancels_checked) == \
        (jsan.checks, jsan.pages_checked, jsan.cancels_checked)
    assert san.checks > 0 and san.pages_checked > 0 and san.cancels_checked == 1
    assert check_pool_consistency(eng, family) == []
    assert jcheck_pool(jeng, family) == []


@pytest.mark.parametrize("family", list(FAMILIES))
def test_planted_shared_page_write_raises(models, family):
    pair = _pair(models, family)
    for e, _ in pair:
        for p, n in _requests():
            e.add_request(p, n)

    def plant(eng, req):                  # a second holder of the write page
        eng.pool.share([req.pages.pages[req.len // T]])

    msgs = _both_raise(pair, plant)
    pages = [re.search(r"in-place write to page (\d+) with ref=2", m) for m in msgs]
    assert all(pages) and pages[0].group(1) == pages[1].group(1), msgs


@pytest.mark.parametrize("family", list(FAMILIES))
def test_planted_trash_write_raises(models, family):
    pair = _pair(models, family)
    for e, _ in pair:
        for p, n in _requests():
            e.add_request(p, n)

    def plant(eng, req):                  # the block table misses the window
        req.pages.pages[req.len // T] = 0

    msgs = _both_raise(pair, plant)
    assert all("writes trash page 0" in m for m in msgs), msgs


@pytest.mark.parametrize("case", ["scheduled", "holds-pages"])
def test_planted_retired_rid_raises_and_is_found(models, case):
    pair = _pair(models, "flat")
    for e, _ in pair:
        for p, n in _requests():
            e.add_request(p, n)
    msgs, findings = [], []
    for (eng, _), pool_mod, check, error in zip(
            pair, (kv, jkv), (check_pool_consistency, jcheck_pool),
            (sanitize.SanitizerError, jsanitize.SanitizerError)):
        req = _decoding_mid_page(eng)
        if case == "scheduled":
            eng._retired_rids.add(req.rid)
        else:                             # a retired rid whose pages leaked
            eng._retired_rids.add(99)
            leak = pool_mod.SequencePages(eng.pool, owner=99)
            leak.ensure(1)
            findings.append([f.rule for f in check(eng, case)])
        with pytest.raises(error) as e:
            eng.step()
        msgs.append(str(e.value))
    want = (f"retired rid {req.rid} is still scheduled" if case == "scheduled"
            else "retired rid 99 still holds pages")
    assert all(want in m for m in msgs), msgs
    if case == "holds-pages":
        assert findings[0] == findings[1] == ["retired-holds-pages"]


def test_audit_finds_a_stale_refcount(models):
    (eng, _), (jeng, _) = _pair(models, "flat")
    for e in (eng, jeng):
        for p, n in _requests()[:2]:
            e.add_request(p, n)
        e.step()
        page = sorted(e.pool.ledger()["refs"])[0]
        e.pool.share([page])                 # a reference nobody holds
    got, want = check_pool_consistency(eng, "x"), jcheck_pool(jeng, "x")

    def key(f):
        return f.rule, re.match(r"page (\d+): ref=(\d+)", f.message).groups()

    assert list(map(key, got)) == list(map(key, want))
    assert [f.rule for f in got] == ["ledger-mismatch"]
    assert isinstance(got[0], Finding) and got[0].format().startswith(
        "[kv-aliasing/ledger-mismatch] x pool: page ")


def test_width_outside_the_ladder_raises(models):
    (eng, san), (jeng, jsan) = _pair(models, "flat")
    assert san.flat_widths == jsan.flat_widths
    (deng, dsan), (jdeng, jdsan) = _pair(models, "dense")
    (meng, msan), (jmeng, jmsan) = _pair(models, "monolithic")
    assert dsan.paged_widths == jdsan.paged_widths
    assert msan.paged_widths == jmsan.paged_widths
    w = max(san.flat_widths) + T
    for s, error in ((san, sanitize.SanitizerError),
                     (jsan, jsanitize.SanitizerError)):
        with pytest.raises(error, match=f"flat step width {w} is not in"):
            s.check_flat(np.zeros((1, w), np.int32), np.zeros((3, 8), np.int32),
                         np.full(w, -1, np.int32), np.zeros(w, np.int32))
        with pytest.raises(error, match="not m_r-aligned"):
            s.flat_widths.add(12)
            s.check_flat(np.zeros((1, 12), np.int32), np.zeros((3, 8), np.int32),
                         np.full(12, -1, np.int32), np.zeros(12, np.int32))


def test_repro_sanitize_installs_at_construction(models, monkeypatch):
    _, _, m, params = models
    monkeypatch.setenv("REPRO_SANITIZE", "1")
    eng = Engine(m, params, device="cpu", max_slots=3, chunk_tokens=8)
    assert isinstance(eng.sanitizer, sanitize.StepSanitizer)
    assert sanitize.install(eng) is eng.sanitizer
    eng.warmup()
    eng.add_request(np.arange(5), 3)
    assert [r.finish_reason for r in eng.drain()] == ["length"]
    assert eng.sanitizer.checks > 0
    monkeypatch.setenv("REPRO_SANITIZE", "0")
    assert Engine(m, params, device="cpu", max_slots=3).sanitizer is None


# ---------------------------------------------------------------------------
# the shape-ladder linter, host half
# ---------------------------------------------------------------------------

LADDER_CONFIGS = {"flat": dict(chunk_tokens=16, token_budget=24),
                  "flat-spec": dict(chunk_tokens=16, spec_tokens=2),
                  "dense": dict(chunk_tokens=16, flat=False),
                  "dense-spec": dict(chunk_tokens=16, flat=False, spec_tokens=2),
                  "monolithic": {}, "monolithic-spec": dict(spec_tokens=2)}


@pytest.mark.parametrize("config", sorted(LADDER_CONFIGS))
def test_shape_ladders_clean_beside_reference(models, config):
    jm, jparams, m, params = models
    kw = dict(max_slots=3, page_tokens=T, **LADDER_CONFIGS[config])
    eng, jeng = Engine(m, params, device="cpu", **kw), JEngine(jm, jparams, **kw)
    assert shapes.lint_engine_shapes(eng, config) == []
    assert jshapes.lint_engine_shapes(jeng, config, trace=False) == []
    assert [label for label, _ in shapes.step_families(eng)] == \
        [label for label, *_ in jshapes.step_families(jeng)]
    for label, g in shapes.step_families(eng):
        assert label.split("[")[1].split("]")[0] == f"{g.batch},{g.seq}"
    assert shapes.lint_engine_shapes(eng, config, trace=True) == []
    assert jshapes.lint_engine_shapes(jeng, config, trace=True) == []


def test_planted_off_ladder_widths_found_by_both(models):
    jm, jparams, m, params = models
    kw = dict(max_slots=3, page_tokens=T, chunk_tokens=16)
    eng, jeng = Engine(m, params, device="cpu", **kw), JEngine(jm, jparams, **kw)
    for e in (eng, jeng):
        real = e._flat_shapes()
        e._flat_shapes = lambda real=real: sorted(set(real) | {24}, reverse=True)
    got = shapes.lint_engine_shapes(eng, "seeded")
    want = jshapes.lint_engine_shapes(jeng, "seeded", trace=False)
    assert [(f.rule, f.message) for f in got] == \
        [(f.rule, f.message) for f in want]
    assert any(f.rule == "flat-ladder" and "24" in f.message for f in got)

    kw = dict(max_slots=3, page_tokens=T, chunk_tokens=16, flat=False)
    eng, jeng = Engine(m, params, device="cpu", **kw), JEngine(jm, jparams, **kw)
    eng.chunk_tokens = jeng.chunk_tokens = 11          # m_r = 8
    got = shapes.lint_engine_shapes(eng, "seeded")
    want = jshapes.lint_engine_shapes(jeng, "seeded", trace=False)
    assert [(f.rule, f.message) for f in got] == \
        [(f.rule, f.message) for f in want]
    assert "chunk-align" in {f.rule for f in got}


# ---------------------------------------------------------------------------
# the traced passes: KV-write aliasing and the static-dims audit
# ---------------------------------------------------------------------------

from repro.analysis.aliasing import lint_engine_aliasing as jlint_aliasing  # noqa: E402
from repro.analysis.aliasing import lint_kv_writes as jlint_kv_writes  # noqa: E402
from repro.analysis.aliasing import taint_step as jtaint_step  # noqa: E402
from repro.analysis.runner import CONFIG_MATRIX as JMATRIX  # noqa: E402
from repro_torch.analysis import aliasing  # noqa: E402
from repro_torch.analysis.runner import CONFIG_MATRIX  # noqa: E402


@pytest.mark.parametrize("config", [label for label, _ in CONFIG_MATRIX])
def test_kv_aliasing_clean_on_every_config_beside_reference(models, config):
    jm, jparams, m, params = models
    assert [label for label, _ in CONFIG_MATRIX] == [label for label, _ in JMATRIX]
    kw = dict(max_slots=3, page_tokens=T, **dict(CONFIG_MATRIX)[config])
    eng, jeng = Engine(m, params, device="cpu", **kw), JEngine(jm, jparams, **kw)
    assert aliasing.lint_engine_aliasing(eng, config) == []
    assert jlint_aliasing(jeng, config) == []


def test_unguarded_flat_update_flagged_by_both():
    """The flat update with its where guard removed: padding positions
    (row -1) would write a real row's page.  Both walkers find the write
    indexed by the block tables alone."""
    import jax.numpy as jnp

    def jbad(cache, k, v, bt, row_ids, q_pos):
        t = cache["k_pages"].shape[1]
        page = bt[jnp.maximum(row_ids, 0), q_pos // t]
        return {"k_pages": cache["k_pages"].at[page, q_pos % t].set(k[0]),
                "v_pages": cache["v_pages"].at[page, q_pos % t].set(v[0])}

    def bad(cache, k, v, bt, row_ids, q_pos):
        kp, vp = cache["k_pages"], cache["v_pages"]
        t = kp.shape[1]
        page = bt[row_ids.long().clamp(min=0), q_pos.long() // t].long()
        kp[page, q_pos.long() % t] = k[0]
        vp[page, q_pos.long() % t] = v[0]
        return cache

    S = jax.ShapeDtypeStruct
    shp, w = (9, T, 1, 16), 16
    meta = lambda s, d=torch.float32: torch.empty(s, dtype=d, device="meta")
    roles = {0: lambda p: "pages" if "_pages" in p else None,
             3: "block_tables", 4: "validity", 5: "validity"}
    jw = jtaint_step(jbad, ({"k_pages": S(shp, jnp.float32),
                             "v_pages": S(shp, jnp.float32)},
                            S((1, w, 1, 16), jnp.float32), S((1, w, 1, 16), jnp.float32),
                            S((3, 8), jnp.int32), S((w,), jnp.int32),
                            S((w,), jnp.int32)), roles)
    pw = aliasing.taint_step(bad, ({"k_pages": meta(shp), "v_pages": meta(shp)},
                                   meta((1, w, 1, 16)), meta((1, w, 1, 16)),
                                   meta((3, 8), torch.int32), meta((w,), torch.int32),
                                   meta((w,), torch.int32)), roles)
    got = aliasing.lint_kv_writes(pw, "seeded", expect_writes=2)
    want = jlint_kv_writes(jw, "seeded", expect_writes=2)
    assert [f.rule for f in got] == [f.rule for f in want] == ["unguarded-write"] * 2
    assert all("trash0" in f.message for f in got + want)


def test_host_sync_in_a_step_is_a_static_dims_finding(models, monkeypatch):
    """A step that reads a value back to the host (an ``.item()``) cannot
    be captured once per shape: the traced audit reports it as a
    static-dims finding naming the op and the line, instead of crashing."""
    _, _, m, params = models
    eng = Engine(m, params, device="cpu", max_slots=3, page_tokens=T,
                 chunk_tokens=16)
    real = m.flat_decode_step

    def syncing(params, caches, token, *rest, **kw):
        token = token + int(token.sum().item()) * 0      # a host round trip
        return real(params, caches, token, *rest, **kw)

    monkeypatch.setattr(m, "flat_decode_step", syncing)
    found = shapes.lint_engine_shapes(eng, "seeded", trace=True)
    assert {f.rule for f in found} == {"static-dims"}
    assert len(found) == len(shapes.step_families(eng))
    line = syncing.__code__.co_firstlineno + 1
    assert all(f.where == f"aten._local_scalar_dense @ {__file__}:{line}"
               for f in found), [f.where for f in found]
    monkeypatch.undo()
    assert shapes.lint_engine_shapes(eng, "clean", trace=True) == []
