"""The port's resilience layer against the JAX package's, on the CPU.

Mirrors ``tests/test_resilience.py``: every test runs the JAX engine and
the port's engine on the same inputs (a reduced SmolLM2, f32, the
reference's weights carried across, prompts from a numpy seed) and
compares tokens, finish reasons and ``stats()["resilience"]``:

- identity under chaos: under each seeded fault plan (OutOfPages spikes,
  drafter failures mid-spec, a NaN-logit row, page-copier failures) every
  survivor gives the clean drain's tokens, in each of three engine
  configurations, the allocator audits clean, and a warmed engine traces
  no new step signature;
- the NaN quarantine, the drafter auto-disable and its reset, deadlines
  and ``max_queue_s``, bounded-queue sheds, ``generate``'s padding, cancel
  from every state, the watchdog, and ``FaultPlan`` replayability;
- the cancel-interleaving property over the port's scheduler (the
  reference's hypothesis test, and three fixed seeds run through both
  packages' schedulers, whose ledgers must agree after every operation).
"""

import random

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.analysis.aliasing import check_pool_consistency as jcheck_pool
from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models.model import build_model as jbuild_model
from repro.serving import faults as jfaults
from repro.serving import kv_cache as jkv
from repro.serving import prefix_cache as jpc
from repro.serving import scheduler as jsched
from repro.serving.engine import Engine as JEngine
from repro_torch.analysis.aliasing import check_pool_consistency
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.models.model import build_model
from repro_torch.serving import faults
from repro_torch.serving import kv_cache as kv
from repro_torch.serving import prefix_cache as pc
from repro_torch.serving import scheduler as sched
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 3, "decode")
# a sampled pick of the port may part from the JAX engine's only where its
# Gumbel-perturbed top-2 margin is below this (tests/test_torch_sampling.py)
MARGIN = 1e-5


@pytest.fixture(scope="module")
def models():
    jm = jbuild_model(jreduced(jget_config("smollm2-135m"), layers=2), JRun(**F32),
                      JShape(*SHAPE))
    jparams = jm.init(jax.random.PRNGKey(0))
    m = build_model(reduced_config(get_config("smollm2-135m"), layers=2),
                    RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    return jm, jparams, m, from_jax_params(jax.tree.map(np.asarray, jparams))


def _engines(models, **kw):
    jm, jparams, m, params = models
    return Engine(m, params, device="cpu", **kw), JEngine(jm, jparams, **kw)


def _prompts(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def _plan(pkg, events):
    return pkg.FaultPlan([pkg.FaultEvent(s, k) for s, k in events])


def _drain_outputs(engine, prompts, news, *, greedy=True, plan=None, seed=0):
    for p, n in zip(prompts, news):
        engine.add_request(p, n)
    if plan is not None:
        with plan.on(engine):
            fin = engine.drain(greedy=greedy, seed=seed)
    else:
        fin = engine.drain(greedy=greedy, seed=seed)
    return {r.rid: (list(r.out_tokens), r.finish_reason) for r in fin}


def _record_margins(eng):
    """(rid, position) -> perturbed top-2 margin of each sampled pick of the
    port engine."""
    from repro_torch.serving import sampling
    margins, pick = {}, eng._pick

    def recording(row, req, greedy, seed):
        if not greedy and req.temperature > 0:
            s = seed if req.seed is None else req.seed
            z = row + sampling.gumbel(sampling.pick_key(s, req.rid,
                                                        len(req.out_tokens)),
                                      row.shape[0])
            top2 = np.sort(z)[-2:]
            margins[(req.rid, len(req.out_tokens))] = float(top2[1] - top2[0])
        return pick(row, req, greedy, seed)

    eng._pick = recording
    return margins


def _same_as_jax(got, want, margins=None):
    """The port's outputs equal the JAX engine's: the same rids and finish
    reasons, and the same tokens, or (sampled, ``margins`` given) tokens
    that part only at a pick below MARGIN."""
    assert sorted(got) == sorted(want)
    for rid, (toks, reason) in got.items():
        wtoks, wreason = want[rid]
        assert reason == wreason, rid
        if margins is None:
            assert toks == wtoks, rid
            continue
        for pos, (a, b) in enumerate(zip(toks, wtoks)):
            if a != b:
                assert margins.get((rid, pos), np.inf) < MARGIN, (rid, pos)
                break
        else:
            assert len(toks) == len(wtoks), rid


def _audit(eng, label):
    """The allocator balances after a drain: no finding, and every used
    page is a prefix-cache page held by nobody else."""
    assert not check_pool_consistency(eng, label)
    live = sum(len(s.pages) for s in eng.pool.sequences())
    cached = (len(set(eng.prefix_cache.pages()))
              if eng.prefix_cache is not None else 0)
    assert eng.pool.num_used == live + cached == cached


# ---------------------------------------------------------------------------
# identity under chaos
# ---------------------------------------------------------------------------

# The trace makes each fault fire wherever its path exists: 8-token pages
# so admissions and growth allocate often, and a fourth request repeating
# the first one's 16-token prompt, admitted at step 5 when a slot frees,
# with both pages cached: its prefill restarts inside the last shared
# page, which is copied first (the copier plan covers step 5).
PLANS = {
    "oom-spike": [(1, "oom"), (2, "oom"), (4, "oom")],
    "drafter-mid-spec": [(s, "drafter") for s in (1, 2, 3, 5, 7)],
    "nan-quarantine": [(3, "nan")],
    "copier-failure": [(1, "copier"), (3, "copier"), (5, "copier")],
}
CONFIGS = {
    "chunked-greedy-cache": (dict(chunk_tokens=8, flat=False, prefix_cache=True),
                             True),
    "flat-sampled": (dict(chunk_tokens=8), False),
    "flat-spec-greedy-cache": (dict(chunk_tokens=8, spec_tokens=3,
                                    prefix_cache=True), True),
}
NEWS = [6, 4, 9, 7]
_CLEAN = {}


def _chaos_prompts():
    p = _prompts([16, 11, 8])
    return p + [p[0].copy()]


def _clean(models, config):
    if config not in _CLEAN:
        kwargs, greedy = CONFIGS[config]
        eng, _ = _engines(models, max_slots=3, page_tokens=8, **kwargs)
        _CLEAN[config] = _drain_outputs(eng, _chaos_prompts(), NEWS, greedy=greedy)
    return _CLEAN[config]


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_chaos_identity(models, config, plan):
    """Every survivor of a faulted drain gives the clean drain's tokens;
    the port's faulted drain equals the JAX engine's under the same plan
    (tokens, reasons, resilience counters, faults fired); the allocator
    audits clean; a warmed engine traces nothing new."""
    kwargs, greedy = CONFIGS[config]
    prompts = _chaos_prompts()
    clean = _clean(models, config)
    assert all(reason in ("length", "eos") for _, reason in clean.values())

    eng, jeng = _engines(models, max_slots=3, page_tokens=8, **kwargs)
    eng.warmup()
    traces = dict(eng.model.trace_counts)
    margins = None if greedy else _record_margins(eng)
    p, jp = _plan(faults, PLANS[plan]), _plan(jfaults, PLANS[plan])
    out = _drain_outputs(eng, prompts, NEWS, greedy=greedy, plan=p)
    jout = _drain_outputs(jeng, prompts, NEWS, greedy=greedy, plan=jp)
    assert set(out) == set(clean), "lost requests"
    for rid, (toks, reason) in out.items():
        if reason != "error":                    # a quarantined casualty
            assert (toks, reason) == clean[rid], rid
    _same_as_jax(out, jout, margins)
    assert eng.stats()["resilience"] == jeng.stats()["resilience"]
    assert p.fired == jp.fired
    kind = PLANS[plan][0][1]
    applies = {"drafter": "spec_tokens" in kwargs,
               "copier": "prefix_cache" in kwargs}.get(kind, True)
    assert (p.fired[kind] > 0) == applies, p.fired
    _audit(eng, f"chaos:{config}:{plan}")
    assert not jcheck_pool(jeng, f"chaos:{config}:{plan}")
    assert dict(eng.model.trace_counts) == traces
    assert not any(eng.stats()["captures"].values())


def test_chaos_zero_retrace_after_warmup(models):
    """Fault handling rides the warmed shapes: quarantine, rollback and
    displacement change host bookkeeping, never the step signatures."""
    eng, jeng = _engines(models, max_slots=3, page_tokens=8, chunk_tokens=8,
                         spec_tokens=3, prefix_cache=True)
    eng.warmup()
    before = dict(eng.model.trace_counts)
    events = [(1, "oom"), (2, "drafter"), (3, "nan"), (4, "copier"), (5, "copier"),
              (6, "drafter")]
    p = _plan(faults, events)
    out = _drain_outputs(eng, _chaos_prompts(), NEWS, plan=p)
    jout = _drain_outputs(jeng, _chaos_prompts(), NEWS, plan=_plan(jfaults, events))
    assert all(p.fired.values()), p.fired
    assert dict(eng.model.trace_counts) == before, "a faulted drain traced anew"
    assert not any(eng.stats()["captures"].values())
    _same_as_jax(out, jout)
    assert eng.stats()["resilience"] == jeng.stats()["resilience"]


def test_nan_quarantine_frees_pages_and_skips_cache(models):
    """The poisoned row finishes as "error", its pages are freed and the
    prefix cache gains nothing from it; the other row decodes on."""
    eng, jeng = _engines(models, max_slots=2, chunk_tokens=8, prefix_cache=True)
    prompts = _prompts([9, 6], seed=2)
    p, jp = _plan(faults, [(1, "nan")]), _plan(jfaults, [(1, "nan")])
    out = _drain_outputs(eng, prompts, [5, 5], plan=p)
    _same_as_jax(out, _drain_outputs(jeng, prompts, [5, 5], plan=jp))
    dead = [rid for rid, (_, reason) in out.items() if reason == "error"]
    assert len(dead) == 1 and p.fired["nan"] == 1
    assert eng.stats()["resilience"] == jeng.stats()["resilience"]
    assert eng.stats()["resilience"]["quarantines"] == 1
    _audit(eng, "nan-quarantine")
    assert not any(s.pages for s in eng.pool.sequences() if s.owner == dead[0])


def test_drafter_auto_disable_counts_and_resets(models):
    """Three consecutive drafter failures turn speculation off for the
    rest of the drain; the next drain drafts again.  The fresh drain's
    prompt repeats a motif, so the n-gram drafter finds a match (the JAX
    test's random 7-token prompt gives it none, and drafts nothing)."""
    eng, jeng = _engines(models, max_slots=2, chunk_tokens=8, spec_tokens=3)
    events = [(s, "drafter") for s in range(1, 12)]
    out = _drain_outputs(eng, _prompts([5, 8]), [8, 8], plan=_plan(faults, events))
    jout = _drain_outputs(jeng, _prompts([5, 8]), [8, 8],
                          plan=_plan(jfaults, events))
    _same_as_jax(out, jout)
    res = eng.stats()["resilience"]
    assert res == jeng.stats()["resilience"]
    assert res["spec_auto_disables"] == 1
    assert res["drafter_errors"] == eng._drafter_fail_limit == 3
    assert not res["spec_disabled"], "the disable lasts one drain"
    assert all(reason == "length" for _, reason in out.values())
    assert eng._drafted == jeng._drafted
    motif = np.tile(_prompts([3], seed=9)[0], 3)
    _same_as_jax(_drain_outputs(eng, [motif], [8]), _drain_outputs(jeng, [motif], [8]))
    assert eng._drafted > 0 and eng._drafted == jeng._drafted


# ---------------------------------------------------------------------------
# deadlines, admission control, padding
# ---------------------------------------------------------------------------

def test_deadline_and_max_queue_timeouts(models):
    prompts = _prompts([6, 6, 6], seed=3)
    fins = []
    for eng in _engines(models, max_slots=2, chunk_tokens=8):
        eng.add_request(prompts[0], 4)
        eng.add_request(prompts[1], 4, deadline_s=0.5, arrival=0.0)
        eng.add_request(prompts[2], 4, max_queue_s=0.25, arrival=0.0)
        fin = {}
        for now in (0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0):
            for r in eng.step(now=now):
                fin[r.rid] = (r.finish_reason, list(r.out_tokens))
        while eng.scheduler.has_work:
            for r in eng.step(now=9.0):
                fin[r.rid] = (r.finish_reason, list(r.out_tokens))
        fins.append((fin, eng.stats()["resilience"]))
    (fin, res), (jfin, jres) = fins
    assert fin == jfin and res == jres
    assert fin[0][0] == "length" and fin[1][0] == "timeout"
    assert fin[2][0] == "timeout" and fin[2][1] == []     # never admitted
    assert res["timeouts"] == 2


def test_bounded_queue_sheds_with_typed_rejections(models):
    prompts = _prompts([4] * 6, seed=4)
    eng, jeng = _engines(models, max_slots=2, chunk_tokens=8, queue_limit=2)
    out = _drain_outputs(eng, prompts, [3] * 6)
    _same_as_jax(out, _drain_outputs(jeng, prompts, [3] * 6))
    assert [reason for _, reason in out.values()].count("rejected") == 4
    assert eng.stats()["resilience"] == jeng.stats()["resilience"]
    assert eng.stats()["resilience"]["sheds"] == 4
    _audit(eng, "shed")

    # the page-demand signal sheds on predicted demand, typed kind
    for kvm, sm in ((kv, sched), (jkv, jsched)):
        s = sm.Scheduler(2, kvm.PagedKVPool(1 + 4, 8), 48, queue_pages=2)
        s.add(sm.Request(rid=0, prompt=np.zeros(16, np.int32), max_new=4))
        with pytest.raises(sm.AdmissionError) as e:
            s.add(sm.Request(rid=1, prompt=np.zeros(16, np.int32), max_new=4))
        assert e.value.kind == "page-demand" and e.value.rid == 1
        assert s.stats()["num_rejected"] == 1 and len(s.waiting) == 1
    # an impossible request still raises out of Engine.add_request
    eng2, _ = _engines(models, max_slots=2, chunk_tokens=8, queue_limit=2)
    with pytest.raises(sched.AdmissionError) as e2:
        eng2.add_request(np.zeros(80, np.int32), 60)
    assert e2.value.kind == "impossible"


def test_generate_pads_timeout_and_rejected_rows(models):
    """Timeout, rejected and error rows pad to full width like eos rows."""
    batch = {"tokens": np.stack(_prompts([6] * 4, seed=5))}
    outs = []
    for eng in _engines(models, max_slots=2, chunk_tokens=8, queue_limit=1):
        outs.append(eng.generate(batch, 5, eos_id=7, return_reasons=True))
    (out, reasons), (jout, jreasons) = outs
    np.testing.assert_array_equal(out, jout)
    assert reasons == jreasons and out.shape == (4, 5)
    assert reasons.count("rejected") == 3
    for i, reason in enumerate(reasons):
        if reason == "rejected":
            assert (out[i] == 7).all()

    # a deadline that never fires leaves generate() as it is without one
    eng, jeng = _engines(models, max_slots=4, chunk_tokens=8)
    timed = eng.generate(batch, 5, deadline_s=3600.0)
    np.testing.assert_array_equal(timed, eng.generate(batch, 5))
    np.testing.assert_array_equal(timed, jeng.generate(batch, 5))

    # an already elapsed deadline times every row out, still full width
    eng3, _ = _engines(models, max_slots=4, chunk_tokens=8)
    out3, reasons3 = eng3.generate(batch, 5, eos_id=7, deadline_s=0.0,
                                   return_reasons=True)
    assert out3.shape == (4, 5) and set(reasons3) == {"timeout"}
    assert (out3 == 7).all()
    _audit(eng3, "all-timeout")

    # a quarantined row pads too
    eng4, _ = _engines(models, max_slots=4, chunk_tokens=8)
    with _plan(faults, [(1, "nan")]).on(eng4):
        out4, reasons4 = eng4.generate(batch, 5, eos_id=7, return_reasons=True)
    assert reasons4.count("error") == 1 and out4.shape == (4, 5)
    bad = reasons4.index("error")
    assert (out4[bad, 1:] == 7).all()


@pytest.mark.parametrize("family", ["flat", "dense", "monolithic"])
def test_cancel_from_every_state(models, family):
    """Cancel a queued, a prefilling and a decoding request (and one
    already finished, refused); the survivor decodes on, in lockstep with
    the JAX engine, and nothing leaks."""
    kw = {"flat": dict(chunk_tokens=8, token_budget=8),
          "dense": dict(chunk_tokens=8, token_budget=8, flat=False),
          "monolithic": {}}[family]
    prompts = _prompts([20, 6, 5, 7], seed=6)
    runs = []
    for eng in _engines(models, max_slots=3, **kw):
        rids = [eng.add_request(p, 6) for p in prompts]
        assert eng.cancel(rids[3])                    # queued, never admitted
        fin = eng.step()
        state = {r.rid: r.status for r in eng.scheduler.running.values()}
        if family != "monolithic":
            assert state[rids[0]] == "prefilling"
        live = [r for r in rids[:3] if state.get(r) in ("prefilling", "running")]
        target = rids[0] if family != "monolithic" else live[0]
        assert eng.cancel(target)                     # prefilling (or decoding)
        while not any(r.status == "running" and r.rid != target
                      for r in eng.scheduler.running.values()):
            fin += eng.step()
        dec = min(r.rid for r in eng.scheduler.running.values()
                  if r.status == "running")
        assert eng.cancel(dec)                        # decoding
        fin += eng.drain()
        reasons = {r.rid: r.finish_reason for r in fin}
        assert not eng.cancel(rids[3]), "a finished rid is not cancellable"
        runs.append((reasons, {r.rid: r.out_tokens for r in fin},
                     eng.stats()["resilience"]))
        assert eng.pool.num_used == 0
        assert not check_pool_consistency(eng, "cancel-states")
    (reasons, toks, res), (jreasons, jtoks, jres) = runs
    assert (reasons, toks, res) == (jreasons, jtoks, jres)
    assert list(reasons.values()).count("cancelled") == 3
    assert res["cancels"] == 3


@pytest.mark.parametrize("family,stall", [
    ("flat", "flat step scheduled zero tokens"),
    ("monolithic", "no request advanced for 5 consecutive steps")])
def test_watchdog_turns_stuck_drain_into_stall_error(models, family, stall):
    """A wedged pool: the flat step's admitted row gets no chunk (a
    zero-token step), the monolithic admission never completes (the
    watchdog proper); either way a StallError names the rid, in the JAX
    engine's words, and the drain recovers once the pool does."""
    kw = dict(chunk_tokens=8) if family == "flat" else {}
    messages = []
    for eng, error, oop in zip(_engines(models, max_slots=2, watchdog_steps=5,
                                        **kw),
                               (faults.StallError, jfaults.StallError),
                               (kv.OutOfPages, jkv.OutOfPages)):
        orig_alloc = eng.pool.alloc

        def dead_alloc(*a, oop=oop, **k):
            raise oop("wedged pool (test)")

        eng.pool.alloc = dead_alloc
        rid = eng.add_request(_prompts([6], seed=7)[0], 4)
        with pytest.raises(error) as e:
            eng.drain()
        assert f"rid {rid}" in str(e.value) and stall in str(e.value)
        messages.append(str(e.value))
        assert eng.stats()["resilience"]["watchdog_trips"] == 1
        eng.pool.alloc = orig_alloc
        assert [r.finish_reason for r in eng.drain()] == ["length"]
    assert messages[0] == messages[1]


def test_fault_plan_is_replayable():
    a, b = faults.FaultPlan.random(11, steps=20), faults.FaultPlan.random(11, steps=20)
    assert a.events == b.events
    assert faults.FaultPlan.random(12, steps=20).events != a.events
    assert [(e.step, e.kind) for e in a.events] == \
        [(e.step, e.kind) for e in jfaults.FaultPlan.random(11, steps=20).events]
    with pytest.raises(ValueError):
        faults.FaultPlan([faults.FaultEvent(1, "segfault")])
    with pytest.raises(ValueError):
        faults.FaultPlan([faults.FaultEvent(-1, "oom")])


def test_engine_knobs_match_the_reference(models):
    """prepack=False packs per call with the same tokens; watermark_pages
    reaches admission; nan_guard=False lets a NaN row pick on."""
    prompts = _prompts([5, 11, 8], seed=8)
    base = _drain_outputs(_engines(models, max_slots=3, chunk_tokens=8)[0],
                          prompts, [4, 4, 4])
    eng, _ = _engines(models, max_slots=3, chunk_tokens=8, prepack=False)

    def keys(tree):
        for k, v in tree.items():
            yield k
            if isinstance(v, dict):
                yield from keys(v)

    assert "w_pack" not in set(keys(eng.params))
    assert _drain_outputs(eng, prompts, [4, 4, 4]) == base
    eng, jeng = _engines(models, max_slots=3, chunk_tokens=8, num_pages=1 + 4,
                         watermark_pages=3)
    assert eng.scheduler.watermark_pages == 3
    _same_as_jax(_drain_outputs(eng, prompts, [4, 4, 4]),
                 _drain_outputs(jeng, prompts, [4, 4, 4]))
    assert eng.stats()["scheduler"] == jeng.stats()["scheduler"]
    eng, jeng = _engines(models, max_slots=3, chunk_tokens=8, nan_guard=False)
    p, jp = _plan(faults, [(2, "nan")]), _plan(jfaults, [(2, "nan")])
    out = _drain_outputs(eng, prompts, [4, 4, 4], plan=p)
    _same_as_jax(out, _drain_outputs(jeng, prompts, [4, 4, 4], plan=jp))
    assert p.fired["nan"] == 1 and eng.stats()["resilience"]["quarantines"] == 0


# ---------------------------------------------------------------------------
# the cancel-interleaving property over the scheduler
# ---------------------------------------------------------------------------

def _cancel_interleaving(kvm, sm, pcm, seed, usable):
    """Any interleaving of admit / chunked prefill / decode growth /
    speculative rollback / displacement / cancel keeps allocs + shares
    balanced against frees, live refcounts >= 1, and no cancelled
    request's pages live, from any state.  Returns the pool's ledger
    after every operation."""
    rng = random.Random(seed)
    t = 8
    pool = kvm.PagedKVPool(1 + usable, t)
    pool.page_copier = lambda src, dst: None
    cache = pcm.PrefixCache(pool, layout_key=(4,))
    s = sm.Scheduler(3, pool, 6 * t, chunk_tokens=t, chunk_align=4,
                     prefix_cache=cache, queue_limit=6)
    next_rid = [0]
    retired = set()
    trail = []

    def tok(n):
        g = np.random.Generator(np.random.Philox(rng.randrange(999)))
        return g.integers(1, 50, size=n).astype(np.int32)

    def add():
        req = sm.Request(rid=next_rid[0], prompt=tok(rng.randrange(2, 3 * t)),
                         max_new=rng.randrange(1, 2 * t))
        try:
            s.add(req)
            next_rid[0] += 1
        except sm.AdmissionError:
            pass

    def admit():
        s.admit()

    def finish_if_done(req):
        if req.done():
            s.finish(req)
            retired.add(req.rid)

    def chunk():
        for slot, n in list(s.plan_chunks(t).items()):
            req = s.running.get(slot)
            if req is None or n == 0 or req.status != "prefilling":
                continue
            req.prefill_cursor += n
            req.len = req.prefill_cursor
            cache.insert(req.prompt, req.pages.pages, req.prefill_cursor)
            if req.prefill_cursor >= req.prompt_len:
                req.status = "running"
                req.out_tokens.append(1)
                finish_if_done(req)

    def decode():
        s.grow()
        for slot, req in list(s.running.items()):
            if req.status != "running" or req.pages.capacity <= req.len:
                continue
            req.len += 1
            req.out_tokens.append(1)
            finish_if_done(req)

    def spec():
        rows = [(sl, r) for sl, r in s.running.items() if r.status == "running"]
        if not rows:
            return
        slot, req = rng.choice(rows)
        s.grow(want={slot: 3})
        if s.running.get(slot) is not req:
            return                               # displaced by its own ask
        if req.pages.capacity > req.len:
            req.len += 1
            req.out_tokens.append(1)
        try:
            req.pages.truncate(req.len)          # the rejected drafts' rollback
        except kvm.PoolError:
            s.cancel(req.rid, "error", cache_pages=False)
            retired.add(req.rid)
            return
        finish_if_done(req)

    def cancel():
        live = [r.rid for r in s.waiting] + [r.rid for r in s.running.values()]
        if not live:
            return
        rid = rng.choice(live)
        reason = rng.choice(["cancelled", "timeout", "error"])
        s.cancel(rid, reason, cache_pages=reason != "error")
        retired.add(rid)

    ops = [add, add, admit, chunk, decode, spec, cancel]
    for _ in range(80):
        rng.choice(ops)()
        assert all(v >= 1 for v in pool._ref.values())
        assert pool.num_used + pool.num_free == pool.usable_pages
        assert (pool.total_allocs + pool.total_shares
                == pool.total_frees + sum(pool._ref.values()))
        for seq in pool.sequences():
            assert not (seq.owner in retired and seq.pages), \
                f"retired rid {seq.owner} still holds {seq.pages}"
        trail.append((pool.ledger(), sorted(cache.pages())))

    for r in list(s.waiting) + list(s.running.values()):
        s.cancel(r.rid)
    cache.clear()
    assert pool.num_used == 0
    assert pool.total_allocs + pool.total_shares == pool.total_frees
    trail.append((s.stats()["num_cancels"], s.stats()["num_quarantines"],
                  s.stats()["num_timeouts"]))
    return trail


@pytest.mark.slow
@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 10 ** 6), usable=st.integers(5, 12))
def test_property_cancel_interleaving_keeps_invariants(seed, usable):
    _cancel_interleaving(kv, sched, pc, seed, usable)


@pytest.mark.parametrize("seed,usable", [(0, 5), (1, 8), (2, 12)])
def test_cancel_interleaving_matches_the_reference(seed, usable):
    """Three fixed interleavings through both packages' schedulers: the
    invariants hold, and the ledgers, cache pages and counters agree after
    every operation."""
    assert _cancel_interleaving(kv, sched, pc, seed, usable) == \
        _cancel_interleaving(jkv, jsched, jpc, seed, usable)
