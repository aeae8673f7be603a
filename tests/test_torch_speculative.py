"""The port's speculative decode against the JAX package's.

- Units, on both packages where the reference has them: the acceptance
  rule, the n-gram drafter, the fold-invariant request context, the
  rollback by ``SequencePages.truncate``, and ``Scheduler.grow(want=)``
  shedding a speculative ask rather than displacing a row.
- Drains with ``spec_tokens=2`` (the n-gram drafter, and a draft model
  attached to the engine) through each family, greedy and sampled: the
  port's tokens equal its own tokens without speculation and the JAX
  engine's with it, with the JAX engine's drafted and accepted counts.
- An oracle drafter (every draft right, ``k=5`` over 8-token pages: verify
  rows straddle pages) and an anti-oracle (every draft wrong: every
  verify rolls pages back) leave the tokens and the pool unchanged;
  speculation under preemption folds only accepted tokens.
- Constructor checks, and the standalone draft-model ``propose`` (the
  dense decode step) drafting from its own dense cache (its parity with
  the reference is in tests/test_torch_static.py).
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models.model import build_model as jbuild_model
from repro.serving import kv_cache as jkv
from repro.serving import scheduler as jsched
from repro.serving import speculative as jspec
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.models.model import build_model
from repro_torch.serving import kv_cache as kv
from repro_torch.serving import scheduler as sched
from repro_torch.serving import speculative as spec
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 3, "decode")
PKGS = {"port": (kv, sched, spec), "jax": (jkv, jsched, jspec)}


@pytest.mark.parametrize("pkg", list(PKGS))
def test_accept_rule(pkg):
    _, sm, spm = PKGS[pkg]

    def pick(row, req):
        return int(np.argmax(row))

    def logits(*winners):
        out = np.zeros((len(winners), 8), np.float32)
        out[np.arange(len(winners)), winners] = 1.0
        return out

    def req(rid, eos=None):
        return sm.Request(rid=rid, prompt=np.zeros(2, np.int32), max_new=10,
                          eos_id=eos)

    r = req(0)
    assert spm.accept_tokens(r, [3, 5], logits(3, 5, 6), 3, pick) == (3, 2)
    assert r.out_tokens == [3, 5, 6]
    r = req(1)
    assert spm.accept_tokens(r, [2, 4], logits(2, 7, 6), 3, pick) == (2, 1)
    assert r.out_tokens == [2, 7]
    r = req(2, eos=5)
    assert spm.accept_tokens(r, [3, 5], logits(3, 5, 6), 3, pick) == (2, 2)
    assert r.out_tokens == [3, 5] and r.finish_reason == "eos"
    r = req(3)
    assert spm.accept_tokens(r, [], logits(4), 1, pick) == (1, 0)
    with pytest.raises(ValueError):
        spm.accept_tokens(req(4), [1], logits(1, 2), 3, pick)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_ngram_drafter_and_fold_invariant_context(pkg):
    _, sm, spm = PKGS[pkg]
    d = spm.NgramDrafter(max_ngram=3)

    def req(prompt, out=(), folded=0):
        r = sm.Request(rid=0, prompt=np.asarray(prompt, np.int32), max_new=10)
        r.out_tokens, r.folded = list(out), folded
        return r

    assert d.propose(req([1, 2, 3, 9, 1, 2, 3]), 2) == [9, 1]
    assert d.propose(req([7, 4, 7, 5, 7]), 2) == [5, 7]
    assert d.propose(req([3, 4], [5, 3, 4]), 3) == [5, 3, 4]
    assert d.propose(req([1, 2, 3, 4, 5]), 2) == []
    assert d.stats()["misses"] == 1 and d.stats()["proposals"] == 3
    r = req([1, 2, 3, 7, 8], [7, 8, 9], folded=2)
    assert spm.request_context(r).tolist() == [1, 2, 3, 7, 8, 9]
    assert d.propose(req([1, 2, 9, 1, 2], [1, 2], folded=2), 2) == [9, 1]


def test_truncate_rolls_whole_pages_back():
    pool = kv.PagedKVPool(1 + 6, 8)
    seq = kv.SequencePages(pool)
    seq.ensure(20)
    assert seq.truncate(17) == 0 and seq.truncate(9) == 1
    assert len(seq.pages) == 2 and pool.num_used == 2
    assert seq.truncate(0) == 2 and pool.num_used == 0
    seq.ensure(48)
    seq.release()
    assert pool.num_used == 0 and pool.total_allocs == pool.total_frees


@pytest.mark.parametrize("pages,lens,want_caps,shed", [
    (5, (14, 16), (16, 24), 1),      # the older ask would take the younger's page
    (6, (14, 16), (24, 24), 0),      # room for both
    (5, (9, 16), (16, 24), 0),       # the ask fits the held pages' slack
], ids=["shed", "granted", "slack"])
def test_grow_sheds_a_speculative_ask_rather_than_displace(pages, lens, want_caps,
                                                           shed):
    for pkg in PKGS:
        kvm, sm, _ = PKGS[pkg]
        pool = kvm.PagedKVPool(1 + pages, 8)
        s = sm.Scheduler(max_slots=2, pool=pool, max_len=64)
        a = sm.Request(rid=0, prompt=np.zeros(8, np.int32), max_new=30)
        b = sm.Request(rid=1, prompt=np.zeros(8, np.int32), max_new=30)
        s.add(a)
        s.add(b)
        assert len(s.admit()) == 2
        for r, n in zip((a, b), lens):
            r.len, r.out_tokens = n, [1] * (n - 7)
            r.pages.ensure(16)
        assert s.grow(want={a.slot: 3, b.slot: 1}) == []
        assert s.num_preemptions == 0 and s.spec_grow_fallbacks == shed, pkg
        assert (a.pages.capacity, b.pages.capacity) == want_caps, pkg


@pytest.fixture(scope="module")
def models():
    jm = jbuild_model(jreduced(jget_config("smollm2-135m"), layers=2), JRun(**F32),
                      JShape(*SHAPE))
    jparams = jm.init(jax.random.PRNGKey(0))
    m = build_model(reduced_config(get_config("smollm2-135m"), layers=2),
                    RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    djm = jbuild_model(jreduced(jget_config("smollm2-135m"), layers=1), JRun(**F32),
                       JShape(*SHAPE))
    djparams = djm.init(jax.random.PRNGKey(3))
    dm = build_model(reduced_config(get_config("smollm2-135m"), layers=1),
                     RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    return (jm, jparams, m, from_jax_params(jax.tree.map(np.asarray, jparams)),
            djm, djparams, dm, from_jax_params(jax.tree.map(np.asarray, djparams)))


REQS = [(np.random.default_rng(i).integers(0, 512, n).astype(np.int32), k)
        for i, (n, k) in enumerate(zip([5, 11, 8, 3], [16, 12, 20, 14]))]
FAMILIES = {"flat": dict(chunk_tokens=8), "dense": dict(chunk_tokens=8, flat=False),
            "monolithic": {}}


def _drain(eng, greedy, reqs=REQS):
    rids = [eng.add_request(p, n, temperature=(1.0, 0.7)[i % 2])
            for i, (p, n) in enumerate(reqs)]
    fin = {r.rid: r for r in eng.drain(greedy=greedy, seed=7)}
    return [fin[r].out_tokens for r in rids]


@pytest.fixture(scope="module")
def baselines(models):
    _, _, m, params = models[:4]
    return {(fam, greedy): _drain(Engine(m, params, device="cpu", max_slots=3,
                                         **kw), greedy)
            for fam, kw in FAMILIES.items() for greedy in (True, False)}


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("drafter", ["ngram", "draft"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_spec_matches_spec_off_and_jax(models, baselines, family, drafter, greedy):
    jm, jparams, m, params, djm, djparams, dm, dparams = models
    kw = dict(max_slots=3, spec_tokens=2, **FAMILIES[family])
    if drafter == "draft":
        eng = Engine(m, params, device="cpu",
                     drafter=spec.DraftModelDrafter(dm, dparams), **kw)
        jeng = JEngine(jm, jparams, drafter=jspec.DraftModelDrafter(djm, djparams),
                       **kw)
    else:
        eng, jeng = Engine(m, params, device="cpu", **kw), JEngine(jm, jparams, **kw)
    got = _drain(eng, greedy)
    assert got == baselines[(family, greedy)]
    assert _drain(jeng, greedy) == got
    st, jst = eng.stats()["speculative"], jeng.stats()["speculative"]
    for key in ("drafted", "accepted", "spec_trims", "spec_grow_fallbacks",
                "rollback_pages", "decode_tokens_per_row_step"):
        assert st[key] == jst[key], key
    assert st["drafted"] > 0
    if drafter == "draft":
        assert st["drafter"]["live_states"] == 0          # forget() on finish
        assert st["drafter"]["draft_steps"] == jst["drafter"]["draft_steps"]
    assert eng.pool.num_used == 0 and eng.pool.total_allocs == eng.pool.total_frees


class OracleDrafter(spec.Drafter):
    """Proposes the baseline's own continuation (all accepted), or with
    ``offset`` the baseline's tokens shifted (none accepted)."""

    def __init__(self, outs, offset=0):
        self.outs, self.offset = outs, offset

    def propose(self, req, k):
        done = len(req.out_tokens)
        return [(t + self.offset) % 512 for t in self.outs[req.rid][done:done + k]]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_oracle_and_anti_oracle_keep_the_tokens(models, baselines, family):
    _, _, m, params = models[:4]
    want = baselines[(family, True)]
    outs = dict(enumerate(want))
    kw = dict(device="cpu", max_slots=3, page_tokens=8, spec_tokens=5,
              **FAMILIES[family])
    oracle = Engine(m, params, drafter=OracleDrafter(outs), **kw)
    assert _drain(oracle, True) == want
    st = oracle.stats()["speculative"]
    assert st["acceptance_rate"] == 1.0 and st["decode_tokens_per_row_step"] > 1.0
    anti = Engine(m, params, drafter=OracleDrafter(outs, offset=1), **kw)
    assert _drain(anti, True) == want
    st = anti.stats()["speculative"]
    assert st["drafted"] > 0 and st["accepted"] == 0 and st["rollback_pages"] > 0
    for eng in (oracle, anti):
        assert eng.pool.num_used == 0
        assert eng.pool.total_allocs == eng.pool.total_frees


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
def test_spec_under_preemption_folds_only_accepted_tokens(models, greedy):
    jm, jparams, m, params = models[:4]
    reqs = [(p, 12) for p, _ in REQS[:2]]
    want = _drain(Engine(m, params, device="cpu", max_slots=2, page_tokens=8),
                  greedy, reqs)
    kw = dict(max_slots=2, page_tokens=8, num_pages=1 + 4, spec_tokens=2)
    tight = Engine(m, params, device="cpu", **kw)
    rids = [tight.add_request(p, n, temperature=(1.0, 0.7)[i % 2])
            for i, (p, n) in enumerate(reqs)]
    fin = {r.rid: r for r in tight.drain(greedy=greedy, seed=7)}
    assert [fin[r].out_tokens for r in rids] == want
    assert _drain(JEngine(jm, jparams, **kw), greedy, reqs) == want
    assert tight.num_preemptions >= 1 and tight.pool.num_used == 0
    assert tight.pool.total_allocs == tight.pool.total_frees
    for rid, (p, _) in zip(rids, reqs):
        folded = fin[rid].prompt.tolist()
        assert folded[:len(p)] == p.tolist()
        assert folded[len(p):] == want[rid][:len(folded) - len(p)]


def test_spec_constructor_checks(models):
    jm, jparams, m, params, djm, djparams, dm, dparams = models
    with pytest.raises(ValueError, match="at least one draft"):
        Engine(m, params, device="cpu", spec_tokens=0)
    with pytest.raises(ValueError, match="drafter needs spec_tokens"):
        Engine(m, params, device="cpu", drafter=spec.NgramDrafter())
    with pytest.raises(ValueError, match="shape ladder"):
        Engine(m, params, device="cpu", chunk_tokens=8, spec_tokens=8)
    import dataclasses
    odd = build_model(dataclasses.replace(m.cfg, vocab=1024), RunConfig(**F32),
                      ShapeSpec(*SHAPE), device="cpu")
    with pytest.raises(ValueError, match="vocab"):
        Engine(m, params, device="cpu", spec_tokens=2,
               drafter=spec.DraftModelDrafter(odd, odd.init(torch.Generator())))
    d = spec.DraftModelDrafter(dm, dparams)
    r = sched.Request(rid=0, prompt=np.asarray([5, 9, 2, 7], np.int32), max_new=10)
    r.out_tokens = [3]
    jr = jsched.Request(rid=0, prompt=np.asarray([5, 9, 2, 7], np.int32),
                        max_new=10)
    jr.out_tokens = [3]
    assert d.propose(r, 2) == jspec.DraftModelDrafter(djm, djparams).propose(jr, 2)
