"""The port's page sharing and prefix cache against the JAX package's.

- Allocator cases on the port's pool: refcounts (``share``/``free``,
  pages back on the free list at zero), the double free, a free of the
  trash page or a page outside the pool, sharing a dead page, copy-on-
  write and a rollback that never truncates into a shared page.
- The hash-chain cache: the longest-prefix lookup capped at the last
  prompt token, layout-rooted keys, LRU eviction under pool pressure that
  spares pages in use.
- One seeded admit / chunk / grow (speculative asks) / rollback / finish /
  evict sequence drives both packages' schedulers, pools and caches, and
  their block tables, refcounts, free lists and cache pages agree after
  every operation (chunked and monolithic, pools small enough to preempt
  and reclaim).
- The device page copy writes in place: the pools keep their storage.
- Engines with the cache on give the cache-off tokens and the JAX engine's
  with the cache on, in each family, greedy and sampled, at most half the
  prefill tokens on a shared-system-prompt trace, with the JAX engine's
  cache counters; a fully cached prompt copies its last page; a preempted
  request resumes from the cache as the JAX engine's does.
"""

import random

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
from repro.serving import prefix_cache as jpc
from repro.serving import scheduler as jsched
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.models.model import build_model
from repro_torch.serving import kv_cache as kv
from repro_torch.serving import prefix_cache as pc
from repro_torch.serving import scheduler as sched
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 96, 3, "decode")


def _tok(n, seed=0):
    return np.random.default_rng(seed).integers(0, 64, n).astype(np.int32)


# ---------------------------------------------------------------------------
# the allocator
# ---------------------------------------------------------------------------

def test_pool_refuses_double_free_and_foreign_pages():
    pool = kv.PagedKVPool(1 + 4, 8)
    seq = kv.SequencePages(pool, owner=7)
    seq.ensure(16)
    p, q = seq.pages
    with pytest.raises(kv.PoolError, match="page 0 freed"):
        pool.free([0])
    with pytest.raises(kv.PoolError, match="outside"):
        pool.free([5])
    pool.free([q])
    with pytest.raises(kv.PoolError, match=r"freed twice.*\[7\]"):
        pool.free([q])                  # seq still lists it: a double free
    with pytest.raises(kv.PoolError, match="shared while not allocated"):
        pool.share([q])
    seq.pages = [p]
    seq.release()
    assert pool.num_used == 0 and pool.total_allocs == pool.total_frees == 2
    with pytest.raises(kv.PoolError, match="freed twice"):
        seq.pages = [p]
        seq.release()


def test_refcount_share_free_balance():
    pool = kv.PagedKVPool(1 + 4, 8)
    p = pool.alloc()
    assert pool.ref(p) == 1 and not pool.is_shared(p)
    pool.share([p, p])
    assert pool.ref(p) == 3 and pool.is_shared(p)
    pool.free([p])
    assert pool.ref(p) == 2 and pool.num_used == 1
    pool.free([p, p])
    assert pool.ref(p) == 0 and pool.num_used == 0
    with pytest.raises(kv.PoolError):
        pool.free([p])
    assert pool.total_allocs + pool.total_shares == pool.total_frees == 3
    assert pool.ledger() == {"refs": {}, "free": [4, 3, 2, 1]}


def test_cow_and_truncate_never_write_a_shared_page():
    pool = kv.PagedKVPool(1 + 6, 8)
    copies = []
    pool.page_copier = lambda src, dst: copies.append((src, dst))
    seq = kv.SequencePages(pool)
    seq.ensure(3 * 8)
    assert pool.cow(seq, 0) == seq.pages[0] and not copies    # unshared
    before = list(seq.pages)
    pool.share(before)                                         # all shared
    assert seq.truncate(16) == 1 and seq.pages == before[:2]
    assert seq.truncate(12) == 0                               # mid-page
    assert seq.pages[0] == before[0] and seq.pages[1] != before[1]
    assert copies == [(before[1], seq.pages[1])] and pool.cow_copies == 1
    assert pool.ref(before[1]) == 1 and pool.ref(seq.pages[1]) == 1

    def failing(src, dst):
        raise RuntimeError("device copy failed")

    pool.page_copier = failing
    pool.share([seq.pages[0]])
    free = pool.num_free
    with pytest.raises(kv.PoolError, match="page_copier failed"):
        pool.cow(seq, 0)
    assert pool.num_free == free and seq.pages[0] == before[0]
    pool.free([before[0]])
    seq.release()
    pool.free(before)
    assert pool.num_used == 0
    assert pool.total_allocs + pool.total_shares == pool.total_frees


def test_lookup_caps_at_the_last_token_and_layout_roots_the_chain():
    pool = kv.PagedKVPool(1 + 8, 8)
    cache = pc.PrefixCache(pool, layout_key=(4,))
    other = pc.PrefixCache(pool, layout_key=(8,))
    pool.reclaimer = cache
    prompt = _tok(24)
    seq = kv.SequencePages(pool)
    seq.ensure(24)
    assert cache.insert(prompt, seq.pages, 24) == 3
    div = prompt.copy()
    div[20] += 1
    pages, hit = cache.lookup(div)
    assert hit == 16 and pages == seq.pages[:2]
    pool.free(pages)
    pages, hit = cache.lookup(prompt)
    assert hit == 23 and pages == seq.pages
    pool.free(pages)
    pages, hit = cache.lookup(np.concatenate([prompt, _tok(5, seed=9)]))
    assert hit == 24
    pool.free(pages)
    assert other.lookup(prompt) == ([], 0)
    seq.release()
    assert cache.clear() == 3 and pool.num_used == 0
    assert pool.total_allocs + pool.total_shares == pool.total_frees


def test_eviction_lru_under_pool_pressure_pins_in_use_pages():
    pool = kv.PagedKVPool(1 + 4, 8)
    cache = pc.PrefixCache(pool, layout_key=(4,))
    old, new = _tok(8, seed=1), _tok(8, seed=2)
    s1, s2 = kv.SequencePages(pool), kv.SequencePages(pool)
    s1.ensure(8)
    cache.insert(old, s1.pages, 8)
    pinned = s1.pages[0]
    s2.ensure(8)
    cache.insert(new, s2.pages, 8)
    s2.release()
    assert cache.evictable() == 1 and pool.num_available == 3
    s3 = kv.SequencePages(pool)
    s3.ensure(3 * 8)                                 # evicts `new`
    assert cache.evictions == 1 and cache.lookup(new) == ([], 0)
    assert pool.ref(pinned) == 2
    with pytest.raises(kv.OutOfPages):
        s3.ensure(4 * 8)
    s1.release()
    s3.release()
    cache.clear()
    assert pool.num_used == 0
    assert pool.total_allocs + pool.total_shares == pool.total_frees


def test_copy_pages_writes_the_pools_in_place():
    caches = {"p0": {"kv": {"k_pages": torch.randn(2, 5, 4, 3, 8),
                            "v_pages": torch.randn(2, 5, 4, 3, 8)}}}
    pools = caches["p0"]["kv"]
    ptrs = {k: t.data_ptr() for k, t in pools.items()}
    want = {k: t.clone() for k, t in pools.items()}
    kv.copy_pages(caches, torch.tensor([3]), torch.tensor([1]))
    for k, t in pools.items():
        assert t.data_ptr() == ptrs[k]
        want[k][:, 1] = want[k][:, 3]
        assert torch.equal(t, want[k])


# ---------------------------------------------------------------------------
# both packages driven by one seeded sequence
# ---------------------------------------------------------------------------

PKGS = {"port": (kv, pc, sched), "jax": (jkv, jpc, jsched)}


def _state(s, pool, cache):
    reqs = sorted(list(s.running.values()) + list(s.waiting), key=lambda r: r.rid)
    return ([(r.rid, r.status, r.slot, None if r.pages is None else list(r.pages.pages),
              r.prefill_cursor, r.len, list(r.out_tokens), r.prompt.tolist())
             for r in reqs],
            pool.ledger(), sorted(cache.pages()),
            (s.num_preemptions, s.num_pauses, s.spec_grow_fallbacks, s.resumes,
             s.resume_recompute_tokens, pool.cow_copies))


def _drive(pkg, seed, chunk, pages):
    """One seeded run of add / admit / chunk / grow / rollback / finish /
    evict over one package; returns its state after every operation."""
    kvm, pcm, sm = PKGS[pkg]
    rng = random.Random(seed)
    pool = kvm.PagedKVPool(1 + pages, 8)
    pool.page_copier = lambda src, dst: None
    cache = pcm.PrefixCache(pool, layout_key=(8,))
    s = sm.Scheduler(3, pool, 64, chunk_tokens=chunk, chunk_align=8,
                     prefix_cache=cache)
    shared = _tok(24, seed=seed)
    trace, rid = [], 0
    for _ in range(120):
        op = rng.choice(["add", "admit", "chunk", "chunk", "grow", "grow",
                         "grow", "finish", "evict"])
        if op == "add" and len(s.waiting) < 4:
            n = rng.randrange(3, 30)
            kind = rng.random()
            if kind < 0.3:                   # whole pages all cached: a copy
                prompt = shared[:rng.choice([8, 16, 24])].copy()
            elif kind < 0.7:
                prompt = np.concatenate([shared, _tok(n, seed=rid + 100)])[:n]
            else:
                prompt = _tok(n, seed=rid + 200)
            s.add(sm.Request(rid=rid, prompt=prompt, max_new=rng.randrange(2, 12)))
            rid += 1
        elif op == "admit":
            for r in s.admit(limit=None if chunk else 1):
                if chunk is None:           # monolithic: the prefill runs now
                    r.prefill_cursor = r.len = r.prompt_len
                    cache.insert(r.prompt, r.pages.pages, r.prompt_len)
                    r.out_tokens.append(rng.randrange(64))
        elif op == "chunk" and chunk:
            for slot, n in s.plan_chunks(rng.randrange(8, 33)).items():
                r = s.running.get(slot)
                if r is None or n == 0:
                    continue
                r.prefill_cursor += n
                r.len = r.prefill_cursor
                cache.insert(r.prompt, r.pages.pages, r.prefill_cursor)
                if r.prefill_cursor == r.prompt_len:
                    r.status = "running"
                    r.out_tokens.append(rng.randrange(64))
        elif op == "grow":
            want = {slot: rng.randrange(1, 4) for slot in s.running}
            s.grow(want=want)
            for r in list(s.running.values()):
                if r.status != "running":
                    continue
                n = min(want.get(r.slot, 1), r.pages.capacity - r.len)
                keep = rng.randrange(1, n + 1)       # accepted + the pick
                r.out_tokens.extend(rng.randrange(64) for _ in range(keep))
                r.len += keep
                r.pages.truncate(r.len)
                if r.done():
                    s.finish(r)
        elif op == "finish" and s.running:
            r = rng.choice(list(s.running.values()))
            if r.status == "running":
                s.finish(r)
        elif op == "evict":
            cache.evict(rng.randrange(1, 3))
        trace.append((op, _state(s, pool, cache)))
    return trace


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("chunk,pages", [(8, 6), (16, 8), (None, 6)],
                         ids=["chunk8", "chunk16", "monolithic"])
def test_one_seeded_sequence_drives_both_packages_alike(seed, chunk, pages):
    got, want = _drive("port", seed, chunk, pages), _drive("jax", seed, chunk, pages)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a == b, f"operation {i} ({a[0]}) parts the packages"
    assert len(got) == len(want)


@pytest.mark.parametrize("chunk,pages", [(8, 6), (16, 8), (None, 6)],
                         ids=["chunk8", "chunk16", "monolithic"])
def test_seeded_sequences_preempt_resume_and_copy(chunk, pages):
    """Over their six seeds the sequences above preempt, resume from the
    cache, shed speculative asks and copy shared pages."""
    totals = np.zeros(6, int)
    for seed in range(6):
        totals += _drive("port", seed, chunk, pages)[-1][1][3]
    preempted, _, shed, resumes, _, copies = totals
    assert preempted and shed and resumes and copies, totals


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    jcfg = jreduced(jget_config("smollm2-135m"), layers=2)
    jm = jbuild_model(jcfg, JRun(**F32), JShape(*SHAPE))
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = reduced_config(get_config("smollm2-135m"), layers=2)
    m = build_model(cfg, RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    return jm, jparams, m, from_jax_params(jax.tree.map(np.asarray, jparams))


def _shared_prefix_trace(n=6, sys_tokens=40):
    rng = np.random.default_rng(3)
    sysp = rng.integers(0, 512, sys_tokens).astype(np.int32)
    return [(np.concatenate([sysp, rng.integers(0, 512, 3 + i % 3).astype(np.int32)]),
             5 + i % 3) for i in range(n)]


def _drain_staggered(eng, reqs, greedy=True, seed=0):
    for i, (p, n) in enumerate(reqs):
        eng.add_request(p, n, arrival=float(2 * i),
                        temperature=(1.0, 0.7, 0.0)[i % 3])
    clock, fin = 0.0, {}
    while eng.scheduler.has_work:
        fin.update((r.rid, r.out_tokens)
                   for r in eng.step(now=clock, greedy=greedy, seed=seed))
        clock += 1.0
    return [fin[i] for i in sorted(fin)]


FAMILIES = {"flat": dict(chunk_tokens=16), "dense": dict(chunk_tokens=16, flat=False),
            "monolithic": {}}


@pytest.mark.parametrize("greedy", [True, False], ids=["greedy", "sampled"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_cache_on_matches_cache_off_and_jax(models, family, greedy):
    jm, jparams, m, params = models
    reqs = _shared_prefix_trace()
    kw = dict(max_slots=3, page_tokens=16, **FAMILIES[family])
    base = Engine(m, params, device="cpu", **kw)
    want = _drain_staggered(base, reqs, greedy, seed=7)
    eng = Engine(m, params, device="cpu", prefix_cache=True, **kw)
    jeng = JEngine(jm, jparams, prefix_cache=True, **kw)
    assert _drain_staggered(eng, reqs, greedy, seed=7) == want
    assert _drain_staggered(jeng, reqs, greedy, seed=7) == want
    st, jst = eng.stats(), jeng.stats()
    off = base.stats()["prefill_tokens"]
    assert off == sum(p.shape[0] for p, _ in reqs)
    assert st["prefill_tokens"] == jst["prefill_tokens"] <= 0.5 * off
    assert st["prefix_cache"] == jst["prefix_cache"]
    assert st["prefix_cache"]["hits"] >= len(reqs) - 1
    eng.prefix_cache.clear()
    assert eng.pool.num_used == 0 and eng.pool.ledger()["refs"] == {}
    assert eng.pool.total_allocs + eng.pool.total_shares == eng.pool.total_frees


@pytest.mark.parametrize("family", list(FAMILIES))
def test_fully_cached_prompt_copies_its_last_page(models, family):
    """A page-aligned prompt cached whole restarts at its last position,
    inside the last shared page: the page is copied on the device first,
    and the tokens do not change."""
    _, _, m, params = models
    p32 = np.random.default_rng(5).integers(0, 512, 32).astype(np.int32)
    kw = dict(device="cpu", max_slots=2, page_tokens=16, **FAMILIES[family])
    base = Engine(m, params, **kw)
    base.add_request(p32, 5)
    base.add_request(p32, 5)
    want = [r.out_tokens for r in sorted(base.drain(), key=lambda r: r.rid)]
    eng = Engine(m, params, prefix_cache=True, **kw)
    eng.add_request(p32, 5)
    while eng.stats()["prefix_cache"]["inserted_pages"] < 2:
        eng.step()                       # the first request's prefill
    eng.add_request(p32, 5)
    fin = {r.rid: r.out_tokens for r in eng.drain()}
    assert [fin[0], fin[1]] == want
    st = eng.stats()["prefix_cache"]
    assert st["cow_copies"] == 1 and st["hit_tokens"] == 31
    eng.prefix_cache.clear()
    assert eng.pool.num_used == 0


def test_preempt_resume_recomputes_only_the_uncached_suffix(models):
    jm, jparams, m, params = models
    prompts = [np.random.default_rng(11 + i).integers(0, 512, n).astype(np.int32)
               for i, n in enumerate([6, 5])]
    kw = dict(max_slots=2, page_tokens=8, num_pages=1 + 4, prefix_cache=True)
    engs = [Engine(m, params, device="cpu", **kw), JEngine(jm, jparams, **kw)]
    outs = []
    for eng in engs:
        for p in prompts:
            eng.add_request(p, 12)
        outs.append({r.rid: r.out_tokens for r in eng.drain()})
    ample = Engine(m, params, device="cpu", max_slots=2, page_tokens=8)
    for p in prompts:
        ample.add_request(p, 12)
    assert outs[0] == outs[1] == {r.rid: r.out_tokens for r in ample.drain()}
    port, ref = engs
    assert port.num_preemptions >= 1
    assert list(port.scheduler.resume_events) == list(ref.scheduler.resume_events)
    assert any(not e["reclaimed"] and not e["evicted"]
               and e["recompute"] <= e["generated_since"] + 8
               for e in port.scheduler.resume_events)
    port.prefix_cache.clear()
    assert port.pool.num_used == 0
    assert port.pool.total_allocs + port.pool.total_shares == port.pool.total_frees


def test_prefix_cache_refuses_eager_reservation(models):
    _, _, m, params = models
    with pytest.raises(ValueError, match="lazy allocation"):
        Engine(m, params, device="cpu", eager=True, prefix_cache=True)
