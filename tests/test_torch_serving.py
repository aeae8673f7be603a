"""The port's monolithic and dense chunked engines against the JAX
package's, and the compiled-step contract of all three step families.

- The same request trace (reduced SmolLM2, float32, the reference's
  parameters) through the JAX ``Engine`` and the port's
  ``Engine(device="cpu")``, monolithic (no ``chunk_tokens``) and dense
  chunked (``flat=False``), with an ample pool, an undersized one that
  preempts and pauses, and eager full-lifetime reservation: identical
  tokens, finish reasons, preemptions, pauses, per-request
  ``chunk_steps``, mixed steps and prefill tokens.
- flat = dense chunked = monolithic inside the port, in the reference's
  own setup (``tests/test_flat_step.py``).
- For each family, alone and with speculation or the prefix cache,
  ``stats()["compiles"]`` does not move during a drain after
  ``warmup()``, and equals the JAX engine's on the same configuration
  (fresh models on both sides: the counts are per model); a second
  engine's warmup over the same model adds nothing to them, as in the
  JAX package.
- The chunk ladder and the prefill buckets are the reference's.
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
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 3, "decode")


def _jmodel():
    cfg = jreduced(jget_config("smollm2-135m"), layers=2)
    return jbuild_model(cfg, JRun(**F32), JShape(*SHAPE))


def _model():
    cfg = reduced_config(get_config("smollm2-135m"), layers=2)
    return build_model(cfg, RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")


@pytest.fixture(scope="module")
def models():
    jm = _jmodel()
    jparams = jm.init(jax.random.PRNGKey(0))
    return jm, jparams, _model(), from_jax_params(jax.tree.map(np.asarray, jparams))


def _trace(lens, news, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 512, n).astype(np.int32), k)
            for n, k in zip(lens, news)]


def _drain(eng, reqs):
    rids = [eng.add_request(p, n) for p, n in reqs]
    fin = {r.rid: r for r in eng.drain()}
    assert sorted(fin) == sorted(rids)
    return [fin[r] for r in rids]


FAMILIES = {"monolithic": {},
            "dense": dict(chunk_tokens=8, token_budget=20, flat=False)}
TIGHT = _trace([4, 25, 6, 30, 4, 5], [16, 10, 16, 8, 16, 16], seed=3)
CASES = {
    "ample": (dict(), _trace([13, 21, 3, 16, 30], [8, 6, 10, 7, 5], seed=1)),
    "tight": (dict(num_pages=1 + 6), TIGHT),
    "eager": (dict(num_pages=1 + 6, eager=True), TIGHT),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("family", list(FAMILIES))
def test_engine_matches_jax(models, family, case):
    jm, jparams, m, params = models
    kw = dict(max_slots=3, page_tokens=8, **FAMILIES[family], **CASES[case][0])
    reqs = CASES[case][1]
    jeng = JEngine(jm, jparams, **kw)
    eng = Engine(m, params, device="cpu", **kw)
    assert (eng.flat, eng.chunked) == (jeng.flat, jeng.chunked) == \
        (False, family == "dense")
    got, want = _drain(eng, reqs), _drain(jeng, reqs)
    assert [(r.out_tokens, r.finish_reason, r.chunk_steps, r.num_preemptions,
             r.num_pauses) for r in got] == \
        [(r.out_tokens, r.finish_reason, r.chunk_steps, r.num_preemptions,
          r.num_pauses) for r in want]
    st, jst = eng.stats(), jeng.stats()
    for key in ("steps", "mixed_steps", "prefill_stall_steps",
                "chunks_per_prompt", "finished", "finished_served",
                "num_preemptions", "num_pauses", "prefill_tokens",
                "mean_slot_occupancy"):
        assert st[key] == jst[key], key
    assert eng.pool.num_used == 0
    assert eng.pool.total_allocs == eng.pool.total_frees
    if case == "tight":
        assert eng.num_preemptions + eng.num_pauses >= 1
    if case == "eager":
        assert eng.num_preemptions == eng.num_pauses == 0


def test_flat_matches_dense_and_monolithic(models):
    """The reference's identity (``tests/test_flat_step.py``), inside the
    port: same prompts, three engines, one token stream."""
    _, _, m, params = models
    reqs = _trace([13, 21, 3, 16], [8, 6, 10, 7], seed=1)
    kw = dict(device="cpu", max_slots=3)
    mono = [r.out_tokens for r in _drain(Engine(m, params, **kw), reqs)]
    chunk = dict(page_tokens=8, chunk_tokens=16, token_budget=24)
    flat = Engine(m, params, **kw, **chunk)
    dense = Engine(m, params, **kw, **chunk, flat=False)
    assert flat.flat and not dense.flat
    assert [r.out_tokens for r in _drain(flat, reqs)] == mono
    assert [r.out_tokens for r in _drain(dense, reqs)] == mono


WARM = {"flat": dict(chunk_tokens=16, token_budget=24),
        "dense": dict(chunk_tokens=8, flat=False),
        "monolithic": {}}
EXTRA = {"plain": {}, "spec": dict(spec_tokens=2), "prefix": dict(prefix_cache=True)}


@pytest.mark.parametrize("extra", list(EXTRA))
@pytest.mark.parametrize("family", list(WARM))
def test_no_compiles_after_warmup(models, family, extra):
    """warmup() makes every program a drain with admissions, chunked
    prefills, growth, pauses and preemptions needs (with speculation its
    verify shapes, with the prefix cache its hits and copies); the counts
    equal the reference's on fresh models of both packages."""
    _, jparams, _, params = models
    kw = dict(max_slots=3, page_tokens=8, num_pages=1 + 6, **WARM[family],
              **EXTRA[extra])
    reqs = _trace([4, 25, 6, 30], [16, 10, 16, 8], seed=3)
    counts = []
    for eng in (Engine(_model(), params, device="cpu", **kw),
                JEngine(_jmodel(), jparams, **kw)):
        eng.warmup()
        before = eng.stats()["compiles"]
        assert eng.pool.num_used == 0 and eng.pool.total_allocs == 0
        _drain(eng, reqs)
        assert eng.num_preemptions + eng.num_pauses >= 1
        assert eng.stats()["compiles"] == before
        counts.append(before)
    assert counts[0] == counts[1]
    assert counts[0][{"flat": "flat"}.get(family, "paged")] > 0


@pytest.mark.parametrize("family", list(WARM))
def test_second_engine_adds_no_signature(models, family):
    """Signatures are counted per model: a second warmed engine over the
    same model leaves trace_counts where the first left them (the JAX
    package's jitted steps are cached per model too), and on the CPU no
    engine captures a graph."""
    _, _, _, params = models
    model = _model()
    kw = dict(device="cpu", max_slots=3, page_tokens=8, **WARM[family])
    first = Engine(model, params, **kw)
    first.warmup()
    counts = dict(model.trace_counts)
    second = Engine(model, params, spec_tokens=2, **kw)
    second.warmup()
    verify = dict(model.trace_counts)
    assert verify != counts
    Engine(model, params, **kw).warmup()
    Engine(model, params, spec_tokens=2, prefix_cache=True, **kw).warmup()
    assert dict(model.trace_counts) == verify
    assert second.stats()["captures"] == {"decode": 0, "paged": 0, "flat": 0}


@pytest.mark.parametrize("chunk", [8, 16, 40, 64])
def test_ladders_match_jax(models, chunk):
    jm, jparams, m, params = models
    kw = dict(max_slots=3, page_tokens=8, chunk_tokens=chunk, flat=False)
    eng, jeng = Engine(m, params, device="cpu", **kw), JEngine(jm, jparams, **kw)
    assert eng._chunk_shapes() == jeng._chunk_shapes()
    assert [eng._chunk_shape(n) for n in range(1, chunk + 1)] == \
        [jeng._chunk_shape(n) for n in range(1, chunk + 1)]
    mono, jmono = (Engine(m, params, device="cpu", max_slots=3),
                   JEngine(jm, jparams, max_slots=3))
    assert [mono._prefill_bucket(n) for n in range(1, 70)] == \
        [jmono._prefill_bucket(n) for n in range(1, 70)]


@pytest.mark.parametrize("extra", list(EXTRA) + ["draft"])
def test_dropped_model_is_freed_at_once(models, extra):
    """A model holds its compiled steps and they hold it only weakly: once
    its engines are dropped it is freed by reference counting, never left
    for the cyclic collector (which on the card could run inside another
    model's capture and free device memory there).  An engine with the
    prefix cache or a drafter holds no cycle either (the pool holds its
    cache's reclaimer weakly)."""
    import gc
    import weakref

    from repro_torch.serving.speculative import DraftModelDrafter
    _, _, _, params = models
    model = _model()
    kw = dict(EXTRA.get(extra, {}))
    if extra == "draft":
        kw = dict(spec_tokens=2, drafter=DraftModelDrafter(_model(), params))
    eng = Engine(model, params, device="cpu", max_slots=3, **kw)
    eng.warmup()
    ref = weakref.ref(model)
    gc.disable()
    try:
        del eng, model
        assert ref() is None
    finally:
        gc.enable()
