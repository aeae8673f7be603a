"""The port's static batch path against the JAX package's, on reduced
SmolLM2 in float32 with the reference's parameters.

- ``decode_step`` against a dense cache: a prefill then 4 decode steps,
  logits to 1e-5, with token embeddings and with the ``embeds`` override;
- ``init_cache`` and ``input_specs``: the JAX package's shapes and dtypes;
- ``Engine.generate_static``: greedy tokens equal to the JAX engine's;
  sampled picks equal apart from picks whose perturbed top-2 margin is
  below 1e-5; equal to the port's own ``generate()``, with the JAX
  package's ``trace_counts`` after the same calls and no new program on a
  second call;
- the standalone ``DraftModelDrafter.propose`` (dense per-request caches)
  against the reference's drafts over a reconcile sequence: a fresh
  context, a full commit, a partial reject, the re-feed of the final token
  when the cache covers the context, and a full reject;
- ``sampling.split`` and the batched ``sampling.categorical`` against
  ``jax.random`` (keys and uniforms bit for bit, the Gumbel noise to 2 ulp,
  picks under the margin rule).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models.model import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro.serving import scheduler as jsched
from repro.serving import speculative as jspec
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.models.model import build_model
from repro_torch.serving import sampling, scheduler as sched
from repro_torch.serving import speculative as spec
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 2, "decode")
MARGIN = 1e-5


def _pair(arch, layers, seed, shape=SHAPE):
    jm = jbuild_model(jreduced(jget_config(arch), layers=layers), JRun(**F32),
                      JShape(*shape))
    m = build_model(reduced_config(get_config(arch), layers=layers),
                    RunConfig(**F32), ShapeSpec(*shape), device="cpu")
    jparams = jm.init(jax.random.PRNGKey(seed))
    return jm, jparams, m, from_jax_params(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module")
def models():
    return _pair("smollm2-135m", 2, 0)


def _pos(p):
    return torch.tensor(p, dtype=torch.int32)


@pytest.mark.parametrize("embeds", [False, True], ids=["tokens", "embeds"])
def test_decode_step_matches_jax(models, embeds):
    jm, jparams, m, params = models
    rng = np.random.default_rng(4)
    b, plen, d = 2, 11, m.cfg.d_model
    tokens = rng.integers(0, m.cfg.vocab, (b, plen)).astype(np.int32)
    jc, c = jm.init_cache(b, 64), m.init_cache(b, 64)
    if embeds:
        e = rng.standard_normal((b, plen, d)).astype(np.float32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tokens), jnp.int32(0),
                                jnp.asarray(e))
        l, c = m.decode_step(params, c, torch.from_numpy(tokens), _pos(0),
                             torch.from_numpy(e))
    else:
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tokens), jnp.int32(0))
        l, c = m.decode_step(params, c, torch.from_numpy(tokens), _pos(0))
    assert l.shape == (b, plen, m.cfg.vocab)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    for i in range(4):
        t = rng.integers(0, m.cfg.vocab, (b, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(t), jnp.int32(plen + i))
        l, c = m.decode_step(params, c, torch.from_numpy(t), _pos(plen + i))
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    # the caches themselves, written in place on the port's side
    np.testing.assert_allclose(c["p0"]["kv"]["k"].numpy(),
                               np.asarray(jc["p0"]["kv"]["k"]), atol=1e-5, rtol=0)


def test_dense_write_clamps_like_dynamic_update_slice(models):
    """A write that would run past the cache starts at ``S_max - s``, as
    ``lax.dynamic_update_slice`` clamps it; the mask still reads
    ``pos + s`` positions."""
    jm, jparams, m, params = models
    tokens = np.arange(6, dtype=np.int32).reshape(2, 3)
    jc, c = jm.init_cache(2, 64), m.init_cache(2, 64)
    jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tokens), jnp.int32(62))
    l, c = m.decode_step(params, c, torch.from_numpy(tokens), _pos(62))
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(c["p0"]["kv"]["v"].numpy(),
                               np.asarray(jc["p0"]["kv"]["v"]), atol=1e-5, rtol=0)


def _spec_tree(tree):
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


@pytest.mark.parametrize("arch", ["smollm2-135m", "whisper-small"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_and_input_specs_match_jax(arch, dtype):
    run = dict(F32, param_dtype=dtype, compute_dtype=dtype)
    jm = jbuild_model(jreduced(jget_config(arch)), JRun(**run), JShape(*SHAPE))
    m = build_model(reduced_config(get_config(arch)), RunConfig(**run),
                    ShapeSpec(*SHAPE), device="cpu")
    assert (m.text_len, m.enc_len) == (jm.text_len, jm.enc_len)
    want = _spec_tree(jax.tree.map(np.asarray, jm.init_cache(3, 64)))
    assert _spec_tree(m.init_cache(3, 64)) == want

    def spec_of(t):
        if isinstance(t, dict):
            return {k: spec_of(v) for k, v in t.items()}
        assert t.is_meta
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""))

    for kind in ("train", "prefill", "decode"):
        want = jax.tree.map(lambda s: (tuple(s.shape), str(s.dtype)),
                            jm.input_specs(kind))
        assert spec_of(m.input_specs(kind)) == want, kind


def _margin_ok(jout, out, logits_fn):
    """Tokens equal, or parted first where the perturbed top-2 margin of
    the pick is below MARGIN (both runs then go their own ways)."""
    for r in range(out.shape[0]):
        diff = np.flatnonzero(jout[r] != out[r])
        if diff.size:
            assert logits_fn(r, int(diff[0])) < MARGIN, (r, diff[0])


def _batch(m, b=2, plen=8, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, m.cfg.vocab, (b, plen)).astype(np.int32)}


def test_generate_static_greedy_matches_jax(models):
    jm, jparams, m, params = models
    batch = _batch(m)
    want = JEngine(jm, jparams).generate_static(batch, 8)
    got = Engine(m, params, device="cpu").generate_static(batch, 8)
    assert got.dtype == np.int32 and got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)


def _static_margins(m, params, batch, max_new, seed):
    """The perturbed top-2 margin of every sampled pick of the port's
    static loop (row, step), recomputed from its own logits and keys."""
    eng = Engine(m, params, device="cpu")
    logits_seen = []
    step = eng._decode_step

    def recording(*a, **kw):
        out = step(*a, **kw)
        logits_seen.append(out[0][:, -1].float().numpy().copy())
        return out

    eng._decode_step = recording
    out = eng.generate_static(batch, max_new, greedy=False, seed=seed)
    key = sampling.prng_key(seed)
    margins = np.full(out.shape, np.inf)
    for i in range(1, max_new):
        key, sub = sampling.split(key)
        rows = logits_seen[i]
        pert = rows + sampling.gumbel(sub, rows.size).reshape(rows.shape)
        top = np.sort(pert, axis=-1)
        margins[:, i] = top[:, -1] - top[:, -2]
    return out, margins


@pytest.mark.parametrize("seed", [0, 5])
def test_generate_static_sampled_matches_jax(models, seed):
    """The first pick is the argmax even when sampled (as in the JAX
    package); the rest draw from one split key per step."""
    jm, jparams, m, params = models
    batch = _batch(m, b=3)
    want = JEngine(jm, jparams).generate_static(batch, 10, greedy=False,
                                                seed=seed)
    got, margins = _static_margins(m, params, batch, 10, seed)
    greedy = Engine(m, params, device="cpu").generate_static(batch, 10)
    np.testing.assert_array_equal(got[:, 0], greedy[:, 0])
    _margin_ok(want, got, lambda r, i: margins[r, i])
    assert not np.array_equal(got, greedy)


def test_generate_static_equals_generate_and_counts_like_jax():
    """The reference's continuous-vs-static contract, inside the port; the
    port's trace_counts move as the JAX package's over the same calls, and
    a second static call makes no new program."""
    jm, jparams, m, params = _pair("smollm2-135m", 2, 0)   # fresh counts
    batch = _batch(m)
    jeng, eng = JEngine(jm, jparams), Engine(m, params, device="cpu")
    for e in (jeng, eng):
        e.generate_static(batch, 6)
    assert m.trace_counts == jm.trace_counts
    assert m.trace_counts["decode"] == 2          # prefill [2, 8], decode [2, 1]
    s1 = eng.generate_static(batch, 6)
    s2 = jeng.generate_static(batch, 6)
    assert m.trace_counts == jm.trace_counts
    g1 = Engine(m, params, device="cpu").generate(batch, 6)
    g2 = JEngine(jm, jparams).generate(batch, 6)
    np.testing.assert_array_equal(s1, g1)
    np.testing.assert_array_equal(s1, s2)
    np.testing.assert_array_equal(g1, g2)
    assert m.trace_counts == jm.trace_counts
    assert m.trace_log[0]["args"]["token"] == ((2, 8), "torch.int32")
    assert m.trace_log[1]["args"]["pos"] == ((), "torch.int32")


def test_static_caches_are_reused_and_zeroed(models):
    """The engine keeps one dense cache per batch shape and zeroes it for
    each call, so a second batch decodes as if the first never ran."""
    _, _, m, params = models
    eng = Engine(m, params, device="cpu")
    a, b = _batch(m, seed=1), _batch(m, seed=2)
    want_b = Engine(m, params, device="cpu").generate_static(b, 5)
    eng.generate_static(a, 5)
    caches = eng._static_bufs[(2,)]
    ptr = caches["p0"]["kv"]["k"].data_ptr()
    np.testing.assert_array_equal(eng.generate_static(b, 5), want_b)
    assert eng._static_bufs[(2,)]["p0"]["kv"]["k"].data_ptr() == ptr
    eng.generate_static(_batch(m, b=3), 5)
    assert sorted(eng._static_bufs) == [(2,), (3,)]


# ---------------------------------------------------- the standalone drafter

@pytest.fixture(scope="module")
def drafters():
    jdm, jdparams, dm, dparams = _pair("smollm2-135m", 1, 3,
                                       shape=("serve", 64, 3, "decode"))
    return jdm, jdparams, dm, dparams


def test_standalone_propose_matches_jax(drafters):
    """A reconcile sequence through both packages' standalone drafters:
    fresh, full commit, partial reject, the final token re-fed (a shed
    draft whose token the target committed), full reject; every proposal,
    the draft step count and the decode programs agree."""
    jdm, jdparams, dm, dparams = drafters
    jd = jspec.DraftModelDrafter(jdm, jdparams)
    d = spec.DraftModelDrafter(dm, dparams)
    jr = jsched.Request(rid=0, prompt=np.asarray([5, 9, 2, 7, 11], np.int32),
                        max_new=40)
    r = sched.Request(rid=0, prompt=np.asarray([5, 9, 2, 7, 11], np.int32),
                      max_new=40)
    jr.out_tokens, r.out_tokens = [3], [3]
    k = 3
    first = d.propose(r, k)
    assert first == jd.propose(jr, k) and len(first) == k
    prev = first
    commits = [lambda p: list(p),                       # every draft kept
               lambda p: [p[0], (p[1] + 1) % 512],      # partial reject
               lambda p: [p[0]],                        # shed, same token
               lambda p: [(p[0] + 7) % 512]]            # full reject
    for commit in commits:
        toks = commit(prev)
        jr.out_tokens += toks
        r.out_tokens += toks
        prev = d.propose(r, k)
        assert prev == jd.propose(jr, k), commit
    assert d.draft_steps == jd.draft_steps
    assert dm.trace_counts["decode"] == jdm.trace_counts["decode"]
    # a fresh drafter over the final context drafts the same chain
    fresh = spec.DraftModelDrafter(dm, dparams)
    assert fresh.propose(r, k) == prev


def test_standalone_warmup_makes_every_width():
    jdm, jdparams, dm, dparams = _pair("smollm2-135m", 1, 3,
                                       shape=("serve", 64, 3, "decode"))
    jspec.DraftModelDrafter(jdm, jdparams).warmup()
    d = spec.DraftModelDrafter(dm, dparams)
    d.warmup()
    assert dm.trace_counts == jdm.trace_counts
    assert dm.trace_counts["decode"] == len(d._widths()) == 7   # 1 .. 64


# ---------------------------------------------------------- sampling

@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_split_matches_jax(seed):
    key = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.split(key))
    got = sampling.split(sampling.prng_key(seed))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        sampling.split(got[0], 3),
        np.asarray(jax.random.split(jnp.asarray(want[0]), 3)))


@pytest.mark.parametrize("shape", [(2, 512), (3, 1000), (1, 51865)])
def test_batched_categorical_matches_jax(shape):
    rng = np.random.default_rng(shape[1])
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    key = sampling.split(sampling.prng_key(9))[1]
    jkey = jax.random.split(jax.random.PRNGKey(9))[1]
    n = logits.size
    np.testing.assert_array_equal(
        sampling.uniform(key, n),
        np.asarray(jax.random.uniform(jkey, (n,), minval=np.finfo(np.float32).tiny)))
    jg = np.asarray(jax.random.gumbel(jkey, shape))
    g = sampling.gumbel(key, n).reshape(shape)
    # 2 ulp at the noise's largest magnitude, the measure of
    # test_torch_sampling.py (numpy's float32 log is not XLA's)
    assert np.abs(g - jg).max() <= 2 * np.spacing(np.abs(jg).max())
    want = np.asarray(jax.random.categorical(jkey, jnp.asarray(logits)))
    got = sampling.categorical(key, logits)
    pert = np.sort(logits + g, axis=-1)
    for r in np.flatnonzero(got != want):
        assert pert[r, -1] - pert[r, -2] < MARGIN
    assert got.shape == shape[:1]
