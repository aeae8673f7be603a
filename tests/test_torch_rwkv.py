"""RWKV-6 in the port (``models/rwkv6.py``, the wkv6 kernel's plain
version, the recurrent serving path) against the JAX package, on the CPU
in float32, reduced RWKV-6 (d 64, 4 heads of 16, 2 layers), the
reference's parameters carried across by ``from_jax_params`` and every
leaf other than the linear weights and the embedding perturbed, so the
lerps, the decay, the bonus ``u`` and the norm gains all show:

- ``wkv6_ref`` (and the ``wkv6`` wrapper on CPU tensors) against the
  reference's ``_wkv_scan`` in both its branches (256 tokens: 128-token
  checkpointed chunks; 37: the plain scan), from a non-zero state, within
  1e-5 of the largest |value| (float32 sums in another order);
- ``wkv6_chunked_ref``, the kernel's chunked algebra in 16-token chunks,
  against ``wkv6_ref`` and ``_wkv_scan`` at lengths around the chunk
  (1, 15, 16, 17, 35, 256), with decays near 0 (1e-30) and near 1
  (1 - 1e-7) in some channels, its state written into ``s0`` itself;
- ``rwkv_tm_apply`` and ``rwkv_cm_apply`` with and without a cache: the
  output and every cache leaf the reference returns (the port writes them
  in place);
- the model's tree and shapes, logits within 1e-5 and ``loss``;
  ``decode_step`` token by token against the parallel forward
  (``tests/test_models.py::test_decode_matches_parallel``'s form);
- the monolithic engine's greedy drain token for token with the JAX
  engine's, at an ample pool and at an undersized one that preempts (a
  preempted request re-prefills from zero state), with the same program
  counts; the prefill state tree is one set of tensors, zeroed in place;
  ``generate_static`` = ``generate`` = the JAX engine's;
- the refusals where the reference asserts: chunked prefill, the prefix
  cache, speculative decode, a recurrent draft model; the serve
  launcher's rehearsal on the CPU (training: ``test_torch_train_recurrent.py``).
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
from repro.models import rwkv6 as jrwkv6
from repro.models.model import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro.serving.speculative import DraftModelDrafter as JDraftModelDrafter
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref, wkv6_ref
from repro_torch.models import rwkv6
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
from repro_torch.serving.speculative import DraftModelDrafter
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

ARCH = "rwkv6-1.6b"
F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 3, "decode")


def perturb(tree, seed=7):
    """Every leaf but the linear weights ``w`` and the embedding ``e``
    plus N(0, 0.1) noise (numpy, from ``seed``)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in ("w", "e") else
        (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype),
        jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def models():
    jm = jbuild_model(jreduced(jget_config(ARCH), layers=2), JRun(**F32),
                      JShape(*SHAPE))
    m = build_model(reduced_config(get_config(ARCH), layers=2), RunConfig(**F32),
                    ShapeSpec(*SHAPE), device="cpu")
    jp = perturb(jm.init(jax.random.PRNGKey(0)))
    return jm, jax.tree.map(jnp.asarray, jp), m, from_jax_params(jp)


def _close(got, want, scale=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=scale * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("s", [256, 37], ids=["chunked", "plain"])
def test_wkv6_plain_matches_reference_scan(s):
    b, h, dh = 2, 3, 8
    rng = np.random.default_rng(s)
    r, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, s, h, dh)) - 2)).astype(np.float32)
    u = (0.3 * rng.standard_normal((h, dh))).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((b, h, dh, dh))).astype(np.float32)
    y_want, s_want = jrwkv6._wkv_scan(*map(jnp.asarray, (r, k, v, w, u, s0)))
    args = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    for y, st in (wkv6_ref(*args), wkv6(*args)):
        _close(y.numpy(), y_want)
        _close(st.numpy(), s_want)
    # the state written into state_out, which may be s0 itself
    s_in = args[5].clone()
    y, st = wkv6(*args[:5], s_in, state_out=s_in)
    assert st is s_in
    _close(s_in.numpy(), s_want)


CHUNK = 16   # the kernel's tokens per chunk (csrc/wkv6.cu: kL)


@pytest.mark.parametrize("extreme", [False, True], ids=["decays", "extreme"])
@pytest.mark.parametrize("s", [1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK + 3, 256])
def test_wkv6_chunked_algebra_matches_reference(s, extreme):
    """The chunked algebra against the token loop and the reference's
    scan, within 1e-5 of max(1, max |value|), from a non-zero state
    written in place; ``extreme``: w = 1e-30 in channel 0 and 1 - 1e-7 in
    channel 1 of every head (products that underflow, and decays that
    barely decay)."""
    b, h, dh = 2, 2, 16
    rng = np.random.default_rng(100 + s)
    r, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32)
               for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((b, s, h, dh)) - 2)).astype(np.float32)
    if extreme:
        w[..., 0], w[..., 1] = 1e-30, 1 - 1e-7
    u = (0.3 * rng.standard_normal((h, dh))).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((b, h, dh, dh))).astype(np.float32)
    y_jax, s_jax = jrwkv6._wkv_scan(*map(jnp.asarray, (r, k, v, w, u, s0)))
    args = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    y_loop, s_loop = wkv6_ref(*args)
    s_in = args[5].clone()
    y, st = wkv6_chunked_ref(*args[:5], s_in, chunk=CHUNK, state_out=s_in)
    assert st is s_in and y.shape == (b, s, h, dh)
    for want in (y_loop.numpy(), y_jax):
        _close(y.numpy(), want)
    for want in (s_loop.numpy(), s_jax):
        _close(s_in.numpy(), want)


@pytest.mark.parametrize("cached", [False, True], ids=["no-cache", "cache"])
def test_mixers_match_reference(models, cached):
    jm, jp, m, p = models
    cfg, jcfg = m.cfg, jm.cfg
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    jcache = cache = None
    if cached:
        nh, dh = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        shifts = rng.standard_normal((2, 2, cfg.d_model)).astype(np.float32)
        state = (0.3 * rng.standard_normal((2, nh, dh, dh))).astype(np.float32)
        jcache = {"tm_shift": jnp.asarray(shifts[0]), "cm_shift": jnp.asarray(shifts[1]),
                  "state": jnp.asarray(state)}
        cache = {k: torch.tensor(np.asarray(v)) for k, v in jcache.items()}
    block = jax.tree.map(lambda a: a[0], jp["groups"]["p0"])
    tblock = jax.tree.map(lambda a: a[0], p["groups"]["p0"])
    jout, jc = jrwkv6.rwkv_tm_apply(
        block["mixer"], jnp.asarray(x), jm.ctx, jcfg,
        cache=None if jcache is None else {k: jcache[k] for k in ("tm_shift", "state")})
    out, c = rwkv6.rwkv_tm_apply(tblock["mixer"], torch.tensor(x), m.ctx, cfg,
                                 cache=cache)
    _close(out.numpy(), jout)
    jout2, jc2 = jrwkv6.rwkv_cm_apply(
        block["ffn"], jnp.asarray(x), jm.ctx, jcfg,
        cache=None if jcache is None else {"cm_shift": jcache["cm_shift"]})
    out2, c2 = rwkv6.rwkv_cm_apply(tblock["ffn"], torch.tensor(x), m.ctx, cfg,
                                   cache=cache)
    _close(out2.numpy(), jout2)
    if not cached:
        assert jc is jc2 is c is c2 is None
        return
    assert c is c2 is cache                       # written in place
    for k, want in {**jc, **jc2}.items():
        _close(cache[k].numpy(), want)


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    return (tuple(t.shape), str(t.dtype).split(".")[-1])


def test_logits_and_loss_match_reference(models):
    jm, jp, m, p = models
    own = m.init(torch.Generator().manual_seed(0))
    assert _tree(own) == _tree(p) == _tree(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 512, (2, 24)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 24)).astype(np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    got, _ = m.forward(p, {"tokens": tokens})
    _close(got.numpy(), want)
    jloss, jmet = jm.loss(jp, {"tokens": jnp.asarray(tokens),
                               "labels": jnp.asarray(labels)})
    loss, met = m.loss(p, {"tokens": tokens, "labels": labels})
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    assert float(met["nll"]) == pytest.approx(float(jmet["nll"]), rel=1e-6)


def test_decode_matches_parallel(models):
    """The reference's form: a zero dense cache, one token a step, each
    step's logits those of the full-sequence forward at that position."""
    _, _, m, p = models
    s = 12
    toks = np.random.default_rng(8).integers(0, 512, (2, s)).astype(np.int32)
    full, _ = m.forward(p, {"tokens": toks})
    caches = m.prefill_cache(p, {"tokens": toks})
    for t in range(s):
        lg, caches = m.decode_step(p, caches, torch.from_numpy(toks[:, t:t + 1]),
                                   torch.tensor(t, dtype=torch.int32))
        np.testing.assert_allclose(lg[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


REQS = ([13, 21, 3, 16], [8, 6, 10, 7])


def _drain(eng, lens=REQS[0], news=REQS[1], seed=1):
    rng = np.random.default_rng(seed)
    rids = [eng.add_request(rng.integers(0, 512, n).astype(np.int32), k)
            for n, k in zip(lens, news)]
    fin = {r.rid: r for r in eng.drain()}
    return [(fin[r].out_tokens, fin[r].finish_reason) for r in rids]


@pytest.mark.parametrize("pool", [{}, dict(page_tokens=8, num_pages=1 + 6),
                                  dict(max_slots=1)],
                         ids=["ample", "undersized", "one-slot"])
def test_monolithic_drain_matches_jax_engine(models, pool):
    """With one slot the prefill state is the slot's own, zeroed in place
    (no other request can be running)."""
    jm, jp, m, p = models
    pool = {"max_slots": 3, **pool}
    jeng = JEngine(jm, jp, **pool)
    eng = Engine(m, p, device="cpu", **pool)
    assert eng._bucket == jeng._bucket == 1        # exact-length prefills
    leaf_ptrs = [t.data_ptr() for t in jax.tree.leaves(eng._prefill_states)]
    jtrace0, trace0 = dict(jm.trace_counts), dict(m.trace_counts)
    want, got = _drain(jeng), _drain(eng)
    assert got == want
    assert eng.num_preemptions == jeng.num_preemptions
    assert eng.num_preemptions >= (1 if "num_pages" in pool else 0)
    assert {k: m.trace_counts[k] - trace0[k] for k in trace0} == \
        {k: jm.trace_counts[k] - jtrace0[k] for k in jtrace0}
    assert eng.pool.num_used == 0
    # one prefill state tree for the engine's life, zeroed before each use
    assert [t.data_ptr() for t in jax.tree.leaves(eng._prefill_states)] == leaf_ptrs
    view = eng._prefill_view()
    assert all(not t.any() for t in jax.tree.leaves(eng._prefill_states))
    assert view["p0"]["state"] is eng._prefill_states["p0"]["state"]
    assert (eng._prefill_states is eng.caches) == (eng.slots == 1)


def test_generate_static_equals_generate(models):
    jm, jp, m, p = models
    tokens = np.random.default_rng(4).integers(0, 512, (3, 9)).astype(np.int32)
    eng = Engine(m, p, device="cpu", max_slots=3)
    static = eng.generate_static({"tokens": tokens}, 6)
    np.testing.assert_array_equal(static, eng.generate({"tokens": tokens}, 6))
    want = JEngine(jm, jp, max_slots=3).generate_static(
        {"tokens": jnp.asarray(tokens)}, 6)
    np.testing.assert_array_equal(static, np.asarray(want))


@pytest.mark.parametrize("option,match", [
    (dict(chunk_tokens=8), "chunked prefill"),
    (dict(prefix_cache=True), "prefix cache"),
    (dict(spec_tokens=2), "speculative decode")])
def test_recurrent_engines_refuse_as_reference(models, option, match):
    jm, jp, m, p = models
    with pytest.raises(AssertionError, match=match):
        JEngine(jm, jp, **option)
    with pytest.raises(ValueError, match=match):
        Engine(m, p, device="cpu", **option)


def test_recurrent_draft_model_refused(models):
    jm, jp, m, p = models
    with pytest.raises(AssertionError, match="pure-attention draft"):
        JDraftModelDrafter(jm, jp)
    with pytest.raises(ValueError, match="pure-attention draft"):
        DraftModelDrafter(m, p)


def test_serve_launcher_rehearsal(capsys):
    from repro_torch.launch.serve import SERVABLE, main
    assert ARCH in SERVABLE and "jamba-v0.1-52b" in SERVABLE
    main(["--arch", ARCH, "--reduced", "--device", "cpu", "--dtype", "float32",
          "--requests", "3", "--min-prompt", "4", "--max-prompt", "12",
          "--new", "4", "--max-len", "64"])
    out = capsys.readouterr().out
    assert "monolithic step" in out and "exact-length prefills" in out
    with pytest.raises(ValueError, match="chunked prefill"):
        main(["--arch", ARCH, "--reduced", "--device", "cpu",
              "--chunk-tokens", "16", "--max-len", "64"])
