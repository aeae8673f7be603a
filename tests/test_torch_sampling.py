"""The port's sampled picks against ``jax.random`` and the JAX engine.

- The pick's key (``PRNGKey(seed)``, two ``fold_in``s), its random bits
  (threefry2x32, partitionable counters) and its uniforms equal
  ``jax.random``'s exactly, over seeds (negative and past 32 bits
  included), request ids, positions and vocabulary sizes.
- The Gumbel noise agrees to 2 ulp at the noise's largest magnitude:
  numpy's float32 ``log`` is not XLA's, which differs by a few ulp on some
  inputs, so the noise cannot agree bit for bit.
- Picks on fixed logits rows equal ``jax.random.categorical``'s wherever
  the perturbed row's top-2 margin exceeds ``MARGIN``.
- Sampled drains (per-request temperatures, one of them 0, and one
  request with its own seed) through each family give the JAX engine's
  tokens, under the same margin rule, and the same tokens in every family
  inside the port.
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
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.models.model import build_model
from repro_torch.serving import sampling
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

# a pick may differ from JAX's only where the perturbed row's top two are
# closer than this: the noise differs by at most 2 ulp (about 2e-6 at 16)
MARGIN = 1e-5
F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 3, "decode")


def _jkey(seed, rid, pos):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), rid),
                              pos)


@pytest.mark.parametrize("seed", [0, 1, 7, 123456, 2**31 - 1, 2**31 + 5, -3])
def test_keys_bits_and_uniforms_equal_jax(seed):
    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)),
                          sampling.prng_key(seed))
    tiny = np.finfo(np.float32).tiny
    for rid in (0, 3, 1000):
        for pos in (0, 1, 17):
            jk, nk = _jkey(seed, rid, pos), sampling.pick_key(seed, rid, pos)
            assert np.array_equal(np.asarray(jk), nk)
            for n in (1, 2, 7, 512, 49152):
                assert np.array_equal(
                    np.asarray(jax.random.bits(jk, (n,), jnp.uint32)),
                    sampling.random_bits(nk, n))
                assert np.array_equal(
                    np.asarray(jax.random.uniform(jk, (n,), jnp.float32,
                                                  minval=tiny, maxval=1.0)),
                    sampling.uniform(nk, n))


@pytest.mark.parametrize("seed", [0, 5, 99])
def test_gumbel_noise_within_two_ulp(seed):
    for rid, pos in ((0, 0), (2, 9), (1000, 40)):
        want = np.asarray(jax.random.gumbel(_jkey(seed, rid, pos), (49152,),
                                            jnp.float32))
        got = sampling.gumbel(sampling.pick_key(seed, rid, pos), 49152)
        assert got.dtype == np.float32
        assert np.abs(got - want).max() <= 2 * np.spacing(np.abs(want).max())


@pytest.mark.parametrize("temperature", [1.0, 0.7, 1.3])
def test_picks_equal_jax_above_the_margin(temperature):
    rng = np.random.default_rng(0)
    rows = (rng.standard_normal((24, 512)) * 2).astype(np.float32)
    below = 0
    for i, row in enumerate(rows):
        for seed in (0, 7):
            jrow = jnp.asarray(row)
            if temperature != 1.0:
                jrow = jrow / jnp.float32(temperature)
            want = int(jax.random.categorical(_jkey(seed, i, 3), jrow))
            key = sampling.pick_key(seed, i, 3)
            got = sampling.sample(row, temperature, key)
            z = np.asarray(jrow) + sampling.gumbel(key, row.shape[0])
            top2 = np.sort(z)[-2:]
            if top2[1] - top2[0] > MARGIN:
                assert got == want, (i, seed)
            else:
                below += 1
    assert below <= 1


def _jmodel():
    cfg = jreduced(jget_config("smollm2-135m"), layers=2)
    return jbuild_model(cfg, JRun(**F32), JShape(*SHAPE))


@pytest.fixture(scope="module")
def models():
    jm = _jmodel()
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = reduced_config(get_config("smollm2-135m"), layers=2)
    m = build_model(cfg, RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    return jm, jparams, m, from_jax_params(jax.tree.map(np.asarray, jparams))


TEMPERATURES = (1.0, 0.7, 1.3, 0.0)
REQS = [(np.random.default_rng(i).integers(0, 512, n).astype(np.int32), k)
        for i, (n, k) in enumerate(zip([13, 21, 3, 16, 30], [8, 6, 10, 7, 5]))]
FAMILIES = {"flat": dict(chunk_tokens=8, token_budget=20),
            "dense": dict(chunk_tokens=8, token_budget=20, flat=False),
            "monolithic": {}}


def _record_margins(eng):
    """Wrap the port engine's pick: (rid, position) -> perturbed top-2
    margin of every sampled pick."""
    margins, pick = {}, eng._pick

    def recording(row, req, greedy, seed):
        if not greedy and req.temperature > 0:
            s = seed if req.seed is None else req.seed
            z = row / np.float32(req.temperature) if req.temperature != 1.0 else row
            z = z + sampling.gumbel(sampling.pick_key(s, req.rid, len(req.out_tokens)),
                                    row.shape[0])
            top2 = np.sort(z)[-2:]
            margins[(req.rid, len(req.out_tokens))] = float(top2[1] - top2[0])
        return pick(row, req, greedy, seed)

    eng._pick = recording
    return margins


def _sampled_drain(eng):
    rids = [eng.add_request(p, n, temperature=TEMPERATURES[i % 4],
                            seed=41 if i == 2 else None)
            for i, (p, n) in enumerate(REQS)]
    fin = {r.rid: r.out_tokens for r in eng.drain(greedy=False, seed=7)}
    return [fin[r] for r in rids]


def assert_same_under_margin(got, want, margins):
    """Equal streams, or each parts from the other only at a pick whose
    perturbed top-2 margin is below MARGIN."""
    for rid, (a, b) in enumerate(zip(got, want)):
        for pos, (x, y) in enumerate(zip(a, b)):
            if x != y:
                assert margins.get((rid, pos), np.inf) < MARGIN, (rid, pos)
                break
        else:
            assert len(a) == len(b)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sampled_drain_matches_jax(models, family):
    jm, jparams, m, params = models
    kw = dict(max_slots=3, page_tokens=8, **FAMILIES[family])
    eng = Engine(m, params, device="cpu", **kw)
    margins = _record_margins(eng)
    got = _sampled_drain(eng)
    want = _sampled_drain(JEngine(jm, jparams, **kw))
    assert_same_under_margin(got, want, margins)
    greedy_rows = [toks for i, toks in enumerate(got) if TEMPERATURES[i % 4] == 0]
    eng0 = Engine(m, params, device="cpu", **kw)
    for p, n in REQS:
        eng0.add_request(p, n)
    greedy = {r.rid: r.out_tokens for r in eng0.drain()}
    assert greedy_rows == [greedy[i] for i in range(len(REQS))
                           if TEMPERATURES[i % 4] == 0]


def test_sampled_tokens_equal_across_families(models):
    _, _, m, params = models
    outs = [_sampled_drain(Engine(m, params, device="cpu", max_slots=3,
                                  page_tokens=8, **kw))
            for kw in FAMILIES.values()]
    assert outs[0] == outs[1] == outs[2]
    eng = Engine(m, params, device="cpu", max_slots=3, page_tokens=8)
    for p, n in REQS:
        eng.add_request(p, n)
    greedy = sorted(eng.drain(), key=lambda r: r.rid)
    assert sum(r.out_tokens != toks for r, toks in zip(greedy, outs[0])) >= 3
