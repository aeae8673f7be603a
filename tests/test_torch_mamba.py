"""The mamba mixer in the port (``models/mamba.py``) and the hybrid cache
tree (page pools beside per-slot state) against the JAX package, on the
CPU in float32.  The hybrid test configuration is reduced jamba-v0.1
with ``moe=False`` (one period of 8 layers: 7 mamba and one attention;
jamba itself is MoE, which waits for ROADMAP B3), the reference's
parameters carried across and every leaf but the linear weights and the
embedding perturbed:

- ``_ssm_scan`` (sequential) against the reference's associative scan,
  at the reference test's tolerance (rtol 1e-5, atol 1e-6);
- ``mamba_apply`` in the train/prefill mode, a one-token decode from a
  cached state and a prefill from a cached state: the output and the
  cache the reference returns (the port writes it in place);
- the hybrid model's tree, logits within 1e-5 of max(1, max |logit|);
- ``prepack_params`` leaves ``dt_proj`` (a plain float32 product, read
  by no ``linear_apply``) unpacked and packs every other linear;
- the prepacked monolithic engine's greedy drain token for token with the
  JAX engine's, at an undersized pool that preempts.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models import mamba as jmamba
from repro.models.model import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.core.linear import prepack_params
from repro_torch.models import mamba
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params
from test_torch_rwkv import _close, _drain, _tree, perturb

torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"
F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 3, "decode")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jreduced(jget_config(ARCH)), moe=False)
    cfg = dataclasses.replace(reduced_config(get_config(ARCH)), moe=False)
    assert cfg.n_layers == len(cfg.block_pattern) == 8
    jm = jbuild_model(jcfg, JRun(**F32), JShape(*SHAPE))
    m = build_model(cfg, RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    jp = perturb(jm.init(jax.random.PRNGKey(0)))
    return jm, jax.tree.map(jnp.asarray, jp), m, from_jax_params(jp)


def test_ssm_scan_matches_reference_associative_scan():
    rng = np.random.default_rng(0)
    da = 1 / (1 + np.exp(-rng.standard_normal((2, 16, 4, 3)))).astype(np.float32)
    dbx = rng.standard_normal((2, 16, 4, 3)).astype(np.float32)
    want = jmamba._ssm_scan(jnp.asarray(da), jnp.asarray(dbx))
    got = mamba._ssm_scan(torch.from_numpy(da), torch.from_numpy(dbx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode,s", [("train", 7), ("decode", 1), ("prefill", 6)])
def test_mixer_matches_reference(models, mode, s):
    jm, jp, m, p = models
    cfg = m.cfg
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jcache = cache = None
    if mode != "train":
        _, di, _, n = mamba._dims(cfg)
        jcache = {"conv": jnp.asarray(rng.standard_normal(
                      (2, cfg.mamba_d_conv - 1, di)).astype(np.float32)),
                  "ssm": jnp.asarray(rng.standard_normal((2, di, n)).astype(np.float32))}
        cache = {k: torch.tensor(np.asarray(v)) for k, v in jcache.items()}
    mixer = jax.tree.map(lambda a: a[0], jp["groups"]["p0"]["mixer"])
    tmixer = jax.tree.map(lambda a: a[0], p["groups"]["p0"]["mixer"])
    jout, jc = jmamba.mamba_apply(mixer, jnp.asarray(x), jm.ctx, jm.cfg,
                                  cache=jcache)
    out, c = mamba.mamba_apply(tmixer, torch.tensor(x), m.ctx, cfg, cache=cache)
    _close(out.numpy(), jout)
    assert c is cache                       # written in place
    if jc is not None:
        for k, want in jc.items():
            _close(cache[k].numpy(), want)


def test_hybrid_logits_match_reference(models):
    jm, jp, m, p = models
    assert _tree(m.init(torch.Generator().manual_seed(0))) == _tree(p) == \
        _tree(jax.tree.map(np.asarray, jp))
    assert "wq" in p["groups"]["p4"]["mixer"]                  # attention at 4
    assert all("in_proj" in p["groups"][f"p{i}"]["mixer"] for i in (0, 1, 2, 3, 5, 6, 7))
    tokens = np.random.default_rng(5).integers(0, 512, (2, 20)).astype(np.int32)
    want, _ = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    got, _ = m.forward(p, {"tokens": tokens})
    _close(got.numpy(), want)


def test_prepack_leaves_dt_proj_a_plain_product(models):
    _, _, m, p = models
    packed = prepack_params(p, m.ctx)
    mixer = packed["groups"]["p0"]["mixer"]
    assert set(mixer["dt_proj"]) == {"w", "b"}
    assert mixer["dt_proj"]["w"] is p["groups"]["p0"]["mixer"]["dt_proj"]["w"]
    for name in ("in_proj", "x_proj", "out_proj"):
        assert set(mixer[name]) == {"w_pack", "w_n"}
    assert set(packed["groups"]["p4"]["mixer"]["wq"]) == {"w_pack", "w_n"}


def test_prepacked_hybrid_drain_matches_jax_engine(models):
    """The cache tree holds the attention layer's page pools beside the
    mamba layers' per-slot state; the engine prepacks its weights; the
    pool is undersized, so a request is preempted and re-prefilled from
    zero state."""
    jm, jp, m, p = models
    pool = dict(page_tokens=8, num_pages=1 + 6)
    eng = Engine(m, p, device="cpu", max_slots=3, **pool)
    assert "w_pack" in eng.params["lm_head"]
    caches = eng.caches
    assert set(caches["p4"]["kv"]) == {"k_pages", "v_pages"}
    assert set(caches["p0"]["mamba"]) == {"conv", "ssm"}
    assert caches["p0"]["mamba"]["ssm"].shape[:2] == (1, 3)      # [G, slots]
    want = _drain(JEngine(jm, jp, max_slots=3, **pool))
    got = _drain(eng)
    assert got == want
    assert eng.num_preemptions >= 1
    assert eng.pool.num_used == 0

