"""The port's configs and its dense family at the reference's features,
against the JAX package.

- Every architecture of the JAX package's registry (eleven) is in the
  port's, equal field for field, with equal ``param_counts``; the
  assigned list and the cell matrix are the reference's.
- The families the port once refused to train (moe, the recurrent
  mixers) build, init (a moe layer holds its router) and give a finite
  loss and gradients on the CPU; ``test_torch_train_recurrent.py`` and
  ``test_torch_train_moe.py`` hold them to the reference.
- Qwen2-7B (QKV bias), Qwen3-8B (qk_norm, untied head), ChatGLM3-6B
  (partial 2d RoPE, QKV bias, group 16 cut to 4) and OLMo-1B
  (non-parametric LayerNorm, MHA, tied head) on ``reduced_config`` in
  float32 with the reference's parameters (``from_jax_params`` carries
  biases and qk-norm scales: the trees are checked leaf for leaf):
  forward logits within 1e-5 (float32 sums in another order), flat-drain
  and ``generate_static`` tokens identical to the JAX engine's.
- ``apply_rope`` at ``pct = 0.5``, d_head 128, against the reference's
  (1e-4: the two libraries' sin/cos at angles up to 1000 radians).
- ``analysis.runner.build_model(arch)`` for each of the four, and the
  flat engine over it green in the analyzer.
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
from repro.configs import registry as jregistry
from repro.models.common import apply_rope as japply_rope
from repro.models.model import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import (ARCHS, ASSIGNED, RunConfig, ShapeSpec, cells,
                                 get_config, reduced_config)
from repro_torch.models import transformer as tfm
from repro_torch.models.common import apply_rope
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 3, "decode")
DENSE = ["qwen2-7b", "qwen3-8b", "chatglm3-6b", "olmo-1b"]


@pytest.mark.parametrize("arch", sorted(jregistry.ARCHS))
def test_config_matches_reference(arch):
    cfg, want = get_config(arch), jget_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.param_counts() == want.param_counts()
    assert dataclasses.asdict(reduced_config(cfg)) == \
        dataclasses.asdict(jreduced(want))


def test_registry_matches_reference():
    assert ARCHS == jregistry.ARCHS
    assert ASSIGNED == jregistry.ASSIGNED
    assert list(cells(include_skipped=True)) == \
        list(jregistry.cells(include_skipped=True))
    with pytest.raises(KeyError):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "arctic-480b",
                                  "jamba-v0.1-52b", "rwkv6-1.6b"])
def test_every_family_builds_and_trains_on_the_cpu(arch):
    from repro_torch.training.step import value_and_grad
    cfg = reduced_config(get_config(arch))
    m = build_model(cfg, RunConfig(**F32), ShapeSpec("t", 16, 2, "train"),
                    device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    if cfg.moe:
        assert "router" in params["groups"][
            f"p{tfm.pattern_period(cfg) - 1}"]["ffn"]
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
    batch = {"tokens": tokens.astype(np.int32),
             "labels": np.roll(tokens, -1, 1).astype(np.int32)}
    (loss, _), grads = value_and_grad(m, params, batch)
    assert torch.isfinite(loss)
    leaves = jax.tree.leaves(jax.tree.map(lambda g: g.numpy(), grads))
    assert leaves and all(np.isfinite(g).all() for g in leaves)


def _pair(arch, seed=0):
    jm = jbuild_model(jreduced(jget_config(arch), layers=2), JRun(**F32),
                      JShape(*SHAPE))
    m = build_model(reduced_config(get_config(arch), layers=2),
                    RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    jparams = jm.init(jax.random.PRNGKey(seed))
    return jm, jparams, m, from_jax_params(jax.tree.map(np.asarray, jparams))


@pytest.fixture(scope="module", params=DENSE)
def dense(request):
    return request.param, _pair(request.param)


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    return (tuple(t.shape), str(t.dtype).split(".")[-1])


def test_params_carry_leaf_for_leaf(dense):
    """The port's own init has the reference's tree (biases, qk-norm
    scales, the untied head; no norm scale for OLMo's LayerNorm), and
    ``from_jax_params`` carries every leaf bit for bit."""
    arch, (jm, jparams, m, params) = dense
    own = m.init(torch.Generator().manual_seed(0))
    assert _tree(own) == _tree(params) == _tree(jax.tree.map(np.asarray, jparams))
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for path, leaf in flat_j:
        t = params
        for k in path:
            t = t[k.key]
        assert np.array_equal(t.numpy(), np.asarray(leaf))
    cfg = m.cfg
    layer = params["groups"]["p0"]
    assert ("b" in layer["mixer"]["wq"]) == cfg.attn_bias
    assert ("q_norm" in layer["mixer"]) == cfg.qk_norm
    assert ("lm_head" in params) != cfg.tie_embeddings
    assert (layer["ln1"] == {}) == (cfg.norm == "layernorm_np")


def test_forward_logits_match_reference(dense):
    arch, (jm, jparams, m, params) = dense
    # non-zero biases and norm scales, so the test sees them applied
    rng = np.random.default_rng(7)
    jp = jax.tree.map(np.asarray, jparams)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: (a + rng.standard_normal(a.shape).astype(a.dtype) * 0.1
                         if path[-1].key in ("b", "g") else a), jp)
    tokens = rng.integers(0, 512, (2, 24)).astype(np.int32)
    want, _ = jm.forward(jax.tree.map(jnp.asarray, jp), {"tokens": jnp.asarray(tokens)})
    got, _ = m.forward(from_jax_params(jp), {"tokens": tokens})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def _drain(eng, reqs):
    rids = [eng.add_request(p, n) for p, n in reqs]
    fin = {r.rid: r for r in eng.drain()}
    return [(fin[r].out_tokens, fin[r].finish_reason) for r in rids]


def test_flat_drain_matches_reference(dense):
    arch, (jm, jparams, m, params) = dense
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 512, n).astype(np.int32), k)
            for n, k in zip([13, 21, 3, 30], [8, 6, 10, 5])]
    kw = dict(max_slots=3, page_tokens=8, chunk_tokens=16, token_budget=24)
    eng, jeng = Engine(m, params, device="cpu", **kw), JEngine(jm, jparams, **kw)
    assert eng.flat and jeng.flat
    assert _drain(eng, reqs) == _drain(jeng, reqs)
    assert eng.stats()["steps"] == jeng.stats()["steps"]


def test_generate_static_matches_reference(dense):
    arch, (jm, jparams, m, params) = dense
    tokens = np.random.default_rng(2).integers(0, 512, (2, 12)).astype(np.int32)
    eng, jeng = Engine(m, params, device="cpu"), JEngine(jm, jparams)
    got = eng.generate_static({"tokens": tokens}, 6)
    want = jeng.generate_static({"tokens": tokens}, 6)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)


def test_partial_rope_matches_reference():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 12, 32, 128)).astype(np.float32)
    k = rng.standard_normal((2, 12, 2, 128)).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 12)).astype(np.int32)
    jq, jk = japply_rope(jnp.asarray(q), jnp.asarray(k), jnp.asarray(pos), pct=0.5)
    tq, tk = apply_rope(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(pos), pct=0.5)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-4)
    # the second half of every head passes through untouched
    assert np.array_equal(tq.numpy()[..., 64:], q[..., 64:])
    assert np.array_equal(tk.numpy()[..., 64:], k[..., 64:])


def test_analyzer_green_on_dense_config(dense):
    """``analysis.runner.build_model(arch)`` builds each dense config
    reduced, and the flat engine over it passes the ladder algebra, a
    sanitized warm drain, the retrace report and the pool-ledger audit."""
    from repro_torch.analysis import runner
    arch = dense[0]
    model, params = runner.build_model(arch, device="cpu")
    assert model.cfg == reduced_config(get_config(arch), layers=2)
    report = runner.analyze_engine(model, params, "flat", dict(chunk_tokens=16))
    assert report.ok, report.format()
