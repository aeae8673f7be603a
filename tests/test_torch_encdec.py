"""The port's encoder-decoder family (whisper-small, reduced: 2 encoder and
2 decoder layers, d_head 16, seq 64) against the JAX package's, float32,
with the reference's parameters carried across by ``from_jax_params``.

- the encoder, ``compute_cross_kv`` (stacked ``[G, ...]``), the
  full-sequence ``encdec_forward`` logits and the loss, to 1e-5;
- ``encdec_decode_step`` through ``ReproModel.decode_step``: a prefill
  then 4 decode steps against the dense and cross caches;
- the engine: ``generate``/``generate_static`` greedy tokens equal to the
  JAX engine's (``generate`` takes the static path for encdec), sampled
  picks under the 1e-5 margin rule, eos padding with ``return_reasons``,
  weights left unpacked, the same ``trace_counts``;
- a static family's refusals: the flat step, chunked prefill, speculation
  and the prefix cache at construction, and ``add_request``, where the JAX
  package asserts.
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
from repro.models import encdec as jencdec
from repro.models.model import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.models import encdec
from repro_torch.models.model import build_model
from repro_torch.serving import sampling
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 2, "decode")
MARGIN = 1e-5


@pytest.fixture(scope="module")
def whisper():
    jcfg = jreduced(jget_config("whisper-small"))
    cfg = reduced_config(get_config("whisper-small"))
    assert (cfg.n_layers, cfg.encoder_layers, cfg.d_head) == (2, 2, 16)
    jm = jbuild_model(jcfg, JRun(**F32), JShape(*SHAPE))
    m = build_model(cfg, RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    return jm, jparams, m, from_jax_params(jax.tree.map(np.asarray, jparams))


def _batch(m, b=2, plen=8, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, m.cfg.vocab, (b, plen)).astype(np.int32),
            "frames": rng.standard_normal((b, m.enc_len, m.cfg.d_model))
            .astype(np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def test_params_carry_across_leaf_for_leaf(whisper):
    """The port's own init builds the reference's tree: the same keys,
    shapes and dtypes as the carried-across parameters."""
    jm, jparams, m, params = whisper

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        return tuple(t.shape)

    own = m.init(torch.Generator().manual_seed(0))
    assert shapes(own) == shapes(params)
    assert shapes(params) == jax.tree.map(lambda a: tuple(a.shape), jparams,
                                          is_leaf=lambda a: hasattr(a, "shape"))
    for key in ("pe_enc", "pe_dec", "frontend_proj", "enc_groups", "enc_ln_f"):
        assert key in params
    dec = params["dec_groups"]["p0"]
    assert {"ln_c", "cross"} <= set(dec) and "b" in dec["cross"]["wq"]
    assert "b" in dec["ffn"]["wu"] and "b" in dec["ffn"]["wd"]


def test_encoder_and_cross_kv_match_jax(whisper):
    jm, jparams, m, params = whisper
    batch = _batch(m)
    jenc = jencdec.encode(jparams, jnp.asarray(batch["frames"]), jm.ctx, jm.cfg,
                          jm.run)
    enc = encdec.encode(params, torch.from_numpy(batch["frames"]), m.ctx, m.cfg,
                        m.run)
    _close(enc, jenc)
    jkv = jencdec.compute_cross_kv(jparams, jenc, jm.ctx, jm.cfg)
    kv = encdec.compute_cross_kv(params, enc, m.ctx, m.cfg)
    assert sorted(kv) == sorted(jkv)
    for name in kv:
        for k in ("k", "v"):
            assert kv[name][k].shape == jkv[name][k].shape       # [G, B, S, H, dh]
            _close(kv[name][k], jkv[name][k])


def test_forward_and_loss_match_jax(whisper):
    jm, jparams, m, params = whisper
    batch = _batch(m, plen=64)
    batch["labels"] = np.roll(batch["tokens"], -1, axis=1)
    jl, _ = jm.forward(jparams, _j(batch))
    l, _ = m.forward(params, batch)
    assert l.shape == (2, 64, m.cfg.vocab)
    _close(l, jl)
    jlast, _ = jm.forward(jparams, _j(batch), last_only=True)
    _close(m.forward(params, batch, last_only=True)[0], jlast)
    jloss, _ = jm.loss(jparams, _j(batch))
    loss, metrics = m.loss(params, batch)
    assert abs(loss.item() - float(jloss)) <= 1e-6 * abs(float(jloss))
    assert set(metrics) == {"nll", "z_loss", "loss"}


def test_decode_step_matches_jax(whisper):
    jm, jparams, m, params = whisper
    batch = _batch(m, plen=9)
    jc = jm.prefill_cache(jparams, _j(batch))
    c = m.prefill_cache(params, batch)
    _close(c["cross"]["p0"]["v"], jc["cross"]["p0"]["v"])
    jl, jc = jm.decode_step(jparams, jc, jnp.asarray(batch["tokens"]),
                            jnp.int32(0))
    l, c = m.decode_step(params, c, torch.from_numpy(batch["tokens"]),
                         torch.tensor(0, dtype=torch.int32))
    _close(l, jl)
    rng = np.random.default_rng(2)
    for i in range(4):
        t = rng.integers(0, m.cfg.vocab, (2, 1)).astype(np.int32)
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(t), jnp.int32(9 + i))
        l, c = m.decode_step(params, c, torch.from_numpy(t),
                             torch.tensor(9 + i, dtype=torch.int32))
        _close(l, jl)
    _close(c["layers"]["p0"]["kv"]["k"], jc["layers"]["p0"]["kv"]["k"])


def test_engine_keeps_encdec_weights_unpacked(whisper):
    _, _, m, params = whisper
    eng = Engine(m, params, device="cpu")
    assert not eng.continuous
    assert "w" in eng.params["dec_groups"]["p0"]["mixer"]["wq"]
    assert "w_pack" not in eng.params["frontend_proj"]


@pytest.mark.parametrize("how", ["generate", "generate_static"])
def test_greedy_tokens_match_jax(whisper, how):
    jm, jparams, m, params = whisper
    batch = _batch(m, b=3)
    want = getattr(JEngine(jm, jparams), how)(_j(batch), 8)
    got = getattr(Engine(m, params, device="cpu"), how)(batch, 8)
    assert got.shape == (3, 8) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))


def test_trace_counts_match_jax():
    jm = jbuild_model(jreduced(jget_config("whisper-small")), JRun(**F32),
                      JShape(*SHAPE))
    m = build_model(reduced_config(get_config("whisper-small")),
                    RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams))
    jeng, eng = JEngine(jm, jparams), Engine(m, params, device="cpu")
    for plen in (8, 8, 5):
        batch = _batch(m, plen=plen)
        np.testing.assert_array_equal(eng.generate(batch, 4),
                                      np.asarray(jeng.generate(_j(batch), 4)))
        assert m.trace_counts == jm.trace_counts
    assert m.trace_counts["decode"] == 3          # [2, 8], [2, 1], [2, 5]


@pytest.mark.parametrize("seed", [0, 7])
def test_sampled_tokens_match_jax_under_the_margin_rule(whisper, seed):
    jm, jparams, m, params = whisper
    batch = _batch(m, b=3)
    want = np.asarray(JEngine(jm, jparams).generate_static(
        _j(batch), 10, greedy=False, seed=seed))
    eng = Engine(m, params, device="cpu")
    seen = []
    step = eng._decode_step

    def recording(*a, **kw):
        out = step(*a, **kw)
        seen.append(out[0][:, -1].float().numpy().copy())
        return out

    eng._decode_step = recording
    got = eng.generate_static(batch, 10, greedy=False, seed=seed)
    key = sampling.prng_key(seed)
    for i in range(1, 10):
        key, sub = sampling.split(key)
        pert = np.sort(seen[i] + sampling.gumbel(sub, seen[i].size)
                       .reshape(seen[i].shape), axis=-1)
        for r in range(3):
            if (got[r, :i + 1] != want[r, :i + 1]).any() and \
                    (got[r, :i] == want[r, :i]).all():
                assert pert[r, -1] - pert[r, -2] < MARGIN, (r, i)


def test_eos_padding_and_reasons_match_jax(whisper):
    jm, jparams, m, params = whisper
    batch = _batch(m, b=3)
    base = Engine(m, params, device="cpu").generate(batch, 8)
    eos = int(base[0, 2])
    want = JEngine(jm, jparams).generate(_j(batch), 8, eos_id=eos,
                                         return_reasons=True)
    got = Engine(m, params, device="cpu").generate(batch, 8, eos_id=eos,
                                                   return_reasons=True)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    assert got[1] == want[1] and got[1][0] == "eos"
    assert (got[0][0, 2:] == eos).all()
    with pytest.raises(ValueError, match="deadline_s"):
        Engine(m, params, device="cpu").generate(batch, 8, deadline_s=1.0)


@pytest.mark.parametrize("kw", [dict(flat=True), dict(chunk_tokens=16),
                                dict(spec_tokens=2), dict(prefix_cache=True)],
                         ids=["flat", "chunked", "spec", "prefix_cache"])
def test_static_family_refuses_the_continuous_options(whisper, kw):
    jm, jparams, m, params = whisper
    with pytest.raises(AssertionError, match="generate_static"):
        JEngine(jm, jparams, **kw)
    with pytest.raises(ValueError, match="generate_static"):
        Engine(m, params, device="cpu", **kw)


def test_static_family_refuses_add_request(whisper):
    jm, jparams, m, params = whisper
    with pytest.raises(AssertionError, match="generate_static"):
        JEngine(jm, jparams).add_request(np.arange(4), 2)
    eng = Engine(m, params, device="cpu")
    with pytest.raises(ValueError, match="generate_static"):
        eng.add_request(np.arange(4), 2)
    with pytest.raises(ValueError, match="generate_static"):
        eng.warmup()


def test_remat_checkpoints_layers_bitwise(whisper):
    """``run.remat`` recomputes each encoder and decoder layer on the
    backward, as the JAX package's ``layers_apply`` does (ROADMAP C15: the
    port's encdec dropped ``run``): the traced train step holds one more
    forward of every layer, and the loss and every gradient equal the
    plain run's bit for bit."""
    import torch.utils._pytree as pytree
    from repro_torch.analysis.graph_tools import trace_step
    from repro_torch.roofline.graph_cost import graph_cost
    from repro_torch.training.optimizer import leaves
    from repro_torch.training.step import value_and_grad

    _, _, m, params = whisper
    batch = _batch(m)
    batch["labels"] = batch["tokens"]
    shape = ShapeSpec("t", batch["tokens"].shape[1], 2, "train")
    plain = build_model(m.cfg, RunConfig(**F32), shape, device="cpu")
    remat = build_model(m.cfg, RunConfig(**dict(F32, remat=True)), shape,
                        device="cpu")
    (l0, _), g0 = value_and_grad(plain, params, batch)
    (l1, _), g1 = value_and_grad(remat, params, batch)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))

    def mmt4d_launches(model):
        def step(p, b):
            ls, spec = pytree.tree_flatten(p)
            ls = [t.detach().requires_grad_(t.is_floating_point()) for t in ls]
            loss, _ = model.loss(pytree.tree_unflatten(ls, spec), b)
            return torch.autograd.grad(loss, [t for t in ls if t.requires_grad])
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        return graph_cost(trace_step(step, (params, tb))).kernel_counts()["mmt4d"]

    # every layer's products run again: 6 an encoder layer, 10 a decoder's
    cfg = m.cfg
    assert mmt4d_launches(remat) - mmt4d_launches(plain) == \
        6 * cfg.encoder_layers + 10 * cfg.n_layers
