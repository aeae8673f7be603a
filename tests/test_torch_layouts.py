"""The port across vector lengths and layout policies, against the JAX
package, on the CPU (float32; the reference's parameters carried across).

- ``packed_matmul`` and ``matmul`` at each vector length (``tpu_vl128``,
  ``tpu_vl256``, ``tpu_vl512``) and each policy, with and without a bias
  + tanh-GELU epilogue, with a packed input and a packed output, match
  ``repro.core.mmt4d``'s to 1e-5 of the largest |value| (templates
  ``tests/test_packing.py``, ``tests/test_kernels.py``);
  ``Epilogue.apply_unpacked`` is the reference's order (cast, bias,
  activation).
- ``linear_apply`` under ``fixed`` and ``scalable`` at ``tpu_vl512`` with a
  packed input (``tests/test_propagation.py``), and under ``unpacked``,
  which refuses a ``PackedArray``; ``prepack_params`` leaves the tree as
  it is under ``unpacked``.
- The reduced SmolLM2's forward logits at the three vector lengths: each
  within 1e-5 of the reference's at the same preset, and each within the
  reference's 2e-3 of the others (``tests/test_system.py``).
- Flat engine drains under (scalable, tpu_vl512), (fixed, tpu_vl512) and
  (unpacked, tpu_v5e): greedy tokens, finish reasons and step counts equal
  the JAX engine's, nothing made after warmup, and the compile counts the
  reference's; the monolithic engine under ``unpacked`` prefills at exact
  lengths, as the reference does at m_r = 1.
- One float32 train step under ``unpacked``: loss within 1e-6, every
  gradient leaf within 2e-5 of its largest entry.
- The launchers: ``train --policy unpacked`` and ``serve --policy
  fixed | unpacked`` under ``$REPRO_HW`` on the CPU.
"""

import importlib
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.core import Epilogue as JEpilogue
from repro.core import matmul as jmatmul
from repro.core import packed_matmul as jpacked_matmul
from repro.core import presets as jpresets
from repro.core.layout import make_layout as jmake_layout
from repro.core.linear import MatmulContext as JCtx
from repro.core.linear import linear_apply as jlinear_apply
from repro.core.propagation import pack_activation as jpack_activation
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.model import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
# the module: repro_torch.core exports the mmt4d function under its name
mm = importlib.import_module("repro_torch.core.mmt4d")
from repro_torch.core.hardware import presets
from repro_torch.core.layout import make_layout
from repro_torch.core.linear import MatmulContext, linear_apply, prepack_params
from repro_torch.core.propagation import pack_activation
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
from repro_torch.training.optimizer import leaves
from repro_torch.training.step import value_and_grad
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
VLS = ["tpu_vl128", "tpu_vl256", "tpu_vl512"]
POLICIES = ["scalable", "fixed", "unpacked"]
REL = 1e-5           # float32 sums in another order
GRAD_REL = 2e-5      # tests/test_torch_training.py's gradient tolerance


def _arr(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


# ---------------------------------------------------------------- products

@pytest.mark.parametrize("epilogue", ["plain", "bias+gelu"])
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("hw", VLS)
def test_matmul_matches_the_reference(hw, policy, epilogue):
    a, b, bias = _arr((2, 37, 300), 0), _arr((300, 130), 1) * 300 ** -0.5, _arr((130,), 2)
    lay = make_layout(policy, presets[hw], torch.float32)
    jlay = jmake_layout(policy, jpresets[hw], jnp.float32)
    on = epilogue != "plain"
    epi = mm.Epilogue(activation="gelu" if on else None)
    jepi = JEpilogue(activation=jax.nn.gelu if on else None, has_bias=on)
    kw, jkw = dict(epilogue=epi, bias=torch.from_numpy(bias) if on else None), \
        dict(epilogue=jepi, bias=jnp.asarray(bias) if on else None)
    got = mm.matmul(torch.from_numpy(a), torch.from_numpy(b), lay, **kw)
    _close(got, jmatmul(jnp.asarray(a), jnp.asarray(b), jlay, **jkw))
    if policy == "unpacked":
        return
    got = mm.packed_matmul(torch.from_numpy(a), torch.from_numpy(b), lay, **kw)
    _close(got, jpacked_matmul(jnp.asarray(a), jnp.asarray(b), jlay, **jkw))
    # elided boundaries: a packed input (M padded to the tile), a packed output
    ap = pack_activation(torch.from_numpy(a), lay).data
    jap = jpack_activation(jnp.asarray(a), jlay).data
    got = mm.packed_matmul(ap, torch.from_numpy(b), lay, a_is_packed=True,
                           keep_packed=True, **kw)
    want = jpacked_matmul(jap, jnp.asarray(b), jlay, a_is_packed=True,
                             keep_packed=True, **jkw)
    _close(got, want)
    got = mm.packed_matmul(ap, torch.from_numpy(b), lay, a_is_packed=True, **kw)
    _close(got, jpacked_matmul(jap, jnp.asarray(b), jlay, a_is_packed=True, **jkw))


def test_apply_unpacked_order():
    """Bias, then the activation, on the already cast product."""
    c, bias = torch.from_numpy(_arr((5, 7), 0)), torch.from_numpy(_arr((7,), 1))
    got = mm.Epilogue(activation="silu").apply_unpacked(c, bias)
    want = JEpilogue(activation=jax.nn.silu, has_bias=True).apply_unpacked(
        jnp.asarray(c.numpy()), jnp.asarray(bias.numpy()))
    _close(got, want)
    assert torch.equal(mm.Epilogue().apply_unpacked(c, None), c)


@pytest.mark.parametrize("policy", ["fixed", "scalable"])
def test_linear_apply_vl512_packed_input(policy):
    """A packed input at tpu_vl512: fixed keeps (8, 128, 128) tiles while
    scalable widens to 512; both match the reference's."""
    x, w, bias = _arr((2, 33, 100), 0), _arr((100, 50), 1), _arr((50,), 2)
    ctx = MatmulContext(policy=policy, hw=presets["tpu_vl512"])
    jctx = JCtx(policy=policy, hw=jpresets["tpu_vl512"])
    px = pack_activation(torch.from_numpy(x), ctx.layout(torch.float32))
    jpx = jpack_activation(jnp.asarray(x), jctx.layout(jnp.float32))
    p = {"w": torch.from_numpy(w), "b": torch.from_numpy(bias)}
    jp = {"w": jnp.asarray(w), "b": jnp.asarray(bias)}
    _close(linear_apply(p, px, ctx, activation="gelu"),
           jlinear_apply(jp, jpx, jctx, activation=jax.nn.gelu))
    got = linear_apply(p, px, ctx, keep_packed=True)
    want = jlinear_apply(jp, jpx, jctx, keep_packed=True)
    _close(got.data, want.data)
    assert got.data.shape[-2:] == ((8, 128) if policy == "fixed" else (8, 512))


def test_linear_apply_unpacked():
    x, w, bias = _arr((2, 9, 100), 0), _arr((100, 50), 1), _arr((50,), 2)
    ctx = MatmulContext(policy="unpacked", hw=presets["tpu_v5e"])
    jctx = JCtx(policy="unpacked", hw=jpresets["tpu_v5e"])
    p = {"w": torch.from_numpy(w), "b": torch.from_numpy(bias)}
    _close(linear_apply(p, torch.from_numpy(x), ctx, activation="silu"),
           jlinear_apply({"w": jnp.asarray(w), "b": jnp.asarray(bias)},
                         jnp.asarray(x), jctx, activation=jax.nn.silu))
    assert prepack_params(p, ctx) is p
    packed = pack_activation(torch.from_numpy(x),
                             make_layout("scalable", presets["tpu_v5e"], torch.float32))
    with pytest.raises(TypeError):
        linear_apply(p, packed, ctx)


# ---------------------------------------------------------------- the model

def _pair(hw, policy="scalable", shape=("t", 32, 2, "train"), layers=2, **run):
    run = dict(F32, layout_policy=policy, **run)
    jm = jbuild_model(jreduced(jget_config("smollm2-135m"), layers=layers),
                      JRun(**run), JShape(*shape), hw=jpresets[hw])
    m = build_model(reduced_config(get_config("smollm2-135m"), layers=layers),
                    RunConfig(**run), ShapeSpec(*shape), hw=presets[hw], device="cpu")
    return jm, m


@pytest.fixture(scope="module")
def jparams():
    jm, _ = _pair("tpu_v5e")
    return jm.init(jax.random.PRNGKey(0))


def _params(jparams):
    return from_jax_params(jax.tree.map(np.asarray, jparams))


def test_logits_across_vector_lengths(jparams):
    tokens = np.random.default_rng(1).integers(0, 512, (2, 32)).astype(np.int32)
    outs = []
    for hw in VLS:
        jm, m = _pair(hw)
        logits, _ = m.forward(_params(jparams), {"tokens": tokens})
        jlogits, _ = jm.forward(jparams, {"tokens": jnp.asarray(tokens)})
        _close(logits.numpy(), jlogits)
        assert m.ctx.layout(torch.float32).n_r == presets[hw].lanes
        outs.append(logits.numpy())
    for o in outs[1:]:
        np.testing.assert_allclose(outs[0], o, rtol=2e-3, atol=2e-3)


LAYOUTS = [("scalable", "tpu_vl512"), ("fixed", "tpu_vl512"), ("unpacked", "tpu_v5e")]


def _drain(eng, reqs):
    rids = [eng.add_request(p, n) for p, n in reqs]
    fin = {r.rid: r for r in eng.drain()}
    return [(fin[r].out_tokens, fin[r].finish_reason) for r in rids]


@pytest.mark.parametrize("policy,hw", LAYOUTS, ids=[f"{p}-{h}" for p, h in LAYOUTS])
def test_flat_drain_matches_jax(jparams, policy, hw):
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, 512, n).astype(np.int32), k)
            for n, k in zip([13, 21, 3, 16, 30], [8, 6, 10, 7, 5])]
    jm, m = _pair(hw, policy, ("serve", 64, 3, "decode"))
    kw = dict(max_slots=3, page_tokens=8, chunk_tokens=16, token_budget=24)
    eng, jeng = Engine(m, _params(jparams), device="cpu", **kw), JEngine(jm, jparams, **kw)
    out = []
    for e in (eng, jeng):
        e.warmup()
        warm = dict(e.stats()["compiles"])
        out.append(_drain(e, reqs))
        assert e.stats()["compiles"] == warm
    assert out[0] == out[1]
    assert warm == jeng.stats()["compiles"]
    assert eng.stats()["steps"] == jeng.stats()["steps"]


def test_monolithic_unpacked_prefills_at_exact_lengths(jparams):
    """At m_r = 1 the reference buckets no prefill (it warms the decode
    step only, and a prompt of n tokens makes a [1, n] program): the
    port does the same, with the same tokens and compile counts."""
    jm, m = _pair("tpu_v5e", "unpacked", ("serve", 64, 3, "decode"))
    reqs = [(np.arange(1, n + 1, dtype=np.int32), 4) for n in (5, 9, 5)]
    eng, jeng = (Engine(m, _params(jparams), device="cpu", max_slots=3),
                 JEngine(jm, jparams, max_slots=3))
    assert [eng._prefill_bucket(n) for n in (1, 5, 9)] == [1, 5, 9]
    out = []
    for e in (eng, jeng):
        e.warmup()
        out.append((dict(e.stats()["compiles"]), _drain(e, reqs),
                    dict(e.stats()["compiles"])))
    assert out[0] == out[1]


def test_unpacked_train_step_matches_jax(jparams):
    jm, m = _pair("tpu_v5e", "unpacked")
    cfg = jreduced(jget_config("smollm2-135m"), layers=2)
    b = JSyntheticLM(cfg, JShape("t", 32, 2, "train"), seed=0).batch_at(0)
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    (loss, _), g = value_and_grad(m, _params(jparams), b)
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    jleaves, tleaves = jax.tree.leaves(jg), leaves(g)
    assert len(jleaves) == len(tleaves)
    for a, t in zip(jleaves, tleaves):
        a = np.asarray(a)
        assert np.abs(t.numpy() - a).max() <= GRAD_REL * np.abs(a).max()


# ---------------------------------------------------------------- launchers

def test_launchers_take_a_policy_and_a_descriptor(monkeypatch, capsys):
    monkeypatch.setenv("REPRO_HW", "tpu_vl512")
    state, history = launch_train.main(["--reduced", "--device", "cpu", "--steps", "2",
                                        "--seq", "16", "--batch", "2",
                                        "--policy", "unpacked"])
    assert state.step == 2 and all(np.isfinite(history))
    out = capsys.readouterr().out
    name = presets["tpu_vl512"].name          # tpu_v5e_vl512, tpu_v5e.scaled(4)
    assert f"hardware {name}, policy unpacked, tiles (m_r, n_r, k_r) = (1, 1, 1)" in out
    toks = {}
    for policy in ("fixed", "unpacked", "scalable"):
        fin = launch_serve.main(["--reduced", "--device", "cpu", "--dtype", "float32",
                                 "--requests", "2", "--min-prompt", "8",
                                 "--max-prompt", "20", "--new", "4",
                                 "--max-len", "64", "--chunk-tokens", "16",
                                 "--policy", policy])
        toks[policy] = sorted((r.rid, r.out_tokens) for r in fin)
        assert f"hardware {name}, policy {policy}" in capsys.readouterr().out
    assert toks["fixed"] == toks["unpacked"] == toks["scalable"]
