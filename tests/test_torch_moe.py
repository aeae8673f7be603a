"""The moe family in the port (``models/moe.py``, ``batched_linear_apply``,
the expert-batched mmt4d's plain version) against the JAX package, on the
CPU in float32, on reduced configs (4 experts, top-2, d 64, expert d_ff
96):

- ``capacity`` equal to the reference's over a grid of token counts and
  capacity factors, for each moe config;
- ``moe_apply`` for qwen3-moe, arctic (its parallel dense branch) and
  jamba's moe layer, packed and unpacked, at 8 and 40 tokens and capacity
  factors 1.25 and 0.01 (at 40 tokens heavy drops; at 8 the capacity's
  floor of 8 keeps every assignment): y within 1e-5 of max(1, max |y|)
  (float32 sums in another order), the aux losses within 1e-6, the
  dropped fraction exactly; the port's ``moe_apply`` twice, bit for bit;
- the expert-batched mmt4d's plain version against the reference's
  ``mmt4d`` with an expert batch dim (bias and activation included);
- ``ReproModel`` forward logits (1e-5) and the loss with its aux terms
  (1e-6) for the three at 8 layers;
- engine drains against the JAX engine for qwen3-moe and arctic, flat
  (``chunk_tokens=16, token_budget=24``) and monolithic: greedy tokens
  identical, and every step's input tokens (pads included: padded tokens
  route and count toward capacity) equal step for step;
- the drop counter counts the real tokens' assignments, padding left
  out, in each family;
- at ``capacity_factor=8`` nothing is dropped, and flat = monolithic
  token for token; at the default factor the two may differ, since a
  step's capacity follows its token count;
- the weights carried across leaf for leaf, and the router left a plain
  float32 product by ``prepack_params`` (also under a bfloat16 cast);
- the launcher serving the two moe configs and reduced jamba, and
  refusing a jamba depth that is not a whole number of its 8-layer
  periods (training: ``test_torch_train_moe.py``).
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
from repro.core.layout import LayoutPolicy as JLayoutPolicy
from repro.core.mmt4d import mmt4d as jmmt4d
from repro.models import moe as jmoe
from repro.models.model import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.core.linear import MatmulContext, prepack_params
from repro_torch.kernels.mmt4d.ops import mmt4d
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

MOE_ARCHS = ("qwen3-moe-235b-a22b", "arctic-480b", "jamba-v0.1-52b")
SERVED = ("qwen3-moe-235b-a22b", "arctic-480b")
F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 3, "decode")


def _pair(arch, layers, cf=None, seed=0):
    jcfg, cfg = jreduced(jget_config(arch), layers=layers), \
        reduced_config(get_config(arch), layers=layers)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    jm = jbuild_model(jcfg, JRun(**F32), JShape(*SHAPE))
    m = build_model(cfg, RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed)))
    return jm, jax.tree.map(jnp.asarray, jp), m, from_jax_params(jp)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def model8(request):
    return request.param, _pair(request.param, 8)


def _moe_slot(cfg) -> str:
    """The pattern slot of the first moe layer."""
    return next(f"p{i}" for i in range(tfm.pattern_period(cfg))
                if cfg.moe_on_layer(i))


def _close(got, want, scale=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=scale * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_capacity_matches_reference(arch):
    for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                      (reduced_config(get_config(arch)),
                       jreduced(jget_config(arch)))):
        for cf in (0.01, 0.5, 1.0, 1.25, 2.0, 8.0):
            c, jc = (dataclasses.replace(cfg, capacity_factor=cf),
                     dataclasses.replace(jcfg, capacity_factor=cf))
            for t in (1, 7, 8, 16, 24, 40, 100, 128, 512, 4096):
                assert moe.capacity(t, c) == jmoe.capacity(t, jc), (cf, t)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def layer(request):
    """(arch, JAX pair) of a reduced 2-period model, for its moe layer."""
    arch = request.param
    layers = 8 if arch.startswith("jamba") else 2
    return arch, _pair(arch, layers)


@pytest.mark.parametrize("cf", [1.25, 0.01], ids=["cf1.25", "cf0.01"])
@pytest.mark.parametrize("t", [8, 40])
@pytest.mark.parametrize("policy", ["scalable", "unpacked"])
def test_moe_apply_matches_reference(layer, policy, t, cf):
    arch, (jm, jp, m, p) = layer
    cfg = dataclasses.replace(m.cfg, capacity_factor=cf)
    jcfg = dataclasses.replace(jm.cfg, capacity_factor=cf)
    slot = _moe_slot(cfg)
    jffn = jax.tree.map(lambda a: a[0], jp["groups"][slot]["ffn"])
    ffn = tfm.tree_map(lambda a: a[0], p["groups"][slot]["ffn"])
    if arch.startswith("arctic"):
        assert "dense" in ffn
    jctx = dataclasses.replace(jm.ctx, policy=JLayoutPolicy(policy))
    ctx = MatmulContext(policy=policy, hw=m.ctx.hw)
    x = np.random.default_rng(t).standard_normal(
        (2, t // 2, cfg.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_apply(jffn, jnp.asarray(x), jctx, jcfg)
    y, aux = moe.moe_apply(ffn, torch.tensor(x), ctx, cfg)
    _close(y.numpy(), jy)
    for k in ("load_balance", "router_z"):
        assert float(aux[k]) == pytest.approx(float(jaux[k]), rel=1e-6, abs=1e-6), k
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    if cf < 1 and t > 8:          # capacity 8 < t: heavy drops
        assert float(aux["dropped_frac"]) > 0.2
    y2, aux2 = moe.moe_apply(ffn, torch.tensor(x), ctx, cfg)
    assert torch.equal(y, y2)                           # bit for bit
    assert all(torch.equal(torch.as_tensor(aux[k]), torch.as_tensor(aux2[k]))
               for k in aux)


@pytest.mark.parametrize("act", [None, "silu"])
def test_expert_batched_mmt4d_plain_matches_reference(act):
    """The plain version of the expert-batched kernel against the JAX
    package's mmt4d over an expert batch dim (its epilogue applied after)."""
    rng = np.random.default_rng(3)
    e, mo, ko, mr, kr, no, nr = 5, 2, 3, 8, 16, 4, 16
    a = rng.standard_normal((e, mo, ko, mr, kr)).astype(np.float32)
    b = rng.standard_normal((e, no, ko, nr, kr)).astype(np.float32)
    bias = rng.standard_normal((e, no, nr)).astype(np.float32)
    want = np.asarray(jmmt4d(jnp.asarray(a), jnp.asarray(b))) \
        + bias[:, None, :, None, :]
    if act == "silu":
        want = np.asarray(jax.nn.silu(want))
    got = mmt4d(torch.tensor(a), torch.tensor(b), torch.tensor(bias),
                activation=act)
    assert got.shape == (e, mo, no, mr, nr)
    _close(got.numpy(), want)
    flat = mmt4d(torch.tensor(a), torch.tensor(b), torch.tensor(bias),
                 activation=act, unpack_to=(13, 50))
    assert flat.shape == (e, 13, 50)
    full = got.numpy().transpose(0, 1, 3, 2, 4).reshape(e, mo * mr, no * nr)
    np.testing.assert_array_equal(flat.numpy(), full[:, :13, :50])
    with pytest.raises(ValueError, match="do not contract"):
        mmt4d(torch.tensor(a[0]), torch.tensor(b))
    with pytest.raises(ValueError, match="bias"):
        mmt4d(torch.tensor(a), torch.tensor(b), torch.tensor(bias[0]))


def test_logits_and_loss_match_reference(model8):
    arch, (jm, jp, m, p) = model8
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 512, (2, 20)).astype(np.int32)
    labels = rng.integers(0, 512, (2, 20)).astype(np.int32)
    want, jaux = jm.forward(jp, {"tokens": jnp.asarray(tokens)})
    got, aux = m.forward(p, {"tokens": tokens})
    _close(got.numpy(), want)
    jloss, jmet = jm.loss(jp, {"tokens": jnp.asarray(tokens),
                               "labels": jnp.asarray(labels)})
    loss, met = m.loss(p, {"tokens": tokens, "labels": labels})
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    for k in ("nll", "load_balance", "router_z", "dropped_frac"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-6, abs=1e-6), k
    assert float(aux["load_balance"]) > 0       # summed over the moe layers


def _record_steps(eng, names):
    """Every model call's input tokens, in order: ``names`` are the
    engine's step callables, whose third argument is the token array (the
    JAX engine's jitted steps, the port's ``_run_*`` take it first)."""
    seen = []
    for name in names:
        run = getattr(eng, name)

        def rec(*args, _run=run, **kw):
            seen.append(np.asarray(args[2 if name.endswith("_step") else 0]).copy())
            return _run(*args, **kw)
        setattr(eng, name, rec)
    return seen


def _drain(eng, seed=1):
    rng = np.random.default_rng(seed)
    rids = [eng.add_request(rng.integers(0, 512, n).astype(np.int32), k)
            for n, k in zip([13, 21, 3, 30], [8, 6, 10, 5])]
    fin = {r.rid: r for r in eng.drain()}
    return [(fin[r].out_tokens, fin[r].finish_reason) for r in rids]


FAMILIES = {"flat": dict(chunk_tokens=16, token_budget=24), "monolithic": {}}


@pytest.fixture(scope="module", params=SERVED)
def served(request):
    return request.param, _pair(request.param, 2)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_drain_matches_jax_engine_step_for_step(served, family):
    arch, (jm, jp, m, p) = served
    kw = dict(max_slots=3, page_tokens=8, **FAMILIES[family])
    jeng, eng = JEngine(jm, jp, **kw), Engine(m, p, device="cpu", **kw)
    assert eng.flat == jeng.flat == (family == "flat")
    jsteps = _record_steps(jeng, ("_flat_step", "_paged_step"))
    steps = _record_steps(eng, ("_run_flat", "_run_paged"))
    want, got = _drain(jeng), _drain(eng)
    assert got == want
    assert len(steps) == len(jsteps) > 0
    for s, js in zip(steps, jsteps):
        assert s.shape == js.shape
        np.testing.assert_array_equal(s, js)


def test_no_drops_flat_equals_monolithic():
    """At capacity_factor 8 every assignment fits, so a token's output does
    not depend on the step it rides in: flat = monolithic token for token.
    (At the default factor a step's capacity follows its token count, so
    the families may drop differently and part.)"""
    _, _, m, p = _pair("qwen3-moe-235b-a22b", 2, cf=8.0)
    counter = moe.DropCounter("cpu").install()
    try:
        toks = {}
        for family, kw in FAMILIES.items():
            counter.reset()
            toks[family] = _drain(Engine(m, p, device="cpu", max_slots=3,
                                         page_tokens=8, **kw))
            assert counter.counts[0] > 0 and counter.dropped_frac() == 0.0
    finally:
        counter.uninstall()
    assert toks["flat"] == toks["monolithic"]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_drop_counter_counts_real_tokens(served, family):
    """The DropCounter counts the real tokens' assignments only (k per
    token and moe layer), padding left out, in each family."""
    arch, (jm, jp, m, p) = served
    eng = Engine(m, p, device="cpu", max_slots=3, page_tokens=8,
                 **FAMILIES[family])
    real = []
    for name in ("_run_flat", "_run_paged"):
        run = getattr(eng, name)

        def rec(*args, _run=run, _name=name, **kw):
            if _name == "_run_flat":
                real.append(int((np.asarray(args[2]) >= 0).sum()))
            else:
                real.append(int(np.asarray(args[3]).sum()))
            return _run(*args, **kw)
        setattr(eng, name, rec)
    counter = moe.DropCounter("cpu").install()
    try:
        _drain(eng)
    finally:
        counter.uninstall()
    routed, kept = counter.counts.tolist()
    assert routed == sum(real) * m.cfg.top_k * m.cfg.n_layers > 0
    assert 0 < kept <= routed


def test_weights_carry_across_and_router_stays_plain():
    jm, jp, m, p = _pair("arctic-480b", 2)
    jffn = jax.tree.map(np.asarray, jp["groups"]["p0"]["ffn"])
    ffn = p["groups"]["p0"]["ffn"]
    assert set(ffn) == set(jffn) == {"router", "wg", "wu", "wd", "dense"}
    g, e, d, f = 2, m.cfg.n_experts, m.cfg.d_model, m.cfg.d_ff_expert
    assert tuple(ffn["router"]["w"].shape) == (g, d, e)
    assert tuple(ffn["wg"]["w"].shape) == (g, e, d, f)
    assert tuple(ffn["wd"]["w"].shape) == (g, e, f, d)
    for path in (("router", "w"), ("wg", "w"), ("wu", "w"), ("wd", "w"),
                 ("dense", "wg", "w"), ("dense", "wu", "w"), ("dense", "wd", "w")):
        a, b = ffn, jffn
        for k in path:
            a, b = a[k], b[k]
        assert tuple(a.shape) == b.shape and str(a.dtype) == f"torch.{b.dtype}"
        np.testing.assert_array_equal(a.numpy(), b)
    own = m.init(torch.Generator().manual_seed(0))["groups"]["p0"]["ffn"]
    assert {k: tuple(v["w"].shape) for k, v in own.items() if "w" in v} == \
        {k: tuple(v["w"].shape) for k, v in ffn.items() if "w" in v}
    for dtype in (None, torch.bfloat16):
        packed = prepack_params(p, m.ctx, dtype)["groups"]["p0"]["ffn"]
        assert set(packed["router"]) == {"w"}
        assert packed["router"]["w"] is ffn["router"]["w"]
        assert packed["router"]["w"].dtype == torch.float32
        assert packed["wg"]["w_pack"].shape[:2] == (g, e)
        assert packed["wg"]["w_pack"].ndim == 6          # [G, E, N_o, K_o, n_r, k_r]
        assert set(packed["dense"]["wd"]) == {"w_pack", "w_n"}
    # consume: each w leaves the input as its pack is made
    tree = tfm.tree_map(lambda t: t.clone(), p)
    packed = prepack_params(tree, m.ctx, consume=True)
    assert "w" not in tree["groups"]["p0"]["ffn"]["wg"]
    assert "w" in tree["groups"]["p0"]["ffn"]["router"]
    assert prepack_params(packed, m.ctx) == packed       # already packed


def test_serve_launcher_moe_and_jamba_refusal(capsys):
    from repro_torch.launch.serve import SERVABLE, main
    assert set(SERVED) <= set(SERVABLE)
    assert "jamba-v0.1-52b" in SERVABLE
    small = ["--device", "cpu", "--dtype", "float32", "--requests", "3",
             "--min-prompt", "4", "--max-prompt", "12", "--new", "3",
             "--max-len", "64"]
    fin = main(["--arch", "jamba-v0.1-52b", "--reduced", *small])
    out = capsys.readouterr().out
    assert len(fin) == 3 and all(len(r.out_tokens) == 3 for r in fin)
    assert "monolithic step" in out and "dropped" in out and "3 requests" in out
    for layers in ("4", "12"):           # periods of 8: half, one and a half
        with pytest.raises(SystemExit):
            main(["--arch", "jamba-v0.1-52b", "--reduced", "--layers", layers,
                  *small])
        assert "whole periods" in capsys.readouterr().err
    main(["--arch", "arctic-480b", "--reduced", "--device", "cpu", "--dtype",
          "float32", "--requests", "3", "--min-prompt", "4", "--max-prompt",
          "12", "--new", "3", "--max-len", "64", "--chunk-tokens", "16"])
    out = capsys.readouterr().out
    assert "dropped" in out and "3 requests" in out
