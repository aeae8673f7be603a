"""Training the moe family in the port against the JAX package, on the
CPU in float32, on reduced configs (4 experts, top-2, d 64, expert d_ff
96):

- (a) the expert-batched gradients, ``mmt4d_dgrad`` and ``mmt4d_wgrad``'s
  plain versions with the expert dim, through ``batched_linear_apply``
  under autograd, against ``jax.vjp`` of the reference's
  ``batched_linear_apply`` (src/repro/core/linear.py:174), with and
  without a fused activation, capacities on and off the m_r tiles; and
  the two plain versions against per-expert products;
- (b) ``value_and_grad`` of reduced Qwen3-MoE and Arctic (2 layers)
  against ``jax.value_and_grad``: the loss within 1e-6 relative,
  ``load_balance``, ``router_z`` and ``dropped_frac`` within 1e-6, every
  gradient leaf within ``GRAD_REL`` of its largest entry, at
  ``capacity_factor`` 8 (nothing dropped), at the default and at 0.5
  (tokens dropped);
- (c) one AdamW train step of reduced Qwen3-MoE against the JAX package's
  ``make_train_step``;
- (d) a moe layer's backward twice: equal gradients bit for bit (the
  dispatch's and the combine's gathers accumulate in a fixed order).
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
from repro.core.linear import batched_linear_apply as jbatched_linear_apply
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.model import build_model as jbuild_model
from repro.training.optimizer import make_optimizer as jmake_optimizer
from repro.training.step import make_train_step as jmake_train_step
from repro.training.train_state import TrainState as JTrainState
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.core.linear import batched_linear_apply
from repro_torch.kernels.mmt4d.ref import mmt4d_dgrad_ref, mmt4d_wgrad_ref
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import leaves, make_optimizer
from repro_torch.training.step import make_train_step, value_and_grad
from repro_torch.weights import from_jax_params, from_jax_state

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("t", 16, 2, "train")
# gradients: float32 sums in another order, measured near 1e-6 of each
# leaf's largest entry; 2e-5 leaves an order of magnitude of margin
GRAD_REL = 2e-5
MOE = ("qwen3-moe-235b-a22b", "arctic-480b")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(1e-30, np.abs(want).max())


def _models(arch, cf=None, layers=2):
    jcfg, cfg = jreduced(jget_config(arch), layers=layers), \
        reduced_config(get_config(arch), layers=layers)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    jm = jbuild_model(jcfg, JRun(**F32), JShape(*SHAPE))
    m = build_model(cfg, RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    jp = _np(jm.init(jax.random.PRNGKey(5)))
    rng = np.random.default_rng(13)      # the vectors off their init values
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in ("w", "e") else
        (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype), jp)
    batch = JSyntheticLM(jcfg, JShape(*SHAPE), seed=1).batch_at(0)
    return jm, jp, m, batch


# --------------------------------------------------- (a) expert gradients

@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("c", [8, 13], ids=["c8", "c13"])
def test_expert_gradients_match_jax_vjp(c, act):
    """dx [E, C, K] and dw [E, K, N] through the packed expert product
    (pack, mmt4d, the unpacked store; backward: the incoming gradient
    packed, mmt4d_dgrad and mmt4d_wgrad over every expert, unpacked)
    within 1e-5 of each leaf's largest entry of the reference's vjp."""
    jm, _, m, _ = _models("qwen3-moe-235b-a22b")
    e, k, n = 4, 64, 96
    rng = np.random.default_rng(c)
    x = rng.standard_normal((e, c, k)).astype(np.float32)
    w = (rng.standard_normal((e, k, n)) * k ** -0.5).astype(np.float32)
    dy = rng.standard_normal((e, c, n)).astype(np.float32)
    jact = {None: None, "silu": jax.nn.silu}[act]
    _, vjp = jax.vjp(lambda x_, w_: jbatched_linear_apply(
        {"w": w_}, x_, jm.ctx, activation=jact), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    xt, wt = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
    y = batched_linear_apply({"w": wt}, xt, m.ctx, activation=act)
    dx, dw = torch.autograd.grad((y * torch.tensor(dy)).sum(), (xt, wt))
    _rel_close(dx.numpy(), jdx, 1e-5)
    _rel_close(dw.numpy(), jdw, 1e-5)


def test_expert_grad_plain_versions_are_per_expert_products():
    """The expert-batched plain versions equal each expert's own
    (unbatched) product, bit for bit, bias gradient included."""
    rng = np.random.default_rng(0)
    e, mo, no, ko, mr, nr, kr = 3, 2, 3, 2, 8, 16, 16
    f = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32))
    dz, b, a = f(e, mo, no, mr, nr), f(e, no, ko, nr, kr), f(e, mo, ko, mr, kr)
    da = mmt4d_dgrad_ref(dz, b)
    db, dbias = mmt4d_wgrad_ref(dz, a, bias=True, experts=True)
    for i in range(e):
        assert torch.allclose(da[i], mmt4d_dgrad_ref(dz[i], b[i]), rtol=0, atol=1e-5)
        dbi, dbias_i = mmt4d_wgrad_ref(dz[i], a[i], bias=True)
        assert torch.allclose(db[i], dbi, rtol=0, atol=1e-5)
        assert torch.allclose(dbias[i], dbias_i, rtol=0, atol=1e-5)


# ----------------------------------------------------- (b) value and grad

@pytest.mark.parametrize("cf", [8.0, None, 0.5], ids=["cf8", "default", "cf0.5"])
@pytest.mark.parametrize("arch", MOE)
def test_value_and_grad_matches_jax(arch, cf):
    """Loss within 1e-6 relative; the aux metrics within 1e-6 (the
    dropped fraction at a factor of 8 zero, at 0.5 above zero); every
    gradient leaf, the router's and the experts' among them, within
    GRAD_REL of its largest entry."""
    jm, jp, m, batch = _models(arch, cf)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp), {k: jnp.asarray(v) for k, v in batch.items()})
    (loss, met), g = value_and_grad(m, from_jax_params(jp), batch)
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    for key in ("load_balance", "router_z", "dropped_frac"):
        assert abs(float(met[key]) - float(jmet[key])) <= 1e-6 * max(1.0, abs(float(jmet[key])))
    if cf is not None:
        assert (float(met["dropped_frac"]) > 0) == (cf < 1)
    jl_, tl = jax.tree.leaves(jg), leaves(g)
    assert len(jl_) == len(tl)
    for a, b in zip(jl_, tl):
        _rel_close(b.numpy(), a, GRAD_REL)


def test_qwen3_moe_train_step_matches_jax():
    """One AdamW step from one state: the loss within 1e-6 relative; every
    parameter within 1e-6 of the reference's but where a near-zero
    gradient's sign differs (2 lr apart on Adam's first step; at most 1 in
    10,000, none further); the moments within GRAD_REL of each leaf's
    largest entry."""
    run = dict(F32, warmup_steps=1)
    jm, jp, m, batch = _models("qwen3-moe-235b-a22b")
    jopt = jmake_optimizer(JRun(**run), 10)
    opt = make_optimizer(RunConfig(**run), 10)
    jst = JTrainState.create(jax.tree.map(jnp.asarray, jp), jopt)
    st = from_jax_state(np.asarray(jst.step), _np(jst.params), _np(jst.opt_state))
    jst2, jmet = jax.jit(jmake_train_step(jm, jopt, JRun(**run)))(
        jst, {k: jnp.asarray(v) for k, v in batch.items()})
    st2, met = make_train_step(m, opt, RunConfig(**run))(st, batch)
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-6)
    lr = opt.schedule(0)
    off = total = 0
    for a, b in zip(jax.tree.leaves(jst2.params), leaves(st2.params)):
        d = np.abs(b.numpy() - np.asarray(a))
        assert d.max() <= 2 * lr * 1.0001
        off += int((d > 1e-6).sum())
        total += d.size
    assert off <= total // 10_000
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(jst2.opt_state[key]), leaves(st2.opt_state[key])):
            _rel_close(b.numpy(), a, GRAD_REL)


# -------------------------------------------------------- (d) repeatable

@pytest.mark.parametrize("arch", MOE + ("jamba-v0.1-52b",))
def test_moe_layer_backward_repeats_bitwise(arch):
    """Two backward calls of one moe layer (default capacity: tokens
    drop, and dropped assignments all gather expert rows' slot 0) give
    the same x and parameter gradients bit for bit."""
    _, jp, m, _ = _models(arch, layers=8 if arch.startswith("jamba") else 2)
    cfg = m.cfg
    ffn = from_jax_params(jp)["groups"][f"p{tfm.pattern_period(cfg) - 1}"]["ffn"]
    assert "router" in ffn
    ffn = jax.tree.map(lambda t: t[0], ffn)          # the first layer's leaves
    x = torch.tensor(np.random.default_rng(2).standard_normal((2, 16, cfg.d_model)),
                     dtype=torch.float32)
    out = []
    for _ in range(2):
        ps = jax.tree.map(lambda t: t.clone().requires_grad_(True), ffn)
        xs = x.clone().requires_grad_(True)
        y, aux = moe.moe_apply(ps, xs, m.ctx, cfg)
        loss = (y * y).sum() + aux["load_balance"] + aux["router_z"]
        out.append(torch.autograd.grad(loss, [xs] + jax.tree.leaves(ps)))
    assert all(torch.equal(a, b) for a, b in zip(*out))
