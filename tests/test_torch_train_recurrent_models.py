"""Training the recurrent families in the port against the JAX package:
the models, on the CPU in float32 (``test_torch_train_recurrent.py`` has
the recurrences' backward):

- (d) ``value_and_grad`` of reduced RWKV-6 (2 layers) and reduced jamba
  (one period) with and without its experts against
  ``jax.value_and_grad``: loss within 1e-6 relative (the moe metrics
  within 1e-6), every gradient leaf within ``GRAD_REL`` of its largest
  entry; the jamba case without experts failed on the parent (C10: the
  mamba mixer's plain scan wrote its final state into a tensor autograd
  had saved);
- (e) one AdamW train step of reduced RWKV-6 against the JAX package's
  ``make_train_step``.
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
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.model import build_model as jbuild_model
from repro.training.optimizer import make_optimizer as jmake_optimizer
from repro.training.step import make_train_step as jmake_train_step
from repro.training.train_state import TrainState as JTrainState
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.models.model import build_model
from repro_torch.training.optimizer import leaves, make_optimizer
from repro_torch.training.step import make_train_step, value_and_grad
from repro_torch.weights import from_jax_params, from_jax_state
from test_torch_train_recurrent import _rel_close

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
# gradients: float32 sums in another order (the recurrences' backward
# against XLA's scans, the packed matmuls), measured near 1e-6 of each
# leaf's largest entry; 2e-5 leaves an order of magnitude of margin
GRAD_REL = 2e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(arch, layers, **cfg_kw):
    jcfg = dataclasses.replace(jreduced(jget_config(arch), layers=layers), **cfg_kw)
    cfg = dataclasses.replace(reduced_config(get_config(arch), layers=layers),
                              **cfg_kw)
    shape = ("t", 16, 2, "train")
    jm = jbuild_model(jcfg, JRun(**F32), JShape(*shape))
    m = build_model(cfg, RunConfig(**F32), ShapeSpec(*shape), device="cpu")
    jp = _np(jm.init(jax.random.PRNGKey(3)))
    # every non-matrix leaf perturbed (numpy): a zero bonus or decay offset
    # would leave terms of the gradients untested
    rng = np.random.default_rng(11)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a if path[-1].key in ("w", "e") else
        (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype), jp)
    batch = JSyntheticLM(jcfg, JShape(*shape), seed=0).batch_at(0)
    return jm, jp, m, batch


def _assert_value_and_grad(jm, jp, m, batch, aux=()):
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jax.tree.map(jnp.asarray, jp), {k: jnp.asarray(v) for k, v in batch.items()})
    (loss, met), g = value_and_grad(m, from_jax_params(jp), batch)
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    for k in aux:
        assert abs(float(met[k]) - float(jmet[k])) <= 1e-6 * max(1.0, abs(float(jmet[k])))
    jl_, tl = jax.tree.leaves(jg), leaves(g)
    assert len(jl_) == len(tl)
    for a, b in zip(jl_, tl):
        _rel_close(b.numpy(), a, GRAD_REL)


@pytest.mark.parametrize("arch,layers,kw", [
    ("rwkv6-1.6b", 2, {}),
    ("jamba-v0.1-52b", 8, {"moe": False}),
    ("jamba-v0.1-52b", 8, {})], ids=["rwkv6", "jamba_no_moe_c10", "jamba"])
def test_value_and_grad_matches_jax(arch, layers, kw):
    """Loss within 1e-6 relative, the moe metrics within 1e-6, every
    gradient leaf within GRAD_REL of its largest entry (seq 16, batch 2,
    float32)."""
    jm, jp, m, batch = _models(arch, layers, **kw)
    aux = ("load_balance", "router_z", "dropped_frac") if m.cfg.moe else ()
    _assert_value_and_grad(jm, jp, m, batch, aux)


def test_rwkv6_train_step_matches_jax():
    """One AdamW step from one state (reduced RWKV-6, 2 layers): the loss
    within 1e-6 relative; every parameter within 1e-6 of the reference's
    but where a near-zero gradient's sign differs, which Adam's first step
    turns into 2 lr (counted: at most 1 in 10,000, none further); the
    moments within GRAD_REL of each leaf's largest entry."""
    run = dict(F32, warmup_steps=1)
    jm, jp, m, batch = _models("rwkv6-1.6b", 2)
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


def test_jamba_remat_equals_no_remat_bitwise():
    """Reduced jamba (one period) under ``remat``: the scan's backward reads
    its saved tensors once, which the layer's checkpoint requires (ROADMAP
    C14: it read them twice and raised ``CheckpointError``); the loss and
    every gradient equal the plain run's bit for bit, and the JAX package's
    within GRAD_REL."""
    jm, jp, m, batch = _models("jamba-v0.1-52b", 8)
    params = from_jax_params(jp)
    remat = build_model(m.cfg, RunConfig(**dict(F32, remat=True)),
                        ShapeSpec("t", 16, 2, "train"), device="cpu")
    (l0, _), g0 = value_and_grad(m, params, batch)
    (l1, _), g1 = value_and_grad(remat, params, batch)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(leaves(g0), leaves(g1)))
    _assert_value_and_grad(jm, jp, remat, batch, ("load_balance",))
