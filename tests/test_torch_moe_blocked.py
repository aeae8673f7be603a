"""The moe layer's per-shard dispatch (``RunConfig.moe_local_dispatch``
over a data-parallel mesh) in the port against the JAX package, on the
CPU in float32, reduced Qwen3-MoE and Arctic (4 experts, top-2, d 64):

- the global view (one process holds every token; the port's context from
  ``ReproModel(mesh=AbstractMesh)``, the reference's ``MatmulContext(
  dp_size=b, moe_local=True)`` without a mesh, where its
  ``constrain_blocks`` is a no-op) at 2 and 4 blocks: the dropped
  fraction exactly, y within 1e-5 of max(1, max |y|), the aux losses
  within 1e-6; the gradients of x and of every layer leaf against
  ``jax.grad`` within 2e-5 of each leaf's largest entry;
- at ``capacity_factor`` 8 (nothing drops) the blocked result equals the
  port's own one-block path within 1e-6;
- ``dispatch_blocks``: one block where the blocks do not divide the
  tokens, without ``moe_local`` and for a rank of a ``DeviceMesh`` (the
  local view), which refuses the global dispatch;
- the local view over a 4-rank gloo ``data`` group (one process a rank,
  ``FileStore`` rendezvous): each rank routes and dispatches its batch
  shard, and the gathered outputs equal the one-process blocked result
  within 1e-6 of max |y|, the routes and the dropped fraction exactly;
  each rank's aux losses (its terms all-reduced over the group) equal the
  global view's within 1e-6, and its gradients of every layer leaf,
  averaged over the ranks as a data-parallel step averages them, equal
  the global view's within 2e-5 of each leaf's largest entry.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models import moe as jmoe
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.core.linear import MatmulContext
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.model import build_model
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-moe-235b-a22b", "arctic-480b")
F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 4, "decode")
X_SHAPE = (4, 16)                 # 64 tokens: 4 rows of 16
GRAD_REL = 2e-5


def _close(got, want, scale=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=scale * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module", params=ARCHS)
def layer(request):
    """(arch, reference ffn, port ffn, reference ctx, port model) of the
    first moe layer of a reduced 2-layer model, weights carried across."""
    arch = request.param
    jm = jbuild_model(jreduced(jget_config(arch), layers=2), JRun(**F32),
                      JShape(*SHAPE))
    m = build_model(reduced_config(get_config(arch), layers=2), RunConfig(**F32),
                    ShapeSpec(*SHAPE), device="cpu")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    jffn = jax.tree.map(lambda a: jnp.asarray(a[0]), jp["groups"]["p0"]["ffn"])
    ffn = tfm.tree_map(lambda a: a[0], from_jax_params(jp)["groups"]["p0"]["ffn"])
    return arch, jffn, ffn, jm.ctx, m


def _contexts(jctx, m, blocks: int, run=None):
    """The reference's context at ``blocks`` data shards and the port's,
    from ``ReproModel(mesh=AbstractMesh)`` (the global view)."""
    jc = dataclasses.replace(jctx, dp_size=blocks, moe_local=True, mesh_axes=None)
    run = run or RunConfig(**F32, moe_local_dispatch=True)
    pm = build_model(m.cfg, run, m.shape, hw=m.ctx.hw, device="cpu",
                     mesh=AbstractMesh((blocks, 1), ("data", "model")))
    return jc, pm.ctx


def _x(cfg, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (*X_SHAPE, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("cf", [1.25, 0.5], ids=["cf1.25", "cf0.5"])
@pytest.mark.parametrize("blocks", [2, 4])
def test_blocked_dispatch_matches_reference(layer, blocks, cf):
    arch, jffn, ffn, jctx, m = layer
    cfg = dataclasses.replace(m.cfg, capacity_factor=cf)
    jcfg = dataclasses.replace(jreduced(jget_config(arch), layers=2),
                               capacity_factor=cf)
    jc, ctx = _contexts(jctx, m, blocks)
    assert (ctx.dp_size, ctx.moe_local, ctx.dp_local) == (blocks, True, False)
    assert moe.dispatch_blocks(64, ctx) == blocks
    x = _x(cfg, blocks)
    jy, jaux = jax.jit(lambda p, x_: jmoe.moe_apply(p, x_, jc, jcfg))(
        jffn, jnp.asarray(x))
    y, aux = moe.moe_apply(ffn, torch.tensor(x), ctx, cfg)
    _close(y.numpy(), jy)
    for k in ("load_balance", "router_z"):
        assert float(aux[k]) == pytest.approx(float(jaux[k]), rel=1e-6, abs=1e-6), k
    assert float(aux["dropped_frac"]) == float(jaux["dropped_frac"])
    if cf < 1:
        assert float(aux["dropped_frac"]) > 0.05         # drops happen


@pytest.mark.parametrize("blocks", [2, 4])
def test_blocked_gradients_match_jax(layer, blocks):
    """grad of sum(y * dy) + the aux losses (weighted as the model's loss
    weighs them) for x and every leaf of the layer, against jax.grad."""
    arch, jffn, ffn, jctx, m = layer
    cfg = dataclasses.replace(m.cfg, capacity_factor=0.5)
    jcfg = dataclasses.replace(jreduced(jget_config(arch), layers=2),
                               capacity_factor=0.5)
    jc, ctx = _contexts(jctx, m, blocks)
    x = _x(cfg, 10 + blocks)
    dy = np.random.default_rng(20 + blocks).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x_):
        y, aux = jmoe.moe_apply(p, x_, jc, jcfg)
        return (jnp.sum(y * dy) + cfg.router_aux_weight * aux["load_balance"]
                + cfg.router_z_weight * aux["router_z"])

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jffn, jnp.asarray(x))
    p = tfm.tree_map(lambda t: t.clone().requires_grad_(True), ffn)
    xt = torch.tensor(x, requires_grad=True)
    y, aux = moe.moe_apply(p, xt, ctx, cfg)
    loss = ((y * torch.tensor(dy)).sum() + cfg.router_aux_weight * aux["load_balance"]
            + cfg.router_z_weight * aux["router_z"])
    loss.backward()
    _close(xt.grad.numpy(), jgx, GRAD_REL)
    flat = jax.tree_util.tree_flatten_with_path(jgp)[0]
    assert len(flat) == len(tfm_leaves(p))
    for path, jg in flat:
        keys = [k.key for k in path]
        leaf = p
        for k in keys:
            leaf = leaf[k]
        jg = np.asarray(jg)
        np.testing.assert_allclose(leaf.grad.numpy(), jg, rtol=0,
                                   atol=GRAD_REL * max(1e-30, np.abs(jg).max()),
                                   err_msg="/".join(keys))


def tfm_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tfm_leaves(v)]
    return [tree]


@pytest.mark.parametrize("blocks", [2, 4])
def test_blocked_equals_one_block_where_nothing_drops(layer, blocks):
    arch, jffn, ffn, jctx, m = layer
    cfg = dataclasses.replace(m.cfg, capacity_factor=8.0)
    _, ctx = _contexts(jctx, m, blocks)
    x = torch.tensor(_x(cfg, 30 + blocks))
    y, aux = moe.moe_apply(ffn, x, ctx, cfg)
    y1, aux1 = moe.moe_apply(ffn, x, MatmulContext(hw=m.ctx.hw), cfg)
    assert float(aux["dropped_frac"]) == float(aux1["dropped_frac"]) == 0.0
    _close(y.numpy(), y1.numpy(), 1e-6)


def test_dispatch_blocks_rules():
    glob = MatmulContext(dp_size=4, moe_local=True)
    assert moe.dispatch_blocks(64, glob) == 4
    assert moe.dispatch_blocks(66, glob) == 1                  # 4 does not divide
    assert moe.dispatch_blocks(64, MatmulContext(dp_size=4)) == 1
    local = MatmulContext(dp_size=4, moe_local=True, dp_local=True)
    assert moe.dispatch_blocks(64, local) == 1                 # a rank's own block
    with pytest.raises(NotImplementedError, match="moe_local_dispatch"):
        moe.dispatch_blocks(64, MatmulContext(dp_size=4, dp_local=True))


_RANK = r"""
import dataclasses, sys, torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[5])
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.distributed import sharding
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.model import build_model
torch.set_num_threads(1)
rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                        world_size=world)
try:
    mesh = init_device_mesh("cpu", (world, 1), mesh_dim_names=("data", "model"))
    run = RunConfig(param_dtype="float32", compute_dtype="float32", remat=False,
                    moe_local_dispatch=True, fsdp=False)
    for arch in sys.argv[6:]:
        cfg = dataclasses.replace(reduced_config(get_config(arch), layers=2),
                                  capacity_factor=0.5)
        m = build_model(cfg, run, ShapeSpec("serve", 64, 4, "decode"),
                        device="cpu", mesh=mesh)
        assert (m.ctx.dp_size, m.ctx.dp_local) == (world, True)
        ffn = torch.load(f"{out}.{arch}.ffn", weights_only=True)
        x = torch.load(f"{out}.{arch}.x", weights_only=True)
        # the layer's weights placed by the rules (replicated: fsdp off, a
        # one-rank model axis), each rank's local tensors used
        placed = sharding.distribute(ffn, mesh, sharding.param_specs(ffn, run, mesh))
        local = tfm.tree_map(lambda t: t.to_local(), placed)
        shard = x.chunk(world, 0)[rank]
        dy = torch.load(f"{out}.{arch}.dy", weights_only=True).chunk(world, 0)[rank]
        local = tfm.tree_map(lambda t: t.detach().clone().requires_grad_(True), local)
        counter = moe.DropCounter("cpu").install()
        y, aux = moe.moe_apply(local, shard, m.ctx, cfg)
        counter.uninstall()
        # a data-parallel step's loss on this rank, its gradients averaged
        # over the ranks
        loss = ((y * dy).sum() + cfg.router_aux_weight * aux["load_balance"]
                + cfg.router_z_weight * aux["router_z"])
        names = list(sharding.tree_paths(local))
        grads = [g.clone() for g in
                 torch.autograd.grad(loss, list(sharding.tree_paths(local).values()))]
        for g in grads:
            dist.all_reduce(g)
        grads = {n: g / world for n, g in zip(names, grads)}
        y = y.detach()
        aux = {k: v.detach() for k, v in aux.items()}
        _, _, _, top_e = moe._route(shard.reshape(-1, cfg.d_model),
                                    local["router"]["w"], cfg.top_k)
        ys = [torch.empty_like(y) for _ in range(world)]
        dist.all_gather(ys, y.contiguous())
        dist.all_reduce(counter.counts)             # [routed, kept], summed
        es = [torch.empty_like(top_e) for _ in range(world)]
        dist.all_gather(es, top_e.contiguous())
        if rank == 0:
            torch.save({"y": torch.cat(ys), "top_e": torch.cat(es),
                        "counts": counter.counts, "aux": aux, "grads": grads},
                       f"{out}.{arch}.res")
finally:
    dist.destroy_process_group()
"""


def test_local_view_over_gloo_equals_global_view(tmp_path):
    world, layers = 4, {}
    base = str(tmp_path / "run")
    for arch in ARCHS:
        m = build_model(dataclasses.replace(reduced_config(get_config(arch), layers=2),
                                            capacity_factor=0.5),
                        RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
        ffn = tfm.tree_map(lambda a: a[0], m.init(torch.Generator().manual_seed(0))
                           ["groups"]["p0"]["ffn"])
        x = torch.tensor(_x(m.cfg, 99))
        dy = torch.tensor(_x(m.cfg, 98))
        torch.save(ffn, f"{base}.{arch}.ffn")
        torch.save(x, f"{base}.{arch}.x")
        torch.save(dy, f"{base}.{arch}.dy")
        layers[arch] = (m, ffn, x, dy)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(world),
                               str(tmp_path / "store"), base,
                               os.path.join(ROOT, "src"), *ARCHS],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    for arch, (m, ffn, x, dy) in layers.items():
        res = torch.load(f"{base}.{arch}.res", weights_only=True)
        ctx = build_model(m.cfg, RunConfig(**F32, moe_local_dispatch=True), m.shape,
                          hw=m.ctx.hw, device="cpu",
                          mesh=AbstractMesh((world, 1), ("data", "model"))).ctx
        p = tfm.tree_map(lambda t: t.clone().requires_grad_(True), ffn)
        counter = moe.DropCounter("cpu").install()
        try:
            y, aux = moe.moe_apply(p, x, ctx, m.cfg)
        finally:
            counter.uninstall()
        # the global view's loss: the ranks' mean of sum(y * dy), and the
        # aux losses, which every rank shares
        loss = ((y * dy).sum() / world + m.cfg.router_aux_weight * aux["load_balance"]
                + m.cfg.router_z_weight * aux["router_z"])
        flat = sharding.tree_paths(p)
        grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
        y, aux = y.detach(), {k: v.detach() for k, v in aux.items()}
        _close(res["y"].numpy(), y.numpy(), 1e-6)
        for k in ("load_balance", "router_z", "dropped_frac"):
            assert float(res["aux"][k]) == pytest.approx(float(aux[k]), rel=1e-6,
                                                         abs=1e-6), (arch, k)
        assert sorted(res["grads"]) == sorted(grads), arch
        for name, g in grads.items():
            _close(res["grads"][name].numpy(), g.numpy(), GRAD_REL)
        _, _, _, top_e = moe._route(x.reshape(-1, m.cfg.d_model), ffn["router"]["w"],
                                    m.cfg.top_k)
        assert torch.equal(res["top_e"], top_e), arch
        assert res["counts"].tolist() == counter.counts.tolist(), arch  # routed, kept
        assert counter.counts[1] < counter.counts[0], arch           # some dropped
