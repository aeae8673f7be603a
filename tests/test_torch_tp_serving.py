"""Serving across ranks on the CPU: ``Engine(mesh=)`` over ``("data",
"model") = (1, R)`` of R gloo processes (``FileStore``), one a rank, each
holding its shard of the weights (whole tiles, ``param_specs``) and of
the page pools (``cache_specs``: the page dim over ``model``), against
the engine on one rank and the JAX package's engine on a ``(1, 2)`` mesh.

The model is reduced SmolLM2 widened so that tiles split (d_model 384, 6
query heads over 3 KV heads of 64, d_ff 1024: Q and O over 3 tiles of
128, K/V over 2, the MLP over 8), in float32, with the reference's
parameters (``jax.random.PRNGKey(0)``) carried by ``from_jax_params``.
One world of 2 ranks and one of 3 (``tests/_torch_tp_world.py``) and the
JAX package's ``(1, 2)`` mesh engine (a subprocess: ``XLA_FLAGS`` must
set the host's device count before JAX starts; its mesh axes ``Auto``)
run side by side, once for the module; the one-rank port engine runs in
this process meanwhile:

- each step family (flat greedy and sampled, dense chunked, monolithic)
  across 2 and 3 ranks: every rank's tokens and finish reasons are the
  one-rank engine's, every model call's logits (at the rows it carries)
  within 1e-5 of the one-rank engine's, nothing captured; greedy tokens
  equal the JAX package's ``(1, 2)`` mesh engine's (and its one-device
  engine's); flat = dense chunked = monolithic across ranks;
- each rank's weights and pools are its shards: the engine's leaves
  those of ``shard_prepacked`` of the packed whole tree at its mesh
  coordinate, within ``local_shape`` of their specs, the pools the rank's
  pages and a trash slot; the shards of every parameter (unpacked and
  prepacked) and pool put back together give the whole tree, no tile
  split, and packing the rank's unpacked shard gives its prepacked one;
- a biased row-parallel linear with a tanh-GELU epilogue equals the whole
  product (the epilogue applied once, after the sum; applied to each
  partial it would differ by whole units); ``copy_pages`` by owner
  equals the whole pool's copy; a drain whose pages all sit on rank 0
  writes no page of rank 1 and keeps the one-rank tokens; the runtime
  sanitizer (on in the worlds) checks every rank's writes;
- the partial ragged attention's plain version, combined over any split
  of the page range, equals the whole plain version and the JAX
  package's ``ragged_attention`` (its Pallas kernel in interpret mode),
  and a row with no page on a rank gives zeros and ``-inf``; mmt4d's
  float32 partial;
- each case the port does not serve across ranks raises
  ``NotImplementedError`` naming its ROADMAP item (a ``fake`` process
  group of 2 ranks in this process).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_tp_world as W
from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.kernels.ragged_attn.kernel import ragged_attention_kernel_call
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.core.hardware import query
from repro_torch.core.layout import LayoutPolicy, make_layout
from repro_torch.core.linear import prepack_params
from repro_torch.core.mmt4d import mmt4d
from repro_torch.distributed import sharding
from repro_torch.kernels.ragged_attn.ops import ragged_attention_partial
from repro_torch.kernels.ragged_attn.ref import (combine_partials,
                                                 ragged_attention_ref)
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import transformer as tfm

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("flat greedy", "flat sampled", "dense greedy", "monolithic greedy")
GREEDY = ("flat greedy", "dense greedy", "monolithic greedy")

# the JAX package's engine on a (1, 2) mesh of the host's devices, and on
# one device: each greedy family's tokens, as JSON
_JAX = r"""
import json, os, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
import _torch_tp_world as W
from repro.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro.models.model import build_model
from repro.serving.engine import Engine
cfg = W.widened(reduced_config(get_config("smollm2-135m"), layers=2))
with np.load(sys.argv[2]) as z:
    params = W.unflatten({k: jnp.asarray(z[k]) for k in z.files})
mesh = jax.make_mesh((1, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
for label, msh in (("mesh", mesh), ("one", None)):
    for fam, kw in W.FAMILIES.items():
        m = build_model(cfg, RunConfig(**W.F32), ShapeSpec(*W.SHAPE), mesh=msh)
        with (jax.set_mesh(msh) if msh is not None else open(os.devnull)):
            eng = Engine(m, params, mesh=msh, **W.ENGINE, **kw)
            rids = [eng.add_request(p, k) for p, k in W.trace(cfg.vocab)]
            fin = {r.rid: r for r in eng.drain()}
        out[f"{label} {fam} greedy"] = [[int(t) for t in fin[r].out_tokens] for r in rids]
json.dump(out, open(sys.argv[3], "w"))
"""


def _flat_npz(tree, path):
    flat = {}

    def rec(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                rec(v, f"{pre}/{k}" if pre else k)
        else:
            flat[pre] = np.asarray(t)

    rec(tree, "")
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    jcfg = W.widened(jreduced(jget_config("smollm2-135m"), layers=2))
    jm = jbuild_model(jcfg, JRun(**W.F32), JShape(*W.SHAPE))
    _flat_npz(jm.init(jax.random.PRNGKey(0)), d / "params.npz")
    env = dict(os.environ, OMP_NUM_THREADS="1", REPRO_SANITIZE="1",
               PYTHONPATH=os.path.join(ROOT, "src"))
    procs = {"jax": [subprocess.Popen(
        [sys.executable, "-c", _JAX, ROOT, str(d / "params.npz"),
         str(d / "jax.json")],
        env=dict(env, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=2"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]}
    for world in (2, 3):
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "_torch_tp_world.py"),
             str(r), str(world), str(d / f"store{world}"), str(d / "params.npz"),
             str(d / f"out{world}")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    params = W.load_params(str(d / "params.npz"))
    one = W.serve(params)                          # meanwhile, on one rank
    one_short = W.drain(_engine(params, None, num_pages=64, chunk_tokens=16),
                        W.short_trace(W.config().vocab))
    logs = {k: [p.communicate(timeout=900)[0] for p in ps]
            for k, ps in procs.items()}
    for k, ps in procs.items():
        for p, log in zip(ps, logs[k]):
            assert p.returncode == 0, f"{k}:\n{log[-6000:]}"
    return {"one": one, "one_short": one_short, "params": params,
            "jax": json.loads((d / "jax.json").read_text()),
            **{w: [torch.load(d / f"out{w}.{r}.pt", weights_only=False)
                   for r in range(w)] for w in (2, 3)}}


def _engine(params, mesh, **kw):
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    m = build_model(W.config(), RunConfig(**W.F32), ShapeSpec(*W.SHAPE),
                    device="cpu", mesh=mesh)
    return Engine(m, params, device="cpu", mesh=mesh, max_slots=3,
                  page_tokens=8, **kw)


def _max_err(a, b):
    assert len(a) == len(b)
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


# ---------------------------------------------------------------- the drains


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("key", KEYS)
def test_ranks_serve_the_one_rank_tokens(runs, world, key):
    want = runs["one"][key]
    for r, res in enumerate(runs[world]):
        got = res["serve"][key]
        assert got["tokens"] == want["tokens"], (r, key)
        assert got["reasons"] == want["reasons"]
        assert got["preemptions"] == want["preemptions"]
        assert _max_err(got["logits"], want["logits"]) <= 1e-5, (r, key)
        assert got["captures"] == {"decode": 0, "paged": 0, "flat": 0}


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("key", GREEDY)
def test_ranks_serve_the_jax_mesh_engine_tokens(runs, world, key):
    jx = runs["jax"]
    assert jx[f"mesh {key}"] == jx[f"one {key}"]
    assert runs[world][0]["serve"][key]["tokens"] == jx[f"mesh {key}"]


@pytest.mark.parametrize("world", [2, 3])
def test_collectives_a_model_call(runs, world):
    """A layer's collectives: one gather of Q, K and V together, one of
    the ranks' attention shares, one sum each of the O and down products'
    partials where the rules cut them; one gather of the logits where the
    vocab divides.  Over 3 ranks d_ff = 1024 and the vocab of 512 do not
    divide: the MLP and the head run whole on every rank."""
    per_call = {2: 4 * 2 + 1, 3: 3 * 2}[world]
    for res in runs[world]:
        for key in KEYS:
            n, calls = res["serve"][key]["collectives"]
            assert n == per_call * calls, (key, n, calls)


@pytest.mark.parametrize("world", [2, 3])
def test_flat_equals_dense_equals_monolithic_across_ranks(runs, world):
    serve = runs[world][0]["serve"]
    assert len({json.dumps(serve[k]["tokens"]) for k in GREEDY}) == 1


# ---------------------------------------------------------------- the shards


def _coord(world, rank):
    return AbstractMesh((1, world), ("data", "model")), {"data": 0, "model": rank}


def _whole():
    cfg = W.config()
    from repro_torch.models.model import build_model
    m = build_model(cfg, RunConfig(**W.F32), ShapeSpec(*W.SHAPE), device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("world", [2, 3])
def test_each_rank_holds_its_shards(runs, world):
    m, params = _whole()
    mesh = AbstractMesh((1, world), ("data", "model"))
    specs = sharding.param_specs(params, m.run, mesh)
    packed = prepack_params(params, m.ctx)
    caches = tfm.init_paged_caches(m.cfg, W.NUM_PAGES, 8, 3, torch.float32, "meta")
    cspec = sharding.cache_specs(caches, mesh, m.run, 3)["p0"]["kv"]["k_pages"]
    assert cspec == (None, "model", None, None, None)
    flat_specs = sharding.tree_paths(specs)
    split = 0
    for rank, res in enumerate(runs[world]):
        shapes = res["serve"]["shapes"]
        _, coord = _coord(world, rank)
        want = sharding.tree_paths(sharding.shard_prepacked(packed, specs, mesh, coord))
        assert set(shapes["params"]) == set(want)
        for path, v in want.items():
            got = shapes["params"][path]
            assert got == (tuple(v.shape) if isinstance(v, torch.Tensor) else v), path
            if path.endswith("/w_pack"):         # within the spec's local shape
                wspec = flat_specs[path[:-len("_pack")]]
                whole = sharding.tree_paths(packed)[path].shape
                k_ent, n_ent = sharding._full(wspec, len(whole) - 2)[-2:]
                lim = sharding.local_shape(
                    whole, (*(None,) * (len(whole) - 4), n_ent, k_ent), mesh)
                assert all(g <= w for g, w in zip(got, lim)), path
                split += got != tuple(whole)
        lo, count = shapes["kv_shard"]
        assert (lo, lo + count) == sharding.unit_range(W.NUM_PAGES, "model",
                                                       mesh, coord)
        assert count == sharding.local_shape(caches["p0"]["kv"]["k_pages"].shape,
                                             cspec, mesh)[1]
        assert shapes["pool"][1] == count + 1           # and the trash slot
    # cut: over 2 ranks every linear (Q and O over 3 tiles: 2 and 1); over
    # 3 the attention's (K/V over 2 tiles: 1, 1 and none), while d_ff =
    # 1024 does not divide by 3, so the rules leave the MLP whole
    assert split == {2: 7, 3: 4}[world] * world


@pytest.mark.parametrize("world", [2, 3])
def test_shards_put_back_together_give_the_whole_tree(world):
    m, params = _whole()
    mesh = AbstractMesh((1, world), ("data", "model"))
    specs = sharding.param_specs(params, m.run, mesh)
    packed = sharding.tree_paths(prepack_params(params, m.ctx))
    whole = sharding.tree_paths(params)
    shards = [sharding.shard_params(params, specs, mesh, _coord(world, r)[1],
                                    m.ctx.layout) for r in range(world)]
    pshards = [sharding.shard_prepacked(prepack_params(params, m.ctx), specs,
                                        mesh, _coord(world, r)[1])
               for r in range(world)]
    for r in range(world):                    # packing the shard = the packed shard
        a = sharding.tree_paths(prepack_params(shards[r], m.ctx))
        b = sharding.tree_paths(pshards[r])
        assert a.keys() == b.keys()
        for k in a:
            assert (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                    else a[k] == b[k]), k
    for path, leaf in whole.items():
        parts = [sharding.tree_paths(s)[path] for s in shards]
        split = sharding.tree_paths(shards[0]).get(path[:-2] + "/w_split") \
            if path.endswith("/w") else None
        if split is None:
            assert all(torch.equal(p, leaf) for p in parts), path
            continue
        dim = -1 if split[0] == "col" else -2
        assert torch.equal(torch.cat(parts, dim=dim), leaf), path
        held = [p.shape[dim] for p in parts if p.shape[dim]]
        assert all(n % 128 == 0 for n in held[:-1]), path   # whole tiles
    for path, leaf in packed.items():
        if not path.endswith("/w_pack"):
            continue
        parts = [sharding.tree_paths(s)[path] for s in pshards]
        split = sharding.tree_paths(pshards[0]).get(
            path[:-len("/w_pack")] + "/w_split")
        dim = None if split is None else (-4 if split[0] == "col" else -3)
        got = parts[0] if dim is None else torch.cat(parts, dim=dim)
        assert torch.equal(got, leaf), path       # whole tiles: no tile split
    caches = tfm.init_paged_caches(m.cfg, W.NUM_PAGES, 8, 3, torch.float32, "cpu")
    g = torch.Generator().manual_seed(2)
    caches = tfm.tree_map(lambda t: torch.randn(t.shape, generator=g), caches)
    cspecs = sharding.cache_specs(caches, mesh, m.run, 3)
    parts = [sharding.shard_tree(caches, cspecs, mesh, _coord(world, r)[1])
             for r in range(world)]
    for path, leaf in sharding.tree_paths(caches).items():
        got = torch.cat([sharding.tree_paths(p)[path] for p in parts], dim=-4)
        assert torch.equal(got, leaf), path


@pytest.mark.parametrize("world", [2, 3])
def test_from_jax_params_gives_one_rank_its_shard(world):
    jm = jbuild_model(W.widened(jreduced(jget_config("smollm2-135m"), layers=2)),
                      JRun(**W.F32), JShape(*W.SHAPE))
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(1)))
    from repro_torch.weights import from_jax_params
    m, _ = _whole()
    whole = from_jax_params(tree)
    for rank in range(world):
        mesh, coord = _coord(world, rank)
        got = sharding.tree_paths(from_jax_params(
            tree, mesh=mesh, run=m.run, layout_of=m.ctx.layout, coord=coord))
        want = sharding.tree_paths(sharding.shard_params(
            whole, sharding.param_specs(whole, m.run, mesh), mesh, coord,
            m.ctx.layout))
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert (torch.equal(got[k], v) if isinstance(v, torch.Tensor)
                    else got[k] == v), k


# ---------------------------------------------------------------- inside the worlds


@pytest.mark.parametrize("world", [2, 3])
def test_row_parallel_bias_and_activation_once_after_the_sum(runs, world):
    for res in runs[world]:
        rp = res["row_parallel"]
        assert rp["split"][0] == "row" and rp["split"][2] > rp["split"][1]
        assert rp["err"] <= 1e-5
        assert rp["wrong_err"] > 0.1          # each partial's epilogue is wrong


@pytest.mark.parametrize("world", [2, 3])
def test_copy_pages_by_owner(runs, world):
    assert all(res["copy_by_owner"] for res in runs[world])


def test_drain_whose_pages_all_sit_on_rank0(runs):
    toks, _, logits = runs["one_short"]
    r0, r1 = (res["rank0_pages"] for res in runs[2])
    assert (r0["kv_shard"], r1["kv_shard"]) == ((0, 32), (32, 32))
    assert r0["written"] and not r1["written"]
    for r in (r0, r1):
        assert r["tokens"] == toks
        assert _max_err(r["logits"], logits) <= 1e-5


@pytest.mark.parametrize("world", [2, 3])
def test_sanitizer_checks_every_ranks_writes(runs, world):
    for res in runs[world]:
        assert res["sanitized"] > 0


def test_sanitizer_refuses_a_write_outside_the_ranks_pages():
    from repro_torch.analysis.sanitize import SanitizerError, StepSanitizer
    san = StepSanitizer.__new__(StepSanitizer)
    san.kv_shard, san.local_pages, san.rank_writes = (6, 6), 7, 0
    san._check_rank(np.array([6, 11, 3, 0]), np.ones(4, bool), "step")
    assert san.rank_writes == 4
    san.local_pages = 6                       # no trash slot
    with pytest.raises(SanitizerError, match="trash slot"):
        san._check_rank(np.array([6]), np.ones(1, bool), "step")


# ---------------------------------------------------------------- the kernels' plain forms


def _attn_case(seed=0, hq=8, hkv=2, dh=64, t=16, pages=24, mp=5, w=40):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((w, hq, dh)).astype(np.float32)
    kp = rng.standard_normal((pages, t, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((pages, t, hkv, dh)).astype(np.float32)
    bt = (rng.permutation(pages - 1)[:3 * mp] + 1).astype(np.int32).reshape(3, mp)
    row_ids = np.full(w, -1, np.int32)
    q_pos = np.zeros(w, np.int32)
    row_ids[0], q_pos[0] = 0, 70                     # a decode row, 5 pages
    row_ids[1:21], q_pos[1:21] = 1, np.arange(20, 40)  # a chunk
    row_ids[21:30], q_pos[21:30] = 2, np.arange(9)   # a fresh prefill
    return [torch.from_numpy(a) for a in (q, kp, vp, bt, row_ids, q_pos)]


@pytest.mark.parametrize("cuts", [(0, 24), (0, 12, 24), (0, 5, 13, 24),
                                  (0, 1, 2, 23, 24), (0, 6, 12, 18, 24)],
                         ids=lambda c: "-".join(map(str, c)))
def test_partial_ragged_combined_equals_whole_and_jax(cuts):
    q, kp, vp, bt, row_ids, q_pos = _attn_case(seed=len(cuts))
    outs, lses = [], []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        local_k = torch.cat([kp[lo:hi], torch.zeros_like(kp[:1])])   # + trash slot
        local_v = torch.cat([vp[lo:hi], torch.zeros_like(vp[:1])])
        o, lse = ragged_attention_partial(q, local_k, local_v, block_tables=bt,
                                          row_ids=row_ids, q_pos=q_pos,
                                          page_lo=lo, page_count=hi - lo)
        assert o.dtype == q.dtype and lse.dtype == torch.float32
        outs.append(o)
        lses.append(lse)
    got = combine_partials(outs, lses)
    assert torch.isfinite(got).all()
    valid = row_ids >= 0
    whole = ragged_attention_ref(q, kp, vp, block_tables=bt, row_ids=row_ids,
                                 q_pos=q_pos)
    torch.testing.assert_close(got[valid], whole[valid], atol=1e-5, rtol=1e-5)
    jx = np.asarray(ragged_attention_kernel_call(
        jnp.asarray(q.numpy()), jnp.asarray(kp.numpy()), jnp.asarray(vp.numpy()),
        block_tables=jnp.asarray(bt.numpy()), row_ids=jnp.asarray(row_ids.numpy()),
        q_pos=jnp.asarray(q_pos.numpy()), interpret=True))
    np.testing.assert_allclose(got[valid].numpy(), jx[valid.numpy()], atol=1e-5,
                               rtol=1e-5)
    assert not got[~valid].any()                     # padding: zeros


def test_partial_ragged_row_without_pages_gives_zero_and_minus_inf():
    q, kp, vp, bt, row_ids, q_pos = _attn_case(seed=7)
    held = set(bt[0].tolist())                       # row 0's pages
    lo = max(held) + 1 if max(held) < 23 else 0
    o, lse = ragged_attention_partial(q, kp[lo:], vp[lo:], block_tables=bt,
                                      row_ids=row_ids, q_pos=q_pos, page_lo=lo,
                                      page_count=24 - lo)
    rows = (row_ids == 0) | (row_ids < 0)
    if lo == 0:
        pytest.skip("the seed put row 0 on the last page")
    assert not o[rows].any() and torch.isinf(lse[rows]).all()
    assert (lse[rows] < 0).all()
    # the combine weighs such a share 0 and gives no NaN
    got = combine_partials([o, torch.zeros_like(o)], [lse, torch.full_like(lse, -torch.inf)])
    assert torch.isfinite(got).all() and not got[rows].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_mmt4d_partial_is_the_float32_sum(dtype):
    g = torch.Generator().manual_seed(3)
    ap = torch.randn((3, 2, 16, 128), generator=g).to(dtype)
    bp = (torch.randn((2, 2, 128, 128), generator=g) * 0.1).to(dtype)
    got = mmt4d(ap, bp, unpack_to=(40, 200), partial=True)
    assert got.dtype == torch.float32 and got.shape == (40, 200)
    want = torch.einsum("mkab,nkcb->mnac", ap.float(), bp.float())
    want = want.permute(0, 2, 1, 3).reshape(48, 256)[:40, :200]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="no bias"):
        mmt4d(ap, bp, activation="gelu", partial=True)


# ---------------------------------------------------------------- the refusals


@pytest.fixture
def fake_pair():
    """A ``fake`` process group of 2 ranks in this process (no traffic):
    enough to build what a refusal needs."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        yield lambda shape: init_device_mesh("cpu", shape,
                                             mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _model(arch, mesh, **run):
    from repro_torch.models.model import build_model
    cfg = W.config() if arch is None else reduced_config(get_config(arch), layers=2)
    return build_model(cfg, RunConfig(**{**W.F32, **run}), ShapeSpec(*W.SHAPE),
                       device="cpu", mesh=mesh)


REFUSED = {
    "data-axis": ("A13.1", lambda mk, p: _engine(p, mk((2, 1)))),
    "heads-over-model": ("A13.2", lambda mk, p: _engine_run(
        p, mk((1, 2)), dict(seq_shard_kv=False))),
    "moe": ("A13.3", lambda mk, p: _model("qwen3-moe-235b-a22b", mk((1, 2)))),
    "recurrent": ("A13.4", lambda mk, p: _model("rwkv6-1.6b", mk((1, 2)))),
    "hybrid": ("A13.4", lambda mk, p: _model("jamba-v0.1-52b", mk((1, 2)))),
    "prefix-cache": ("A13.5", lambda mk, p: _engine(p, mk((1, 2)), prefix_cache=True,
                                                    chunk_tokens=16)),
    "speculative": ("A13.5", lambda mk, p: _engine(p, mk((1, 2)), spec_tokens=2,
                                                   chunk_tokens=16)),
    "capture": ("A13.6", lambda mk, p: _capture(p, mk((1, 2)))),
    # the full-sequence forward and the train step run across ranks
    # (test_torch_tp_train.py); what stays of A13.7 is the Trainer
    "forward": ("A13.7", lambda mk, p: _trainer(_model(None, mk((1, 2))))),
    # whisper and InternVL2 serve across ranks through the static loop
    # (test_torch_tp_decode.py); what stays refused is their training
    "whisper": ("A13.10", lambda mk, p: _train_step(_model("whisper-small", mk((1, 2))))),
    "internvl2": ("A13.10", lambda mk, p: _train_step(_model("internvl2-26b",
                                                             mk((1, 2))))),
    # the static loop runs across a model axis; an engine on a data axis,
    # of a static family too, stays refused
    "generate-static": ("A13.1", lambda mk, p: _static_engine(mk((2, 1)))),
    "prepack-off": ("A13.9", lambda mk, p: _engine(p, mk((1, 2)), prepack=False)),
}


def _engine_run(params, mesh, run):
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    m = build_model(W.config(), RunConfig(**{**W.F32, **run}), ShapeSpec(*W.SHAPE),
                    device="cpu", mesh=mesh)
    return Engine(m, params, device="cpu", mesh=mesh, max_slots=3, page_tokens=8)


def _static_engine(mesh):
    from repro_torch.serving.engine import Engine
    return Engine(_model("whisper-small", mesh), {}, device="cpu", mesh=mesh)


def _train_step(model):
    from repro_torch.training.optimizer import make_optimizer
    from repro_torch.training.step import make_train_step
    return make_train_step(model, make_optimizer(model.run, 10), model.run)


def _trainer(model):
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.training.trainer import Trainer
    return Trainer(model, SyntheticLM(model.cfg, model.shape, seed=0), model.run)


def _capture(params, mesh):
    from repro_torch.models.model import capture_graph
    return capture_graph(_model(None, mesh), None, lambda: None)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_across_ranks(fake_pair, case):
    item, make = REFUSED[case]
    params = _whole()[1]
    with pytest.raises(NotImplementedError, match=item.replace(".", r"\.")):
        make(fake_pair, params)


def test_refused_deadline_clock_and_foreign_model(fake_pair):
    params = _whole()[1]
    mesh = fake_pair((1, 2))
    with pytest.raises(ValueError, match="own clock"):
        _engine(params, mesh).generate({"tokens": np.zeros((1, 4), np.int32)}, 2,
                                       deadline_s=1.0)
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine
    m = build_model(W.config(), RunConfig(**W.F32), ShapeSpec(*W.SHAPE), device="cpu")
    with pytest.raises(ValueError, match="not built on this mesh"):
        Engine(m, params, device="cpu", mesh=mesh)
