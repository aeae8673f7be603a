"""The port's placements over real process groups and its engine on a
mesh, on the CPU (gloo; no JAX here: the rules are held to the reference
in ``test_torch_sharding.py``):

- 4 ranks (one process each, ``FileStore`` rendezvous) on a ``(2, 2, 1)``
  ``pod x data x model`` mesh, where the batch and cache specs split one
  dim over two axes, and on a ``(1, 4)`` ``data x model`` mesh:
  ``distribute_tensor`` of a reduced config's parameters (SmolLM2 and
  Qwen3-MoE's expert stacks), its dense decode caches and a batch under
  ``named(...)`` gives each rank the slice its spec names (the dims' axes
  major to minor, over the rank's mesh coordinate), ``device_bytes``
  counts that slice, and ``full_tensor()`` gives the leaf back bit for
  bit;
- ``Engine(mesh=)`` over a one-rank gloo mesh (``make_elastic_mesh``:
  ``(1, 1)``) drains reduced SmolLM2 in f32 through each step family as
  the engine without a mesh does, bit for bit: tokens, finish reasons,
  the step counts, signatures and captures; its caches carry
  ``cache_specs``, under which the one rank holds each leaf whole; a
  mesh with a data axis of two ranks is refused (``NotImplementedError``),
  and so is a ``DeviceMesh`` with a ``model`` axis of two ranks for a moe
  model, and a dense model's full-sequence forward there (serving across
  ranks itself: ``test_torch_tp_serving.py``).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import AbstractMesh, make_elastic_mesh
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)

_RANK = r"""
import math, sys, torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[4])
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.distributed import sharding
from repro_torch.models.model import build_model
torch.set_num_threads(1)
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
checked = 0
try:
    for shape, names in (((2, 2, 1), ("pod", "data", "model")),
                         ((1, 4), ("data", "model"))):
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        coord = dict(zip(names, mesh.get_coordinate()))
        sizes = dict(zip(names, shape))
        for arch in ("smollm2-135m", "qwen3-moe-235b-a22b"):
            run = RunConfig(param_dtype="float32", compute_dtype="float32")
            cfg = reduced_config(get_config(arch), layers=2)
            m = build_model(cfg, run, ShapeSpec("d", 64, 8, "decode"), device="cpu")
            params = m.init(torch.Generator().manual_seed(0))
            caches = m.init_cache(8, 64)
            g = torch.Generator().manual_seed(1)
            caches = {k: v for k, v in sharding.tree_paths(caches).items()}
            caches = {k: torch.randn(v.shape, generator=g) for k, v in caches.items()}
            batch = {"tokens": torch.randint(0, 100, (8, 16), generator=g)}
            for tree, specs in ((params, sharding.param_specs(params, run, mesh)),
                                (caches, {k: s for k, s in sharding.tree_paths(
                                    sharding.cache_specs(
                                        m.init_cache(8, 64), mesh, run, 8)).items()}),
                                (batch, sharding.batch_specs(batch, mesh))):
                placed = sharding.distribute(tree, mesh, specs)
                flat_t, flat_p = sharding.tree_paths(tree), sharding.tree_paths(placed)
                flat_s = sharding.tree_paths(specs)
                for path, leaf in flat_t.items():
                    dt, spec = flat_p[path], flat_s[path]
                    want = leaf
                    for d, entry in enumerate(spec):
                        axes = sharding._axes(entry)
                        if not axes:
                            continue
                        n = math.prod(sizes[a] for a in axes)
                        idx = 0
                        for a in axes:              # major to minor
                            idx = idx * sizes[a] + coord[a]
                        want = want.chunk(n, d)[idx]
                    local = dt.to_local()
                    assert torch.equal(local, want), (path, spec)
                    assert sharding.device_bytes(leaf, spec, mesh) == \
                        local.numel() * local.element_size(), path
                    assert torch.equal(dt.full_tensor(), leaf), path
                    checked += 1
    open(f"{out}.{rank}", "w").write(str(checked))
finally:
    dist.destroy_process_group()
"""


def test_placements_over_gloo_give_each_rank_its_slice(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r),
                               str(tmp_path / "store"), str(tmp_path / "ok"),
                               os.path.join(ROOT, "src")],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    outs = [p.communicate(timeout=180)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    counts = {int((tmp_path / f"ok.{r}").read_text()) for r in range(4)}
    assert len(counts) == 1 and counts.pop() > 50


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, torn down after the test."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "pg"), 1),
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _trace(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(n)), int(k))
            for n, k in zip(rng.integers(3, 30, 5), rng.integers(3, 9, 5))]


FAMILIES = {"flat": dict(chunk_tokens=16, token_budget=24),
            "dense": dict(chunk_tokens=16, flat=False), "monolithic": {}}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_engine_on_one_rank_mesh_equals_no_mesh(family, one_rank):
    cfg = reduced_config(get_config("smollm2-135m"), layers=2)
    shape = ShapeSpec("serve", 64, 3, "decode")
    mesh = make_elastic_mesh(device_type="cpu")
    assert tuple(mesh.mesh.shape) == (1, 1)
    outs = []
    for with_mesh in (False, True):
        m = build_model(cfg, RunConfig(**F32), shape, device="cpu",
                        mesh=mesh if with_mesh else None)
        params = m.init(torch.Generator().manual_seed(0))
        eng = Engine(m, params, device="cpu", max_slots=3, page_tokens=8,
                     mesh=mesh if with_mesh else None, **FAMILIES[family])
        for prompt, k in _trace(cfg.vocab):
            eng.add_request(prompt, k)
        done = eng.drain()
        st = eng.stats()
        outs.append(([(r.rid, list(r.out_tokens), r.finish_reason) for r in done],
                     st["steps"], dict(m.trace_counts), st["captures"]))
        if with_mesh:
            assert m.ctx.mesh_axes == ("data", "model")
            assert (m.ctx.dp_size, m.ctx.tp_size, m.ctx.dp_local) == (1, 1, True)
            specs = eng.cache_specs["p0"]["kv"]
            assert specs["k_pages"] == (None, "model", None, None, None)
            # one rank holds each leaf whole
            assert (sharding.device_bytes(eng.caches, eng.cache_specs, mesh)
                    == sum(t.numel() * t.element_size()
                           for t in sharding.tree_paths(eng.caches).values()))
    assert outs[0] == outs[1]


def test_engine_refuses_a_mesh_of_more_ranks():
    cfg = reduced_config(get_config("smollm2-135m"), layers=2)
    m = build_model(cfg, RunConfig(**F32), ShapeSpec("serve", 64, 3, "decode"),
                    device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="mesh of 2 ranks"):
        Engine(m, params, device="cpu", max_slots=3, chunk_tokens=16,
               mesh=AbstractMesh((2, 1), ("data", "model")))


def test_model_refuses_a_tensor_parallel_device_mesh():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
        with pytest.raises(NotImplementedError, match="'model' axis of 2"):
            build_model(reduced_config(get_config("qwen3-moe-235b-a22b"), layers=2),
                        RunConfig(**F32), ShapeSpec("serve", 64, 3, "decode"),
                        device="cpu", mesh=mesh)
        # the dense family serves and trains across the ranks; the Trainer
        # across ranks is refused
        m = build_model(reduced_config(get_config("smollm2-135m"), layers=2),
                        RunConfig(**F32), ShapeSpec("serve", 64, 3, "decode"),
                        device="cpu", mesh=mesh)
        assert (m.ctx.tp.rank, m.ctx.tp.size) == (0, 2)
        from repro_torch.data.pipeline import SyntheticLM
        from repro_torch.training.trainer import Trainer
        with pytest.raises(NotImplementedError, match="A13.7"):
            Trainer(m, SyntheticLM(m.cfg, m.shape, seed=0), RunConfig(**F32))
    finally:
        dist.destroy_process_group()
