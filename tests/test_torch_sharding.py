"""The port's sharding rules (``repro_torch/distributed/sharding.py``) and
meshes (``repro_torch/launch/mesh.py``) against the JAX package's, on the
CPU, at full width and without a weight allocated:

- every one of the eleven configs' trees on both sides (the reference's
  ``jax.eval_shape`` of its init and train state, the port's meta trees),
  on ``AbstractMesh``es of the pod ``(16, 16)`` and multipod ``(2, 16,
  16)`` topologies, FSDP on and off: ``param_specs``, ``state_specs``
  (float32 and 8-bit moments, with the compression error buffer),
  ``cache_specs`` (the dense decode caches at ``decode_32k``'s batch, a
  paged pool with ``seq_shard_kv`` on and off, and a batch of one, which
  shards the sequence over every axis) and ``batch_specs`` (``train_4k``
  and a batch the data axes do not divide), each spec equal to
  ``tuple(PartitionSpec)`` leaf for leaf, paths, shapes and dtypes equal;
- the bytes each device holds, leaf for leaf: the port's
  ``device_bytes`` from its specs against the reference's specs applied
  to its abstract shapes, computed here;
- ``make_elastic_mesh`` over worlds of 1, 6, 8, 16 and 24 ranks (the
  fake process group, one process) against the reference's ``(data,
  model)``, the reference run in a subprocess with forced host devices;
  ``make_production_mesh`` over a fake world of 256 and 512 ranks, and
  its refusal of a world that does not fill it;
- ``named``'s placements, and its refusal of axes out of mesh order.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JAbstractMesh

from repro.configs import ARCHS
from repro.configs import RunConfig as JRun
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.distributed import sharding as jsharding
from repro.models.model import build_model as jbuild_model
from repro.training import compression as jcompression
from repro.training.optimizer import make_optimizer as jmake_optimizer
from repro.training.train_state import TrainState as JTrainState
from repro_torch.configs import SHAPES, RunConfig, ShapeSpec, get_config
from repro_torch.core.hardware import presets
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as pmesh
from repro_torch.launch.dryrun import MetaGenerator
from repro_torch.models.model import build_model
from repro_torch.training import compression
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.train_state import TrainState

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
PAGED = ("dense", "moe", "ssm", "hybrid")   # the families served by pages
POOL = (65, 16, 4)                          # pages, page tokens, slots


def _meshes(name):
    sizes, names = MESHES[name]
    return JAbstractMesh(sizes, names), pmesh.AbstractMesh(sizes, names)


def _runs(fsdp, **kw):
    return JRun(fsdp=fsdp, **kw), RunConfig(fsdp=fsdp, **kw)


_TREES = {}


def _trees(arch):
    """Both packages' trees for ``arch`` at full width: params, the train
    state (float32 and 8-bit moments, with the error buffer), the dense
    decode caches at decode_32k, a paged pool, the train_4k batch."""
    if arch in _TREES:
        return _TREES[arch]
    jcfg, cfg = jget_config(arch), get_config(arch)
    jdec = jbuild_model(jcfg, JRun(), JSHAPES["decode_32k"])
    dec = build_model(cfg, RunConfig(), SHAPES["decode_32k"],
                      hw=presets["tpu_v5e"], device="meta")
    jparams = jax.eval_shape(jdec.init, jax.random.PRNGKey(0))
    params = dec.init(MetaGenerator())
    out = {"params": (jparams, params)}
    for key, eightbit in (("state", False), ("state8", True)):
        jopt = jmake_optimizer(JRun(adam_8bit=eightbit))
        opt = make_optimizer(RunConfig(adam_8bit=eightbit))
        jstate = jax.eval_shape(lambda p: JTrainState.create(p, jopt), jparams)
        jstate.opt_state["err"] = jax.eval_shape(jcompression.init_error_buffer,
                                                 jparams)
        state = TrainState.create(params, opt)
        state.opt_state["err"] = compression.init_error_buffer(params)
        out[key] = (jstate, state)
    out["caches"] = (jdec.input_specs("decode")["caches"],
                     dec.input_specs("decode")["caches"])
    if cfg.family in PAGED:
        out["paged"] = (jax.eval_shape(lambda: jdec.init_paged_cache(*POOL)),
                        dec.init_paged_cache(*POOL))
    jtr = jbuild_model(jcfg, JRun(), JSHAPES["train_4k"])
    tr = build_model(cfg, RunConfig(), SHAPES["train_4k"], hw=presets["tpu_v5e"],
                     device="meta")
    out["batch"] = (jtr.input_specs("train"), tr.input_specs("train"))
    _TREES[arch] = out
    return out


def _jflat(tree):
    """{'a/b': leaf} of a reference tree (dicts; a TrainState's fields)."""
    if isinstance(tree, JTrainState):
        return {**{"step": tree.step},
                **{f"params/{k}": v for k, v in _jflat(tree.params).items()},
                **{f"opt_state/{k}": v for k, v in _jflat(tree.opt_state).items()}}
    return jsharding.tree_paths(tree)


def _pflat(tree):
    if isinstance(tree, TrainState):
        return {**{"step": tree.step},
                **{f"params/{k}": v for k, v in _pflat(tree.params).items()},
                **{f"opt_state/{k}": v for k, v in _pflat(tree.opt_state).items()}}
    return sharding.tree_paths(tree)


def _local_bytes(shape, spec, sizes, itemsize):
    """The reference's spec applied to its abstract shape: one device's
    shard in bytes."""
    spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    n = 1
    for dim, ax in zip(shape, spec):
        axes = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
        n *= -(-dim // int(np.prod([sizes[a] for a in axes] or [1])))
    return n * itemsize


def _compare(jtree, jspecs, tree, specs, sizes, pmesh_):
    """Paths, shapes and dtypes equal; every spec equal to the reference's;
    the bytes per device equal leaf for leaf."""
    jt, jsp = _jflat(jtree), _jflat(jspecs)
    pt, psp = _pflat(tree), _pflat(specs)
    assert sorted(jt) == sorted(pt)
    assert sorted(jsp) == sorted(psp) == sorted(pt)
    for path in pt:
        jl, pl = jt[path], pt[path]
        if path == "step":          # a 0-d int32 in JAX, a host int in the port
            assert tuple(jsp[path]) == psp[path] == ()
            continue
        assert tuple(jl.shape) == tuple(pl.shape), path
        assert np.dtype(jl.dtype).itemsize == pl.element_size(), path
        assert tuple(jsp[path]) == psp[path], (path, jsp[path], psp[path])
        want = _local_bytes(jl.shape, jsp[path], sizes, np.dtype(jl.dtype).itemsize)
        got = sharding.device_bytes(pl, psp[path], pmesh_)
        assert got == want, path
    return len(pt)


CASES = [pytest.param(arch, mesh, fsdp, id=f"{arch}-{mesh}-{'fsdp' if fsdp else 'nofsdp'}")
         for arch in ARCHS for mesh in MESHES for fsdp in (True, False)]


@pytest.mark.parametrize("arch,mesh,fsdp", CASES)
def test_param_and_state_specs_match_reference(arch, mesh, fsdp):
    t = _trees(arch)
    jm, pm = _meshes(mesh)
    jrun, run = _runs(fsdp)
    sizes = dict(jm.shape)
    jp, pp = t["params"]
    assert _compare(jp, jsharding.param_specs(jp, jrun, jm), pp,
                    sharding.param_specs(pp, run, pm), sizes, pm) > 3
    for key, eightbit in (("state", False), ("state8", True)):
        jrun, run = _runs(fsdp, adam_8bit=eightbit)
        js, ps = t[key]
        _compare(js, jsharding.state_specs(js, jrun, jm), ps,
                 sharding.state_specs(ps, run, pm), sizes, pm)
    # the 8-bit scales drop their parameter's last axis
    p8 = sharding.state_specs(t["state8"][1], run, pm)
    for path, spec in sharding.tree_paths(p8.params).items():
        assert sharding.tree_paths(p8.opt_state["m_s"])[path] == spec[:-1]


@pytest.mark.parametrize("arch,mesh,seq", [
    pytest.param(a, m, s, id=f"{a}-{m}-{'seqkv' if s else 'headkv'}")
    for a in ARCHS for m in MESHES for s in (True, False)])
def test_cache_and_batch_specs_match_reference(arch, mesh, seq):
    t = _trees(arch)
    jm, pm = _meshes(mesh)
    jrun, run = _runs(True, seq_shard_kv=seq)
    sizes = dict(jm.shape)
    jc, pc = t["caches"]
    for batch in (JSHAPES["decode_32k"].global_batch, 1):
        _compare(jc, jsharding.cache_specs(jc, jm, jrun, batch), pc,
                 sharding.cache_specs(pc, pm, run, batch), sizes, pm)
    if "paged" in t:
        jpool, pool = t["paged"]
        _compare(jpool, jsharding.cache_specs(jpool, jm, jrun, POOL[2]), pool,
                 sharding.cache_specs(pool, pm, run, POOL[2]), sizes, pm)
    jb, pb = t["batch"]
    _compare(jb, jsharding.batch_specs(jb, jm), pb, sharding.batch_specs(pb, pm),
             sizes, pm)
    odd = {"tokens": torch.empty((3, 8), dtype=torch.int32, device="meta")}
    assert sharding.batch_specs(odd, pm) == {"tokens": (None, None)}
    jodd = jsharding.batch_specs({"tokens": jax.ShapeDtypeStruct((3, 8), np.int32)}, jm)
    assert tuple(jodd["tokens"]) == (None, None)


_ELASTIC = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={sys.argv[1]}"
    import jax
    from repro.launch.mesh import make_elastic_mesh
    m = make_elastic_mesh()
    print("RESULT", dict(m.shape)["data"], dict(m.shape)["model"])
""")


@pytest.fixture
def fake_world():
    """A fake process group of ``n`` ranks in this process (no
    communication), torn down after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(n):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


WORLDS = (1, 6, 8, 16, 24)


@pytest.fixture(scope="module")
def elastic_reference():
    """{n: the reference's (data, model)}, one subprocess a world (each
    forces its device count before JAX starts), run side by side."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    procs = {n: subprocess.Popen([sys.executable, "-c", _ELASTIC, str(n)], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True) for n in WORLDS}
    out = {}
    for n, p in procs.items():
        stdout, stderr = p.communicate(timeout=120)
        assert p.returncode == 0, stderr[-2000:]
        line = [l for l in stdout.splitlines() if l.startswith("RESULT")][-1]
        out[n] = tuple(int(v) for v in line.split()[1:])
    return out


@pytest.mark.parametrize("n", WORLDS)
def test_elastic_mesh_matches_reference(n, fake_world, elastic_reference):
    want = elastic_reference[n]
    assert pmesh.elastic_shape(n) == want
    fake_world(n)
    m = pmesh.make_elastic_mesh(device_type="cpu")
    assert pmesh.axis_sizes(m) == {"data": want[0], "model": want[1]}
    assert pmesh.dp_axes(m) == ("data",)


def test_production_meshes_over_fake_worlds(fake_world):
    fake_world(256)
    m = pmesh.MESHES["pod"]("cpu")
    assert pmesh.axis_sizes(m) == {"data": 16, "model": 16}
    with pytest.raises(ValueError, match="needs 512 ranks"):
        pmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    fake_world(512)
    m = pmesh.MESHES["multipod"]("cpu")
    assert pmesh.axis_sizes(m) == {"pod": 2, "data": 16, "model": 16}
    assert pmesh.dp_axes(m) == ("pod", "data")
    assert pmesh.axis_sizes(pmesh.ABSTRACT_MESHES["multipod"]) == pmesh.axis_sizes(m)
    # placements of a spec over the multipod DeviceMesh
    from torch.distributed.tensor import Replicate, Shard
    assert sharding.named(m, {"w": (("pod", "data"), "model")}) == {
        "w": (Shard(0), Shard(0), Shard(1))}
    assert sharding.named(m, {"b": (None,)}) == {
        "b": (Replicate(), Replicate(), Replicate())}
    with pytest.raises(ValueError, match="mesh order"):
        sharding.named(m, {"w": (("data", "pod"), None)})


def test_no_process_group_refused():
    assert not dist.is_initialized()        # the fixture tears its groups down
    with pytest.raises(RuntimeError, match="init_process_group"):
        pmesh.make_production_mesh(device_type="cpu")
