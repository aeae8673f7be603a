"""The static batch loop across ranks on the CPU: the dense-cache
``decode_step`` (the reference's decode cell) on a ``("data", "model") =
(D, R)`` mesh of gloo processes (``FileStore``), one a rank, each holding
its shard of the weights (``from_jax_params(mesh=)``: FSDP over ``data``,
whole tiles over ``model``) and its window of the caches (``cache_specs``:
the batch over ``data`` where it divides, the sequence over ``model``, or
over ``data x model`` where it does not), against the one-rank port and
the JAX package's ``decode_step`` jitted with ``(param_specs,
cache_specs, batch_specs, P())`` on the same mesh of host devices.

The models are reduced to 2 layers and widened so that tiles split
(``_torch_tp_world.widened``: d_model 384, 6 query heads over 3 KV heads
of 64, d_ff 1024): SmolLM2, whisper-small and InternVL2's language model,
float32, sequence 64, the reference's parameters
(``jax.random.PRNGKey(0)``).  Each case (``_torch_tp_decode_world.CASES``:
the dense model on ``(1, 2)``, ``(2, 1)`` and ``(2, 2)`` at batch 4, which
divides, and 1, which puts the sequence over ``data x model``; 3 on
``(2, 1)``; FSDP off; whisper and InternVL2 on ``(2, 2)`` at 4 and 1)
runs a 48-position prefill (its write crosses the windows' edges) and 4
decode steps into the last window; three cases (``CLAMPED``: one, two and
four windows) then a 4-token call at 62, whose write
``lax.dynamic_update_slice`` clamps to 60.  One world of 2 ranks and one
of 4 run the cases (``tests/_torch_tp_decode_world.py``) beside 3 JAX
subprocesses (``XLA_FLAGS`` sets 4 host devices; ``AxisType.Auto`` axes,
inputs ``device_put`` under their specs); the one-rank port runs in this
process meanwhile.  Tolerances:

- every call's logits, on every rank at its rows, within 1e-5 of the
  one-rank port's and the JAX package's on the same mesh (the FSDP-off
  case: the ``(2, 2)`` batch-4 case's), and bit for bit alike on the
  ranks that hold the same rows;
- the ranks' windows put back together (``weights.join_caches``, which
  holds every replicated piece alike on every rank): the first layer's
  K/V bit for bit the one-rank caches', every leaf within 2e-6 of its
  largest magnitude of the one-rank caches and of the JAX package's, each window the rules' local
  shape and holding a written position;
- ``Engine(mesh=(1, R)).generate_static`` on 2 and 4 ranks: greedy and
  sampled tokens identical to the one-rank engine's and to the JAX
  package's engine's (in this process; identical picks hold the margin
  rule of ROADMAP's "Sampled picks" with no exception);
- the prefill cell, ``forward(last_only=True)`` over each rank's rows on
  ``(2, 2)``, within 1e-5 of the JAX package's forward jitted with
  ``(param_specs, batch_specs)`` and of the one-rank port's.

Also, without ranks: the windowed write and mask of ``dense_kv_update``
against the whole cache's, the partial attention combined over windows
against the whole, the cache helpers of ``weights``; and the refusals
(a ``fake`` process group in this process): moe, the recurrent families,
``seq_shard_kv=False`` and an engine on a data axis, each
``NotImplementedError`` naming its ROADMAP item.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_tp_decode_world as D
import _torch_tp_world as W
from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models.model import build_model as jbuild_model
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.distributed import sharding
from repro_torch.kernels.ragged_attn.ref import combine_partials
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.attention import (SeqWindow, core_attention,
                                          core_attention_partial,
                                          dense_kv_update)
from repro_torch.serving.engine import Engine
from repro_torch.weights import cut_caches, from_jax_params, join_caches

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = tuple(c[0] for c in D.CASES)
# the JAX package's run each case is held to: its own mesh and batch (the
# FSDP-off case computes the same function as the (2, 2) batch-4 case)
JAX_OF = {**{n: n for n in NAMES}, "(2, 2) b4 fsdp off": "(2, 2) b4"}
# the JAX runs on 4 host devices, in three processes of about equal time
_JAX_PROCS = (("(1, 2) b4", "(1, 2) b1", "(2, 1) b4", "(2, 1) b1",
               "internvl2 (2, 2) b1"),
              ("(2, 1) b3", "(2, 2) b4", "(2, 2) b1", "prefill cell"),
              ("whisper (2, 2) b4", "whisper (2, 2) b1", "internvl2 (2, 2) b4"))

# the JAX package's decode cell for each case named in argv[4:] (and the
# prefill cell), on the case's mesh of 4 host devices, from the
# parameters in argv[2]: every call's logits and the caches after the
# last, into argv[3]
_JAX = r"""
import os, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, PartitionSpec as P
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
import _torch_tp_world as W
import _torch_tp_decode_world as D
from repro.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro.distributed import sharding
from repro.models.model import build_model
d, out, meshes = sys.argv[2], {}, {}

def mesh_of(dims):
    if dims not in meshes:
        meshes[dims] = jax.make_mesh(dims, ("data", "model"),
                                     axis_types=(AxisType.Auto,) * 2)
    return meshes[dims]

def model(arch, run, mesh):
    cfg = W.widened(reduced_config(get_config(arch), layers=2))
    return build_model(cfg, run, ShapeSpec(*D.SHAPE), mesh=mesh)

def params_of(arch, run, mesh):
    with np.load(f"{d}/{arch}.npz") as z:
        p = W.unflatten({k: jnp.asarray(z[k]) for k in z.files})
    ps = sharding.param_specs(p, run, mesh)
    return jax.device_put(p, sharding.named(mesh, ps)), ps

def put(tree, mesh):
    specs = sharding.batch_specs(tree, mesh)
    return jax.device_put(tree, sharding.named(mesh, specs)), specs

for name in sys.argv[4:]:
    run = RunConfig(**D.F32)
    if name == "prefill cell":
        mesh = mesh_of((2, 2))
        with jax.set_mesh(mesh):
            m = model("smollm2-135m", run, mesh)
            p, ps = params_of("smollm2-135m", run, mesh)
            b, bs = put({"tokens": jnp.asarray(D.inputs("smollm2-135m", 4)["tokens"])},
                        mesh)
            fn = jax.jit(lambda p, b: m.forward(p, b, last_only=True)[0],
                         in_shardings=sharding.named(mesh, (ps, bs)))
            out[name] = np.asarray(fn(p, b))
        continue
    _, arch, dims, batch, _ = next(c for c in D.CASES if c[0] == name)
    mesh = mesh_of(dims)
    run = RunConfig(**D.run_fields(name))
    x = {k: jnp.asarray(v) for k, v in D.inputs(arch, batch).items()}
    with jax.set_mesh(mesh):
        m = model(arch, run, mesh)
        p, ps = params_of(arch, run, mesh)
        if m.cfg.family == "encdec":
            fb, bs = put({"tokens": x["tokens"], "frames": x["frames"]}, mesh)
            caches = jax.jit(m.prefill_cache,
                             in_shardings=sharding.named(mesh, (ps, bs)))(p, fb)
        else:
            caches = m.init_cache(batch, D.SEQ)
        cs = sharding.cache_specs(caches, mesh, run, batch)
        caches = jax.device_put(caches, sharding.named(mesh, cs))
        ts = sharding.batch_specs(x["decode"], mesh)
        step = jax.jit(m.decode_step, in_shardings=sharding.named(mesh, (ps, cs, ts, P())))
        if m.cfg.family == "vlm":
            vb, bs = put({"tokens": x["tokens"], "patches": x["patches"]}, mesh)
            embeds = jax.jit(m._embeds, in_shardings=sharding.named(mesh, (ps, bs)))(p, vb)
            first = jax.jit(m.decode_step, in_shardings=sharding.named(
                mesh, (ps, cs, ts, P(), sharding.batch_specs(embeds, mesh))))
        for i, (_, tok, pos, pre) in enumerate(D.calls(arch, batch,
                                                       name in D.CLAMPED)):
            tok = jax.device_put(jnp.asarray(tok), sharding.named(mesh, ts))
            if pre:
                logits, caches = first(p, caches, tok, jnp.int32(pos), embeds)
            else:
                logits, caches = step(p, caches, tok, jnp.int32(pos))
            out[f"{name}/logits/{i}"] = np.asarray(logits)
        for k, v in sharding.tree_paths(caches).items():
            out[f"{name}/caches/{k}"] = np.asarray(v)
np.savez(sys.argv[3], **out)
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


def _jax_generate(d) -> dict:
    """The JAX package's engine's generate_static of the same prompts,
    greedy and sampled (one device: its static loop places no cache)."""
    from repro.serving.engine import Engine as JEngine
    jcfg = W.widened(jreduced(jget_config("smollm2-135m"), layers=2))
    jm = jbuild_model(jcfg, JRun(**D.F32), JShape(*D.SHAPE))
    with np.load(d / "smollm2-135m.npz") as z:
        eng = JEngine(jm, W.unflatten({k: jax.numpy.asarray(z[k]) for k in z.files}),
                      max_slots=D.GEN_BATCH, page_tokens=8)
    b = {"tokens": jax.numpy.asarray(D.gen_prompts(jcfg.vocab))}
    return {"generate/greedy": np.asarray(eng.generate_static(b, D.GEN_NEW)),
            "generate/sampled": np.asarray(eng.generate_static(
                b, D.GEN_NEW, greedy=False, seed=D.TEMPERATURE_SEED))}


def _one_rank(d) -> dict:
    """The one-rank port: each (arch, batch)'s calls, the prefill cell's
    forward and the engine's generate_static."""
    out = {}
    for name, arch, _, batch, _ in D.CASES:
        key = (arch, batch, name in D.CLAMPED)
        if key not in out:
            m = D.build(arch, RunConfig(**D.F32))
            out[key] = D.run_calls(m, from_jax_params(D.load(arch, d)), *key)
    m = D.build("smollm2-135m", RunConfig(**D.F32))
    params = from_jax_params(D.load("smollm2-135m", d))
    with torch.no_grad():
        out["prefill cell"] = m.forward(
            params, {"tokens": D.inputs("smollm2-135m", 4)["tokens"]},
            last_only=True)[0]
    eng = Engine(m, params, device="cpu", max_slots=D.GEN_BATCH, page_tokens=8)
    batch = {"tokens": D.gen_prompts(m.cfg.vocab)}
    out["generate"] = {"greedy": eng.generate_static(batch, D.GEN_NEW),
                       "sampled": eng.generate_static(batch, D.GEN_NEW, greedy=False,
                                                      seed=D.TEMPERATURE_SEED)}
    return out


def run_all(d):
    """The worlds, the JAX runs and the one-rank port, in directory ``d``
    (a ``pathlib.Path``)."""
    for arch in D.ARCHS:
        jcfg = W.widened(jreduced(jget_config(arch), layers=2))
        jm = jbuild_model(jcfg, JRun(**D.F32), JShape(*D.SHAPE))
        _flat_npz(jm.init(jax.random.PRNGKey(0)), d / f"{arch}.npz")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]))
    procs = {"jax": [subprocess.Popen(
        [sys.executable, "-c", _JAX, ROOT, str(d), str(d / f"jax{i}.npz"), *names],
        env=dict(env, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, names in enumerate(_JAX_PROCS)]}
    for world in (2, 4):
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "_torch_tp_decode_world.py"),
             str(r), str(world), str(d / f"store{world}"), str(d),
             str(d / f"out{world}")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    try:
        one = _one_rank(d)
        generated = _jax_generate(d)
        logs = {k: [p.communicate(timeout=240)[0] for p in ps]
                for k, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for k, ps in procs.items():
        for p, log in zip(ps, logs[k]):
            assert p.returncode == 0, f"{k}: exit {p.returncode}\n{log[-4000:]}"
    ranks = {w: [torch.load(d / f"out{w}.{r}.pt", weights_only=False)
                 for r in range(w)] for w in (2, 4)}
    jx = dict(generated)
    for i in range(len(_JAX_PROCS)):
        with np.load(d / f"jax{i}.npz") as z:
            jx.update({k: z[k] for k in z.files})
    return {"ranks": ranks, "one": one, "jax": jx}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_all(tmp_path_factory.mktemp("tp_decode"))


def _case(name):
    return next(c for c in D.CASES if c[0] == name)


def _ranks(runs, name):
    return [r[name] for r in runs["ranks"][D.world_of(_case(name)[2])]]


def _mesh(name):
    return AbstractMesh(_case(name)[2], ("data", "model"))


@pytest.mark.parametrize("name", NAMES)
def test_decode_logits_match_both_references(runs, name):
    """Every call's logits (the prefill, the decode steps into the last
    window, the clamped call) on every rank, at its rows, within 1e-5 of
    the one-rank port's and of the JAX package's decode cell on the same
    mesh; the ranks holding the same rows alike bit for bit; the
    collectives made."""
    _, arch, _, batch, _ = _case(name)
    want = runs["one"][(arch, batch, name in D.CLAMPED)][0]
    n_calls = len(D.calls(arch, batch, name in D.CLAMPED))
    jx = [runs["jax"][f"{JAX_OF[name]}/logits/{i}"] for i in range(n_calls)]
    by_rows = {}
    for r in _ranks(runs, name):
        lo, hi = r["rows"]
        assert len(r["logits"]) == n_calls
        for got, one, j in zip(r["logits"], want, jx, strict=True):
            assert got.shape == one[lo:hi].shape
            assert (got - one[lo:hi]).abs().max() <= 1e-5
            assert np.abs(got.numpy() - j[lo:hi]).max() <= 1e-5
        first = by_rows.setdefault((lo, hi), r["logits"])
        assert all(torch.equal(a, b) for a, b in zip(first, r["logits"]))
        assert r["collectives"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_windows_put_back_equal_the_whole_caches(runs, name):
    """The ranks' windows after the last call, put back together (every
    copy of a replicated piece alike): the first layer's K/V bit for bit
    the one-rank caches' (its products are the same on the rank's rows);
    every leaf within 2e-6 of its largest magnitude of the one-rank
    caches and of the JAX package's (the second layer's K/V, up to 4.6 in
    magnitude, come from the first layer's row-parallel sums, added in
    another order: a few float32 ulps, about 5e-6, as far as between the
    one-rank port and the JAX package; a bound relative to the leaf, so
    that a position written wrong at a small magnitude still shows); each
    window the rules' local shape and holding a written position."""
    _, arch, _, batch, _ = _case(name)
    whole = D.plain(runs["one"][(arch, batch, name in D.CLAMPED)][1])
    run, mesh = RunConfig(**D.run_fields(name)), _mesh(name)
    windows = {r["coord"]: r["caches"] for r in _ranks(runs, name)}
    got = join_caches(windows, whole, mesh, run, batch)
    specs = sharding.tree_paths(sharding.cache_specs(whole, mesh, run, batch))
    g, w = sharding.tree_paths(got), sharding.tree_paths(whole)
    assert g.keys() == w.keys()
    for path, t in w.items():
        if "kv" in path:                # the first layer's: the same products
            assert torch.equal(g[path][0], t[0])
        tol = 2e-6 * float(t.abs().max())
        assert (g[path] - t).abs().max() <= tol
        assert np.abs(g[path].numpy()
                      - runs["jax"][f"{JAX_OF[name]}/caches/{path}"]).max() <= tol
        for c, win in windows.items():
            local = sharding.tree_paths(win)[path]
            assert tuple(local.shape) == sharding.local_shape(t.shape, specs[path],
                                                              mesh)
            assert bool((local != 0).any())


# the windows the rules give each case: the rows of rank (data 0 | 1), and
# the ranks the sequence of 64 positions (whisper's cross K/V: 16 encoder
# positions) is cut over
WINDOWS = {"(1, 2) b4": ((0, 4), (0, 4), 2, 2), "(1, 2) b1": ((0, 1), (0, 1), 2, 2),
           "(2, 1) b4": ((0, 2), (2, 4), None, None),
           "(2, 1) b1": ((0, 1), (0, 1), 2, 2), "(2, 1) b3": ((0, 3), (0, 3), 2, 2),
           "(2, 2) b4": ((0, 2), (2, 4), 2, 2), "(2, 2) b1": ((0, 1), (0, 1), 4, 4),
           "whisper (2, 2) b4": ((0, 2), (2, 4), 2, 2),
           "whisper (2, 2) b1": ((0, 1), (0, 1), 4, 4)}


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_windows_follow_cache_specs(runs, name):
    """The batch over the data ranks where it divides them (all rows on
    every rank where it does not); the sequence over ``model``, or over
    ``data x model`` (the rank ``d R + m``) where the batch does not
    divide; whisper's cross K/V over the same ranks."""
    rows0, rows1, parts, cross = WINDOWS[name]
    dims = _case(name)[2]
    for r in _ranks(runs, name):
        d, m = r["coord"]
        assert r["rows"] == (rows0, rows1)[d]
        if parts is None:
            assert r["seq"] is None
            continue
        idx = (d * dims[1] + m) if parts == dims[0] * dims[1] else m if dims[1] > 1 else d
        assert r["seq"] == (idx * D.SEQ // parts, parts)
        if name.startswith("whisper"):
            assert r["cross"] == (idx * D.SEQ // 4 // cross, cross)
        else:
            assert r["cross"] is None


@pytest.mark.parametrize("world", (2, 4))
def test_generate_static_across_ranks(runs, world):
    """``Engine(mesh=(1, R)).generate_static``: greedy and sampled tokens
    on every rank identical to the one-rank engine's and to the JAX
    package's engine's, the steps' collectives made."""
    for r in runs["ranks"][world]:
        gen = r["generate"]
        for key in ("greedy", "sampled"):
            assert gen[key].shape == (D.GEN_BATCH, D.GEN_NEW)
            np.testing.assert_array_equal(gen[key], runs["one"]["generate"][key])
            np.testing.assert_array_equal(gen[key], runs["jax"][f"generate/{key}"])
        assert gen["collectives"] > 0


def test_prefill_cell_matches_the_jax_sharded_forward(runs):
    """The prefill cell: ``forward(last_only=True)`` over each rank's rows
    of the batch on (2, 2), within 1e-5 of the JAX package's forward
    jitted with ``(param_specs, batch_specs)`` on the same mesh and of
    the one-rank port's."""
    want, jx = runs["one"]["prefill cell"], runs["jax"]["prefill cell"]
    assert jx.shape == tuple(want.shape)
    for r in runs["ranks"][4]:
        lo, hi = r["prefill cell"]["rows"]
        got = r["prefill cell"]["logits"]
        assert got.shape == (hi - lo, 1, D.config("smollm2-135m").vocab)
        assert (got - want[lo:hi]).abs().max() <= 1e-5
        assert np.abs(got.numpy() - jx[lo:hi]).max() <= 1e-5


# ----------------------------------------------------------- without ranks


class _Axis:
    def __init__(self, size):
        self.size = size


@pytest.mark.parametrize("pos,s", [(0, 40), (40, 1), (47, 1), (48, 1), (62, 4),
                                   (30, 20), (63, 1)])
def test_windowed_write_and_mask_equal_the_whole(pos, s):
    """``dense_kv_update`` on each of 4 windows of 16 positions (the
    clamp on the global 64; a write spanning windows) equals the whole
    cache's write and mask cut into windows, bit for bit."""
    g = torch.Generator().manual_seed(pos * 100 + s)
    b, total, parts = 2, 64, 4
    whole = {k: torch.randn((b, total, 3, 8), generator=g) for k in ("k", "v")}
    k, v = (torch.randn((b, s, 3, 8), generator=g) for _ in range(2))
    n = total // parts
    wins = [{key: t[:, i * n:(i + 1) * n].clone() for key, t in whole.items()}
            for i in range(parts)]
    p = torch.tensor(pos, dtype=torch.int32)
    _, _, _, mask = dense_kv_update(whole, k, v, p)
    for i, win in enumerate(wins):
        _, kw, vw, mw = dense_kv_update(win, k, v, p, SeqWindow(i * n, total, _Axis(parts)))
        assert torch.equal(kw, whole["k"][:, i * n:(i + 1) * n])
        assert torch.equal(vw, whole["v"][:, i * n:(i + 1) * n])
        assert torch.equal(mw, mask[:, i * n:(i + 1) * n])


@pytest.mark.parametrize("causal", (True, False))
def test_partial_attention_combined_over_windows_equals_the_whole(causal):
    """``core_attention_partial`` over 4 windows of the keys (global
    positions, the length mask), combined in window order, within 1e-6
    of ``core_attention`` over the whole; a window with no counted key
    gives zeros and ``-inf``."""
    g = torch.Generator().manual_seed(3)
    b, sq, skv, hq, hkv, dh = 2, 5, 32, 6, 3, 16
    q = torch.randn((b, sq, hq, dh), generator=g)
    k, v = (torch.randn((b, skv, hkv, dh), generator=g) for _ in range(2))
    q_pos = torch.arange(10, 10 + sq)
    mask = (torch.arange(skv) < 15)[None].expand(b, skv)
    want = core_attention(q, k, v, causal=causal, q_pos=q_pos, kv_len_mask=mask)
    outs, lses = [], []
    for i in range(4):
        o, lse = core_attention_partial(
            q, k[:, 8 * i:8 * i + 8], v[:, 8 * i:8 * i + 8],
            q_pos=q_pos if causal else None, kv_len_mask=mask[:, 8 * i:8 * i + 8],
            kv_lo=8 * i)
        outs.append(o)
        lses.append(lse)
    assert (combine_partials(outs, lses) - want).abs().max() <= 1e-6
    assert torch.equal(outs[3], torch.zeros_like(outs[3]))
    assert bool(torch.isinf(lses[3]).all())


def test_cache_helpers_cut_and_join():
    """``weights.cut_caches`` of a whole cache tree (numpy, as the JAX
    package's) at every coordinate of (2, 2), put back by
    ``join_caches``, is the tree; batch 1 cuts the sequence in 4."""
    rng = np.random.default_rng(0)
    run = RunConfig(**D.F32)
    mesh = AbstractMesh((2, 2), ("data", "model"))
    for batch, seq_parts in ((4, 2), (1, 4)):
        tree = {"p0": {"kv": {k: rng.standard_normal((2, batch, 64, 3, 8)).astype(
            np.float32) for k in ("k", "v")}}}
        wins = {(d, m): cut_caches(tree, mesh, run, batch, {"data": d, "model": m})
                for d in range(2) for m in range(2)}
        assert wins[(0, 0)]["p0"]["kv"]["k"].shape == (2, batch * seq_parts // 4,
                                                       64 // seq_parts, 3, 8)
        like = from_jax_params(tree)
        got = join_caches(wins, like, mesh, run, batch)
        assert torch.equal(got["p0"]["kv"]["k"], like["p0"]["kv"]["k"])
        assert torch.equal(got["p0"]["kv"]["v"], like["p0"]["kv"]["v"])


# ------------------------------------------------------------------ refusals


@pytest.fixture
def fake_world():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield lambda dims: init_device_mesh("cpu", dims,
                                            mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _build(arch, mesh, **run):
    from repro_torch.models.model import build_model
    cfg = D.config("smollm2-135m") if arch is None else reduced_config(
        get_config(arch), layers=2)
    return build_model(cfg, RunConfig(**{**D.F32, **run}), ShapeSpec(*D.SHAPE),
                       device="cpu", mesh=mesh)


REFUSED = {
    "data-axis engine": ("A13.1", lambda mk: Engine(
        _build("whisper-small", mk((2, 2))), {}, device="cpu", mesh=mk((2, 2)))),
    "heads over model": ("A13.2", lambda mk: _build(
        None, mk((2, 2)), seq_shard_kv=False).init_cache(4, D.SEQ)),
    "moe": ("A13.3", lambda mk: _build("qwen3-moe-235b-a22b", mk((2, 2)))),
    "recurrent": ("A13.4", lambda mk: _build("rwkv6-1.6b", mk((2, 2)))),
    "hybrid": ("A13.4", lambda mk: _build("jamba-v0.1-52b", mk((1, 4)))),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_across_ranks(fake_world, case):
    item, make = REFUSED[case]
    with pytest.raises(NotImplementedError, match=item.replace(".", r"\.")):
        make(fake_world)


@pytest.mark.parametrize("batch,seq", [(1, 62), (4, 63)])
def test_an_undivided_sequence_stays_whole(fake_world, batch, seq):
    """``_sanitize``'s rule, as the reference's: a sequence its ranks do
    not divide (62 over ``data x model``'s 4, 63 over ``model``'s 2) stays
    whole on every rank, with no combine; the batch rows as before."""
    m = _build(None, fake_world((2, 2)))
    win = m.cache_window(batch, seq)
    assert win.seq is None and win.rows == ((0, 2) if batch == 4 else (0, 1))
    assert m.init_cache(batch, seq)["p0"]["kv"]["k"].shape[1:3] == (
        win.rows[1] - win.rows[0], seq)


def test_decode_step_needs_the_ranks_windows(fake_world):
    """Across ranks ``decode_step`` takes the caches ``init_cache`` made
    (a ``RankCaches`` with its window) for the batch it is given."""
    m = _build(None, fake_world((2, 2)))
    caches = m.init_cache(4, D.SEQ)
    assert caches.window.rows == (0, 2)
    assert caches["p0"]["kv"]["k"].shape == (2, 2, D.SEQ // 2, 3, 64)
    tok, pos = torch.zeros((4, 1), dtype=torch.int32), torch.tensor(0)
    with pytest.raises(ValueError, match="RankCaches"):
        m.decode_step({}, dict(caches), tok, pos)
    with pytest.raises(ValueError, match="made for 4"):
        m.decode_step({}, caches, tok[:2], pos)
