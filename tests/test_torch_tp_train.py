"""Training across ranks on the CPU: ``make_train_step`` on a model built
over a ``("data", "model") = (D, R)`` mesh of gloo processes
(``FileStore``), one a rank, each holding its shard of the train state
(``from_jax_state(mesh=)`` under ``state_specs``: FSDP over ``data``, the
Megatron products over ``model``), against the one-rank port step and the
JAX package's sharded train step on a ``(2, 2)`` mesh.

The model is reduced SmolLM2 widened so that tiles split
(``_torch_tp_world.widened``: d_model 384, 6 query heads over 3 KV heads
of 64, d_ff 1024), 2 layers, float32, the reference's state
(``jax.random.PRNGKey(0)``) carried by ``from_jax_state(mesh=)``; 3 steps
at sequence 32 and batch 4 (``_torch_tp_train_world.RUNS``).  One world of
2 ranks runs the ``(1, 2)`` and ``(2, 1)`` meshes, one of 4 the ``(2, 2)``
mesh with FSDP on and off, remat, 8-bit moments, compression and 2
microbatches; the JAX package's step jitted with ``state_specs`` and
``batch_specs`` on a ``(2, 2)`` mesh of 4 host devices (its axes
``Auto``: jax's default ``Explicit`` axes make ``constrain_stream``
raise) in a subprocess; the one-rank port steps in this process
meanwhile.  Tolerances:

- each step's loss within 1e-6 of both references, ``grad_norm`` within
  1e-6 relative (float32 sums in another order: each rank's shard summed,
  then the ranks);
- each gradient leaf at the first step within 2e-5 of the leaf's largest
  entry (``test_torch_training.GRAD_REL``'s reason);
- the parameters after each step within 1e-6, but for entries where a
  near-zero gradient's sign differs, which Adam turns into a difference of
  up to 2 lr a step: at most 1 in 10,000, none beyond 2 lr times the steps;
- the ranks' shards put back together (``weights.unshard_state``, which
  also holds every copy of a replicated piece to the others bit for bit)
  equal to the whole state, before the first step exactly;
- the 8-bit moments' scales within 2e-5 of the one-rank step's (the whole
  leaf's row absmax), the int8 moments within 1; the compressed step's
  error buffer as ``test_torch_training`` holds it;
- remat across ranks equal to no remat bit for bit;
- ``forward(last_only=True)`` across ranks within 1e-5 of one rank's.

Also the refusals (a ``fake`` process group in this process): the moe,
recurrent, encdec and vlm families' training across ranks, the compiled
train step and the Trainer across ranks, each ``NotImplementedError``
naming its ROADMAP item; and a collective over a strided tensor raises.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_tp_train_world as T
import _torch_tp_world as W
from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models.model import build_model as jbuild_model
from repro.training.optimizer import make_optimizer as jmake_optimizer
from repro.training.train_state import TrainState as JTrainState
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models.model import build_model
from repro_torch.training.compression import init_error_buffer
from repro_torch.training.optimizer import leaves, make_optimizer
from repro_torch.training.step import make_train_step
from repro_torch.training.train_state import TrainState
from repro_torch.weights import from_jax_state, unshard_state

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAD_REL = 2e-5
WORLDS = {2: ("(1, 2)", "(2, 1)", "(1, 2) seq 1024"),
          4: ("(2, 2)", "(2, 2) fsdp off", "(2, 2) remat", "(2, 2) 8-bit",
              "(2, 2) compression", "(2, 2) microbatch 2")}
MAIN_RUNS = ("(1, 2)", "(2, 1)", "(2, 2)", "(2, 2) fsdp off")
ALL_RUNS = tuple(r[0] for r in T.RUNS)

# the runs the JAX package's (2, 2) step runs too: every run's
# configuration but its mesh ("(1, 2)", "(2, 1)" and "(2, 2) fsdp off" are
# held to the main run's, the same function of the same state)
JAX_RUNS = {"(1, 2)": T.MAIN, "(2, 1)": T.MAIN, "(2, 2)": T.MAIN,
            "(2, 2) fsdp off": T.MAIN, "(2, 2) remat": "(2, 2) remat",
            "(2, 2) 8-bit": "(2, 2) 8-bit",
            "(2, 2) compression": "(2, 2) compression",
            "(2, 2) microbatch 2": "(2, 2) microbatch 2",
            "(1, 2) seq 1024": "(1, 2) seq 1024"}

# the JAX package's train step on a (2, 2) mesh of 4 host devices, jitted
# with state_specs and batch_specs (the dry-run's train cell), for each of
# the runs named in argv[4:], from the parameters in argv[3] (the state
# file the ranks read, the JAX package's PRNGKey(0) init): each step's
# loss, grad_norm, parameters and error buffer (with compression), and the
# first step's gradients (those of
# the run's loss, which its configuration, but for the shape, leaves alone)
_JAX = r"""
import dataclasses, os, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
import _torch_tp_world as W
import _torch_tp_train_world as T
from repro.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro.distributed import sharding
from repro.models.model import build_model
from repro.training import compression
from repro.training.optimizer import make_optimizer
from repro.training.step import make_train_step
from repro.training.train_state import TrainState
cfg = W.widened(reduced_config(get_config("smollm2-135m"), layers=2))
mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
with jax.set_mesh(mesh):
    params = jax.tree.map(jnp.asarray, T.load_state(sys.argv[3])[1])
    for name in sys.argv[4:]:
        run = RunConfig(**T.run_fields(name))
        steps = next(r[4] for r in T.RUNS if r[0] == name)
        m = build_model(cfg, run, ShapeSpec(*dataclasses.astuple(T.shape(name))),
                        mesh=mesh)
        opt = make_optimizer(run, 10)
        st = TrainState(jnp.zeros((), jnp.int32), params, jax.jit(opt.init)(params))
        if run.grad_compression:
            st.opt_state["err"] = compression.init_error_buffer(params)
        bs = [{k: jnp.asarray(v) for k, v in b.items()}
              for b in T.batches(cfg.vocab, name)]
        st_specs = sharding.state_specs(st, run, mesh)
        b_specs = sharding.batch_specs(bs[0], mesh)
        st = jax.device_put(st, sharding.named(mesh, st_specs))
        bs = [jax.device_put(b, sharding.named(mesh, b_specs)) for b in bs]
        step = jax.jit(make_train_step(m, opt, run),
                       in_shardings=sharding.named(mesh, (st_specs, b_specs)))
        if name in (T.MAIN, "(1, 2) seq 1024"):
            grad = jax.jit(jax.grad(lambda p, b: m.loss(p, b)[0]),
                           in_shardings=sharding.named(mesh, (st_specs.params,
                                                              b_specs)))
            for i, leaf in enumerate(jax.tree.leaves(grad(st.params, bs[0]))):
                out[f"{name}/grad/{i}"] = np.asarray(leaf)
        for s in range(steps):
            st, met = step(st, bs[s])
            out[f"{name}/loss/{s}"] = np.asarray(met["loss"])
            out[f"{name}/grad_norm/{s}"] = np.asarray(met["grad_norm"])
            for i, leaf in enumerate(jax.tree.leaves(st.params)):
                out[f"{name}/params/{s}/{i}"] = np.asarray(leaf)
            for i, leaf in enumerate(jax.tree.leaves(st.opt_state.get("err", {}))):
                out[f"{name}/err/{s}/{i}"] = np.asarray(leaf)
np.savez(sys.argv[2], **out)
"""


def _flat(tree, pre, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, f"{pre}/{k}", out)
    else:
        out[pre] = np.asarray(tree)


def _jax_state():
    jcfg = W.widened(jreduced(jget_config("smollm2-135m"), layers=2))
    run = JRun(**T.F32)
    jm = jbuild_model(jcfg, run, JShape(*T.SHAPE))
    return JTrainState.create(jm.init(jax.random.PRNGKey(0)), jmake_optimizer(run, 10))


def _one_rank(name, state_path):
    """The one-rank port's run ``name`` from the same state: each step's
    metrics, state and the first step's gradients; for the main run the
    last position's logits over the whole first batch."""
    run = T.run_config(name)
    steps = next(r[4] for r in T.RUNS if r[0] == name)
    m = build_model(W.config(), run, T.shape(name), device="cpu")
    step0, pn, on = T.load_state(state_path, run.grad_compression)
    if run.adam_8bit:
        on = T.eightbit_opt(on, pn)
    st = from_jax_state(step0, pn, on)
    whole = TrainState(st.step, _clone(st.params), _clone(st.opt_state))
    fn = make_train_step(m, make_optimizer(run, 10), run)
    bs = T.batches(m.cfg.vocab, name)
    grads, _ = fn.grads_of(st.params, bs[0])
    out = {"before": whole, "grads": grads, "steps": []}
    for i in range(steps):
        st, met = fn(st, bs[i])
        out["steps"].append({"metrics": {k: float(v) for k, v in met.items()},
                             "state": TrainState(st.step, _clone(st.params),
                                                 _clone(st.opt_state))})
    if name == T.MAIN:
        with torch.no_grad():
            out["last_only"] = m.forward(st.params, {"tokens": bs[0]["tokens"]},
                                         last_only=True)[0]
    return out


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone()


# the JAX runs, in three processes of about equal time
_JAX_PROCS = ((T.MAIN, "(2, 2) compression"),
              ("(2, 2) 8-bit", "(2, 2) remat", "(2, 2) microbatch 2"),
              ("(1, 2) seq 1024",))


def run_all(d):
    """Every run of :data:`T.RUNS` in its world, the one-rank port's and the
    JAX package's, in directory ``d`` (a ``pathlib.Path``)."""
    jst = _jax_state()
    flat = {"step": np.asarray(jst.step)}
    _flat(jst.params, "params", flat)
    _flat(jst.opt_state, "opt", flat)
    state_path = str(d / "state.npz")
    np.savez(state_path, **flat)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.path.join(ROOT, "tests")]))
    procs = {"jax": [subprocess.Popen(
        [sys.executable, "-c", _JAX, ROOT, str(d / f"jax{i}.npz"), state_path,
         *names],
        env=dict(env, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, names in enumerate(_JAX_PROCS)]}
    for world in WORLDS:
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.join(ROOT, "tests", "_torch_tp_train_world.py"),
             str(r), str(world), str(d / f"store{world}"), state_path,
             str(d / f"out{world}")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
    try:
        one = {name: _one_rank(name, state_path)
               for names in WORLDS.values() for name in names}
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
    ranks = {}
    for world, names in WORLDS.items():
        outs = [torch.load(d / f"out{world}.{r}.pt", weights_only=False)
                for r in range(world)]
        for name in names:
            ranks[name] = [o[name] for o in outs]
    jx = {}
    for i in range(len(_JAX_PROCS)):
        with np.load(d / f"jax{i}.npz") as z:
            jx.update({k: z[k] for k in z.files})
    return {"ranks": ranks, "one": one, "jax": jx, "jst": jst}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_all(tmp_path_factory.mktemp("tp_train"))


def _mesh(name):
    dims = next(r[1] for r in T.RUNS if r[0] == name)
    return AbstractMesh(dims, ("data", "model"))


def _gathered(runs, name, pick):
    """The whole state put back together from every rank's ``pick(rank's
    result)``: a (params, opt_state) pair."""
    rs = runs["ranks"][name]
    like = runs["one"][name]["before"]
    shards = {r["coord"]: TrainState(0, *pick(r)) for r in rs}
    if not next(iter(shards.values())).opt_state:
        like = TrainState(0, like.params, {})
    return unshard_state(shards, like, T.run_config(name), _mesh(name), T.layout_of)


def _steps(name):
    return next(r[4] for r in T.RUNS if r[0] == name)


def _jx(runs, name, key):
    """The JAX package's ``key`` (``loss/0``, ``params/1/3``, ...) for run
    ``name``: its own configuration's run (:data:`JAX_RUNS`)."""
    return runs["jax"][f"{JAX_RUNS[name]}/{key}"]


def _err_gap(runs, name, s):
    """With compression, how far the ranks' compressed gradient at step
    ``s`` may lie from each reference's beyond their raw gradients'
    rounding: the compressed gradient is the raw one plus the carried
    error less the new error buffer, and the buffers start equal, so the
    norms differ by at most the norm of the buffers' difference (an
    element on an int8 grid's edge moves by a whole grid step).  Returns
    (gap to the one-rank port's, gap to the JAX package's); 0 without
    compression."""
    if not T.run_config(name).grad_compression:
        return 0.0, 0.0
    whole = _gathered(runs, name, lambda r: (r["steps"][s]["params"],
                                             r["steps"][s]["opt"]))
    got = [t.numpy().astype(np.float64) for t in leaves(whole.opt_state["err"])]
    one = [t.numpy() for t in
           leaves(runs["one"][name]["steps"][s]["state"].opt_state["err"])]
    jx = [_jx(runs, name, f"err/{s}/{i}") for i in range(len(got))]
    return tuple(float(np.sqrt(sum(np.sum((a - b) ** 2) for a, b in zip(got, ref,
                                                                         strict=True))))
                 for ref in (one, jx))


@pytest.mark.parametrize("name", ALL_RUNS)
def test_loss_and_grad_norm_match_both_references(runs, name):
    """Each step's loss (the data ranks' mean) within 1e-6 of the one-rank
    port step's and the JAX package's (2, 2) step's, on every rank; the
    grad_norm within 1e-6 relative (with compression, plus the norm of the
    error buffers' difference: :func:`_err_gap`)."""
    one = runs["one"][name]["steps"]
    for r in runs["ranks"][name]:
        assert len(r["steps"]) == _steps(name)
        for s, (got, want) in enumerate(zip(r["steps"], one, strict=True)):
            for ref in (want["metrics"]["loss"], float(_jx(runs, name, f"loss/{s}"))):
                assert abs(got["metrics"]["loss"] - ref) <= 1e-6
            for ref, gap in zip((want["metrics"]["grad_norm"],
                                 float(_jx(runs, name, f"grad_norm/{s}"))),
                                _err_gap(runs, name, s)):
                assert abs(got["metrics"]["grad_norm"] - ref) <= 1e-6 * ref + gap
            for k in ("nll", "z_loss"):
                assert abs(got["metrics"][k] - want["metrics"][k]) \
                    <= 1e-6 * max(1.0, abs(want["metrics"][k]))
            assert got["collectives"] > 0


@pytest.mark.parametrize("name", ALL_RUNS)
def test_gradients_match_both_references(runs, name):
    """The first step's gradients, every rank's shards put back together
    (replicated pieces bit for bit alike), each leaf within GRAD_REL of its
    largest entry of the one-rank port's and the JAX package's (the
    gradients of the run's loss: its configuration leaves them alone but
    for the sequence)."""
    whole = _gathered(runs, name, lambda r: (r["grads"], {}))
    got = leaves(whole.params)
    want = leaves(runs["one"][name]["grads"])
    key = "(1, 2) seq 1024" if name == "(1, 2) seq 1024" else T.MAIN
    jx = [runs["jax"][f"{key}/grad/{i}"] for i in range(len(got))]
    assert len(got) == len(want) == len(jax.tree.leaves(runs["jst"].params))
    for g, w, j in zip(got, want, jx, strict=True):
        assert tuple(g.shape) == tuple(w.shape) == j.shape
        for ref in (w.numpy(), j):
            assert np.abs(g.numpy() - ref).max() <= GRAD_REL * np.abs(ref).max()


def _off(got, want) -> int:
    return sum(int((np.abs(np.asarray(b, np.float64) - np.asarray(a, np.float64))
                    > 1e-6).sum()) for a, b in zip(want, got, strict=True))


def _params_close(got, want, steps, lr, witness=0, free=None):
    """``got`` within 1e-6 of ``want`` but for the elements where a
    near-zero gradient's sign differs, which Adam turns into a difference
    of up to 2 lr a step: none beyond 2 lr times the steps, and at most as
    many beyond 1e-6 as the larger of 1 in 10,000 and ``witness``, the
    count between two one-rank steps whose sums run in another order (the
    one-rank port's and the JAX package's; ``chip_smoke.py`` holds the
    card's shards to the same rule, its witness the one-rank step through
    the plain products).  ``free``: per leaf, a mask of elements exempt
    from the 2 lr bound (but counted)."""
    off = total = 0
    for n, (a, b) in enumerate(zip(want, got, strict=True)):
        d = np.abs(np.asarray(b, np.float64) - np.asarray(a, np.float64))
        assert np.isfinite(d).all()
        bounded = d if free is None else d[~free[n]]
        assert bounded.size == 0 or bounded.max() <= 2 * lr * steps * 1.0001
        off += int((d > 1e-6).sum())
        total += d.size
    assert off <= max(total // 10_000, witness)


def _zero_second_moment(state) -> list:
    """Per parameter leaf, the elements whose int8 second moment is 0
    (all False for a leaf kept in float32)."""
    return [(q.numpy() == 0) if q.dtype == torch.int8 else np.zeros(q.shape, bool)
            for q in leaves(state.opt_state["v_q"])]


@pytest.mark.parametrize("name", ALL_RUNS)
def test_parameters_after_each_step(runs, name):
    """The ranks' parameter shards after each step put back together,
    within 1e-6 of the one-rank port's and the JAX package's (Adam's sign
    flips counted, :func:`_params_close`; the witness for the JAX package
    the count between the two one-rank steps plus the ranks' own against
    the one-rank port's), every replicated piece alike on every rank
    holding it; the moments (without 8-bit moments or compression, which
    their own tests hold) within GRAD_REL of their largest.  With 8-bit
    moments, after the second step an element whose int8 second moment
    the first left at 0 is free of the 2 lr bound: its second update
    divides by its own second gradient, so a gradient near 0 magnifies
    its rounding without bound (the one-rank port against the JAX package
    too)."""
    run = T.run_config(name)
    lr = make_optimizer(run, 10).lr
    one = runs["one"][name]["steps"]
    for s in range(_steps(name)):
        whole = _gathered(runs, name, lambda r: (r["steps"][s]["params"],
                                                 r["steps"][s]["opt"]))
        got = [t.numpy() for t in leaves(whole.params)]
        want = [t.numpy() for t in leaves(one[s]["state"].params)]
        jx = [_jx(runs, name, f"params/{s}/{i}") for i in range(len(got))]
        free = (_zero_second_moment(one[s - 1]["state"])
                if run.adam_8bit and s > 0 else None)
        witness = _off(want, jx)
        _params_close(got, want, s + 1, lr, witness, free)
        _params_close(got, jx, s + 1, lr, witness + _off(got, want), free)
        for key in ("m", "v"):
            if key not in one[s]["state"].opt_state or run.grad_compression:
                continue
            for a, b in zip(leaves(whole.opt_state[key]),
                            leaves(one[s]["state"].opt_state[key]), strict=True):
                assert np.abs(a.numpy() - b.numpy()).max() \
                    <= GRAD_REL * max(1e-30, float(b.abs().max()))


@pytest.mark.parametrize("name", MAIN_RUNS)
def test_shards_put_back_together(runs, name):
    """``from_jax_state(mesh=)``'s shards before the first step put back
    together equal the whole state exactly; each rank's parameter leaves
    the rules' local shapes (FSDP's cut leaves gathered in the forward,
    the model axis's cut in whole tiles, ``w_split`` beside them)."""
    whole = _gathered(runs, name, lambda r: (r["before"]["params"],
                                             r["before"]["opt"]))
    like = runs["one"][name]["before"]
    for a, b in zip(leaves({"p": whole.params, "o": whole.opt_state}),
                    leaves({"p": like.params, "o": like.opt_state}), strict=True):
        assert torch.equal(a, b)
    dims = next(r[1] for r in T.RUNS if r[0] == name)
    for r in runs["ranks"][name]:
        wq = r["before"]["params"]["groups"]["p0"]["mixer"]["wq"]
        assert ("w_split" in wq) == (dims[1] > 1)
        if name == T.MAIN:
            # wq [2, 384, 384]: K over data (2 + 1 tiles), N over model
            k = (256, 128)[r["coord"][0]]
            assert tuple(wq["w"].shape) == (2, k, (256, 128)[r["coord"][1]])
            assert r["fsdp_cuts"]["groups/p0/mixer/wq/w"][1:] \
                == ((0, 256, 384), (256, 384, 384))[r["coord"][0]]
            assert r["local_shapes"]["embed/e"] == (256, 384)


def test_remat_equals_no_remat_across_ranks(runs):
    """Remat across ranks (each group's forward, its collectives with it,
    run again in the backward, in the same order on every rank): the first
    step's gradients and the state after it bit for bit the plain run's."""
    for plain, remat in zip(runs["ranks"]["(2, 2)"], runs["ranks"]["(2, 2) remat"]):
        assert plain["coord"] == remat["coord"]
        for a, b in zip(leaves(plain["grads"]), leaves(remat["grads"]), strict=True):
            assert torch.equal(a, b)
        for a, b in zip(leaves(plain["steps"][0]["params"]),
                        leaves(remat["steps"][0]["params"]), strict=True):
            assert torch.equal(a, b)
        assert plain["steps"][0]["metrics"] == remat["steps"][0]["metrics"]
        assert remat["steps"][0]["collectives"] > plain["steps"][0]["collectives"]


def test_8bit_moments_scales_are_the_whole_leafs(runs):
    """8-bit moments across ranks: the row absmax of a leaf cut over its
    last axis (a column weight's N over model, a row weight's N over data)
    is the max over the ranks, so the scales put back together are the
    one-rank step's (within GRAD_REL of their largest), the int8 moments
    within 1 (a count of 1 in 10,000 may sit on a rounding edge), after
    each of 2 steps.  (Its losses and parameters: the tests above.)"""
    name = "(2, 2) 8-bit"
    for s in range(_steps(name)):
        whole = _gathered(runs, name, lambda r: (r["steps"][s]["params"],
                                                 r["steps"][s]["opt"]))
        want = runs["one"][name]["steps"][s]["state"]
        off = total = 0
        for key in ("m_q", "m_s", "v_q", "v_s"):
            for a, b in zip(leaves(whole.opt_state[key]),
                            leaves(want.opt_state[key]), strict=True):
                d = np.abs(a.numpy().astype(np.float64) - b.numpy().astype(np.float64))
                if b.dtype == torch.int8:
                    assert d.max() <= 1
                    off += int((d > 0).sum())
                    total += d.size
                else:
                    assert d.max() <= GRAD_REL * max(1e-30, float(b.abs().max()))
        assert off <= max(1, total // 10_000)


def test_compression_and_microbatches_across_ranks(runs):
    """Gradient compression across ranks (each leaf's int8 scale the max
    over every rank holding a piece): the error buffer put back together
    within GRAD_REL of the gradient's largest entry of the one-rank step's
    and the JAX package's, but for entries on an int8 grid's edge (1 in
    10,000).  One step, as ``test_torch_training`` holds it: the error
    buffer carries an entry that an edge parted into every later step.
    (2 microbatches, each rank its shard of each, and a sequence of 1024,
    chunked_attention's 2 chunks of 512: the tests above.)"""
    name = "(2, 2) compression"
    whole = _gathered(runs, name, lambda r: (r["steps"][0]["params"],
                                             r["steps"][0]["opt"]))
    got = leaves(whole.opt_state["err"])
    g = leaves(runs["one"][name]["grads"])
    one = leaves(runs["one"][name]["steps"][0]["state"].opt_state["err"])
    jx = [_jx(runs, name, f"err/0/{i}") for i in range(len(got))]
    for ref in ([t.numpy() for t in one], jx):
        off = total = 0
        for a, b, gg in zip(got, ref, g, strict=True):
            d = np.abs(a.numpy() - b)
            off += int((d > GRAD_REL * float(gg.abs().max())).sum())
            total += d.size
        assert off <= total // 10_000


def test_forward_last_only_across_ranks(runs):
    """The prefill cell: ``forward(last_only=True)`` over each rank's batch
    shard after the 3 steps, the logits gathered over the model ranks,
    within 1e-5 of one rank's at the same rows."""
    want = runs["one"][T.MAIN]["last_only"]
    for r in runs["ranks"][T.MAIN]:
        lo, hi = r["last_only"]["rows"]
        got = r["last_only"]["logits"]
        assert got.shape == (hi - lo, 1, W.config().vocab)
        assert (got - want[lo:hi]).abs().max() <= 1e-5


# ------------------------------------------------------------------ refusals


@pytest.fixture
def fake_world():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.distributed.device_mesh import init_device_mesh
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        yield lambda dims: init_device_mesh("cpu", dims,
                                            mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,item", [("qwen3-moe-235b-a22b", "A13.3"),
                                       ("rwkv6-1.6b", "A13.4"),
                                       ("whisper-small", "A13.10"),
                                       ("internvl2-26b", "A13.10")])
def test_other_families_refuse_training_across_ranks(fake_world, arch, item):
    """On a (1, 2) mesh the model itself refuses moe and the recurrent
    families (whisper and InternVL2 serve across ranks, so their model is
    built, and the train step refuses); on a (2, 1) mesh the train step
    refuses them all."""
    run = RunConfig(**T.F32)
    cfg = reduced_config(get_config(arch), layers=2)
    shape = ShapeSpec("train", 32, 4, "train")
    if cfg.family in ("encdec", "vlm"):
        m = build_model(cfg, run, shape, device="cpu", mesh=fake_world((1, 2)))
        with pytest.raises(NotImplementedError, match=item):
            make_train_step(m, make_optimizer(run, 10), run)
    else:
        with pytest.raises(NotImplementedError, match=item):
            build_model(cfg, run, shape, device="cpu", mesh=fake_world((1, 2)))
    m = build_model(cfg, run, shape, device="cpu", mesh=fake_world((2, 1)))
    with pytest.raises(NotImplementedError, match=item):
        make_train_step(m, make_optimizer(run, 10), run)


def test_compiled_step_and_trainer_refuse_across_ranks(fake_world):
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.training.step import CompiledTrainStep
    from repro_torch.training.trainer import Trainer
    run = RunConfig(**T.F32)
    m = build_model(W.config(), run, T.shape(), device="cpu", mesh=fake_world((2, 1)))
    assert m.across_ranks and m.ctx.dp.size == 2 and m.ctx.tp is None
    with pytest.raises(NotImplementedError, match="A13.6"):
        CompiledTrainStep(m, make_optimizer(run, 10), run)
    with pytest.raises(NotImplementedError, match="A13.7"):
        Trainer(m, SyntheticLM(m.cfg, m.shape, seed=0), run)


def test_collectives_refuse_a_strided_tensor(fake_world):
    """gloo would reduce a strided view's storage, not its elements (a
    wrong gradient and no error): every collective of ``comm`` raises."""
    from repro_torch.distributed.comm import DataAxis, ModelAxis
    mesh = fake_world((1, 2))
    axis = ModelAxis.of(mesh)
    t = torch.zeros((4, 6))[:, ::2]
    assert not t.is_contiguous()
    with pytest.raises(ValueError, match="non-contiguous"):
        axis.sum_(t)
    with pytest.raises(ValueError, match="non-contiguous"):
        axis.gather(t, -1, 0, 6)
    with pytest.raises(ValueError, match="non-contiguous"):
        axis.gather_parts([(t, 0, 6)])
    with pytest.raises(ValueError, match="non-contiguous"):
        axis.reduce(t)
    with pytest.raises(ValueError, match="non-contiguous"):
        axis.max(t)
    with pytest.raises(ValueError, match="non-contiguous"):
        axis.gather_shards([t], [(1, 0, 6)])
    axis.sum_(t.contiguous())
    assert DataAxis.of(fake_world((2, 1))).size == 2


def test_err_buffer_of_sharded_params_skips_splits():
    """The error buffer and the moments of a tree holding ``w_split``
    entries are tensors only (no split reaches the update)."""
    from repro_torch.training.optimizer import AdamW
    p = {"w": torch.ones((2, 2)), "w_split": ("col", 0, 1, 2)}
    assert list(init_error_buffer(p)) == ["w"]
    assert list(AdamW().init(p)["m"]) == ["w"]
    assert list(AdamW(eightbit=True).init(p)["m_s"]) == ["w"]
