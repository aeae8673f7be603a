"""The port's training path against the JAX package's, on the CPU.

Reduced SmolLM2 (2 layers) in float32 on ``presets["tpu_v5e"]``, the
reference's parameters and state carried across by ``from_jax_params`` /
``from_jax_state``, batches from the JAX package's ``SyntheticLM``:

- ``model.loss`` and every gradient leaf against ``jax.value_and_grad`` at
  seq 32 and at seq 1024 batch 1 (the ``chunked_attention`` path), and
  remat on = off bit for bit inside the port;
- the port's ``SyntheticLM`` bit for bit the JAX package's;
- ``AdamW.update`` (float32 and 8-bit), ``schedule``, clipping and
  ``compress_with_feedback`` against the JAX package's;
- ``make_train_step`` (plain, ``microbatch`` 4 and 2, 8-bit moments,
  compression, remat) against the JAX package's, every state leaf written
  in place; no two state leaves share storage; the step's device scalars
  (lr and the bias corrections) against the JAX package's;
- ``launch.train --device cpu --reduced`` runs; without a card and without
  ``--device cpu`` it raises.

Tolerances, each with its reason, where the test states it.
"""

import dataclasses
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
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.model import build_model as jbuild_model
from repro.training import compression as jcompression
from repro.training.optimizer import AdamW as JAdamW
from repro.training.optimizer import make_optimizer as jmake_optimizer
from repro.training.step import make_train_step as jmake_train_step
from repro.training.train_state import TrainState as JTrainState
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as launch_train
from repro_torch.models.model import build_model
from repro_torch.training import compression
from repro_torch.training import optimizer
from repro_torch.training.optimizer import AdamW, leaves, make_optimizer
from repro_torch.training.step import make_train_step, value_and_grad
from repro_torch.weights import from_jax_params, from_jax_state

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
# loss and gradients: float32 sums in another order (einsum vs dot_general,
# the packed matmul, the attention softmax), measured at about 1e-6 of each
# leaf's largest gradient; 2e-5 leaves an order of magnitude of margin
GRAD_REL = 2e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(seq, batch, **run):
    jcfg = jreduced(jget_config("smollm2-135m"), layers=2)
    cfg = reduced_config(get_config("smollm2-135m"), layers=2)
    shape = (f"t{seq}", seq, batch, "train")
    jm = jbuild_model(jcfg, JRun(**{**F32, **run}), JShape(*shape))
    m = build_model(cfg, RunConfig(**{**F32, **run}), ShapeSpec(*shape), device="cpu")
    return jm, m


@pytest.fixture(scope="module")
def jparams():
    jm, _ = _pair(32, 2)
    return jm.init(jax.random.PRNGKey(0))


def _batch(seq, batch, step=0):
    cfg = jreduced(jget_config("smollm2-135m"), layers=2)
    return JSyntheticLM(cfg, JShape("t", seq, batch, "train"), seed=0).batch_at(step)


def _assert_grads_close(jg, g):
    jl, tl = jax.tree.leaves(jg), leaves(g)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.shape == tuple(b.shape)
        assert np.abs(b.numpy() - a).max() <= GRAD_REL * np.abs(a).max()


@pytest.mark.parametrize("seq,batch", [(32, 2), (1024, 1)], ids=["seq32", "chunked1024"])
def test_loss_and_grads_match_jax(jparams, seq, batch):
    """Loss within 1e-6 relative (float32), every gradient leaf within
    GRAD_REL of its largest entry; seq 1024 runs chunked_attention (two
    512-query chunks, each checkpointed) in both packages."""
    jm, m = _pair(seq, batch)
    b = _batch(seq, batch)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    (loss, met), g = value_and_grad(m, from_jax_params(_np(jparams)), b)
    assert abs(float(loss) - float(jl)) <= 1e-6 * abs(float(jl))
    for k in ("nll", "z_loss", "loss"):
        assert abs(float(met[k]) - float(jmet[k])) <= 1e-6 * abs(float(jmet[k]))
    _assert_grads_close(jg, g)


def test_forward_last_only_and_aux(jparams):
    """``forward(last_only=True)`` is the last position of the full
    forward (bit for bit), and aux is the dense family's zeros."""
    jm, m = _pair(32, 2)
    params = from_jax_params(_np(jparams))
    b = _batch(32, 2)
    full, aux = m.forward(params, b)
    last, _ = m.forward(params, b, last_only=True)
    jfull, jaux = jm.forward(jparams, {k: jnp.asarray(v) for k, v in b.items()})
    assert last.shape == (2, 1, 512) and torch.equal(last[:, 0], full[:, -1])
    assert np.abs(full.numpy() - np.asarray(jfull)).max() <= 1e-5 * np.abs(np.asarray(jfull)).max()
    assert aux == {k: float(v) for k, v in jaux.items()}


@pytest.mark.parametrize("seq,batch", [(32, 2), (1024, 1)], ids=["seq32", "chunked1024"])
def test_remat_equals_no_remat_bitwise(jparams, seq, batch):
    """torch.utils.checkpoint per layer group (and per attention chunk)
    recomputes the forward exactly: loss and every gradient bit for bit."""
    b = _batch(seq, batch)
    params = from_jax_params(_np(jparams))
    out = {}
    for remat in (False, True):
        _, m = _pair(seq, batch, remat=remat)
        out[remat] = value_and_grad(m, params, b)
    (l0, _), g0 = out[False]
    (l1, _), g1 = out[True]
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, c) for a, c in zip(leaves(g0), leaves(g1)))


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)], ids=["whole", "shard1of2"])
def test_synthetic_lm_batches_bit_identical(shard):
    jcfg = jreduced(jget_config("smollm2-135m"), layers=2)
    cfg = reduced_config(get_config("smollm2-135m"), layers=2)
    for step in (0, 7, 1234):
        a = JSyntheticLM(jcfg, JShape("t", 48, 4, "train"), seed=3,
                         shard_index=shard[0], shard_count=shard[1]).batch_at(step)
        b = SyntheticLM(cfg, ShapeSpec("t", 48, 4, "train"), seed=3,
                        shard_index=shard[0], shard_count=shard[1]).batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


# ------------------------------------------------------ optimizer, compression

def _grads_like(params, seed, scale=1e-2):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (rng.standard_normal(p.shape) * scale)
                        .astype(np.float32), _np(params))


def test_schedule_matches_jax():
    """Warmup then cosine, in float32 in both: within 1 ulp (XLA's cos on
    the CPU is not numpy's)."""
    kw = dict(lr=3e-4, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    j, t = JAdamW(**kw), AdamW(**kw)
    for step in (0, 1, 5, 9, 10, 11, 50, 109, 110, 500):
        want = float(j.schedule(jnp.int32(step)))
        assert t.schedule(step) == pytest.approx(want, rel=2 ** -22)


@pytest.mark.parametrize("clip, sliced", [pytest.param(1.0, False, id="clip"),
                                           pytest.param(0.0, False, id="noclip"),
                                           pytest.param(1.0, True, id="clip-sliced")])
def test_adamw_update_matches_jax(jparams, clip, sliced, monkeypatch):
    """Three float32 AdamW steps on the model's tree (matrices decayed, the
    rest not), gradients scaled so clipping acts: parameters within 1e-6
    relative, moments within 1e-6 of their largest entry, grad_norm within
    1e-6 (float32 sums in another order).  ``sliced``: every leaf of more
    than 1,000 elements updated 1,000 at a time (``UPDATE_SLICE``, which
    keeps a CUDA graph's temporaries small: ROADMAP C11), the parameters
    and moments equal the whole leaves' update's bit for bit."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, grad_clip=clip)
    jopt, opt = JAdamW(**kw), AdamW(**kw)
    jp, p = jparams, from_jax_params(_np(jparams))
    js, s = jopt.init(jp), opt.init(p)
    whole = (from_jax_params(_np(jparams)), opt.init(p))
    jupdate = jax.jit(jopt.update)
    for step in range(3):
        g = _grads_like(jp, step, scale=1.0)
        jp, js, jmet = jupdate(jax.tree.map(jnp.asarray, g), js, jp, jnp.int32(step))
        if sliced:
            whole = opt.update(from_jax_params(g), whole[1], whole[0],
                               opt.scalars(step, "cpu"))[:2]
            monkeypatch.setattr(optimizer, "UPDATE_SLICE", 1000)
        p, s, met = opt.update(from_jax_params(g), s, p, opt.scalars(step, "cpu"))
        monkeypatch.undo()
        assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-6)
        assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=2 ** -22)
    if sliced:
        assert max(t.numel() for t in leaves(p)) > 1000
        assert all(torch.equal(a, b) for a, b in zip(
            leaves({"p": whole[0], "s": whole[1]}), leaves({"p": p, "s": s})))
    for a, b in zip(jax.tree.leaves(jp), leaves(p)):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 1e-6 * max(1.0, np.abs(a).max())
    for key in ("m", "v"):
        for a, b in zip(jax.tree.leaves(js[key]), leaves(s[key])):
            a = np.asarray(a)
            assert np.abs(b.numpy() - a).max() <= 1e-6 * max(1e-30, np.abs(a).max())


def test_adamw_8bit_update_matches_jax(jparams):
    """Two 8-bit AdamW steps: the int8 moments equal the JAX package's but
    for +-1 on a counted few (x / s lands within rounding of a half step,
    where float32 division in another order rounds the other way); at most
    1 in 10,000 entries; the float32 scales and the parameters within 1e-6
    relative."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=20, eightbit=True)
    jopt, opt = JAdamW(**kw), AdamW(**kw)
    jp, p = jparams, from_jax_params(_np(jparams))
    js, s = jopt.init(jp), opt.init(p)
    jupdate = jax.jit(jopt.update)
    for step in range(2):
        g = _grads_like(jp, 10 + step)
        jp, js, _ = jupdate(jax.tree.map(jnp.asarray, g), js, jp, jnp.int32(step))
        p, s, _ = opt.update(from_jax_params(g), s, p, opt.scalars(step, "cpu"))
    off, total = 0, 0
    for key in ("m_q", "v_q"):
        for a, b in zip(jax.tree.leaves(js[key]), leaves(s[key])):
            a = np.asarray(a)
            assert b.dtype == (torch.int8 if a.dtype == np.int8 else torch.float32)
            d = np.abs(b.numpy().astype(np.float64) - a.astype(np.float64))
            if a.dtype == np.int8:
                assert d.max() <= 1
                off += int((d > 0).sum())
                total += d.size
            else:
                assert d.max() <= 1e-6 * max(1e-30, np.abs(a).max())
    assert off <= total // 10_000
    for key in ("m_s", "v_s"):
        for a, b in zip(jax.tree.leaves(js[key]), leaves(s[key])):
            assert np.allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=0)
    for a, b in zip(jax.tree.leaves(jp), leaves(p)):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 1e-6 * max(1.0, np.abs(a).max())


def test_compress_with_feedback_matches_jax():
    """Five rounds of int8 error feedback on one gradient: the decompressed
    gradients and the error buffer within one quantization step on at most
    1 in 10,000 entries (x / s within rounding of a half step), equal
    elsewhere to 1e-6 of the step."""
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal((64, 96)).astype(np.float32),
         "b": rng.standard_normal((96,)).astype(np.float32)}
    jerr = jcompression.init_error_buffer(jax.tree.map(jnp.asarray, g))
    err = compression.init_error_buffer(from_jax_params(g))
    for _ in range(5):
        jout, jerr = jcompression.compress_with_feedback(jax.tree.map(jnp.asarray, g), jerr)
        out, err = compression.compress_with_feedback(from_jax_params(g), err)
        for k in g:
            step = np.abs(np.asarray(jout[k])).max() / 127
            for a, b in ((jout[k], out[k]), (jerr[k], err[k])):
                d = np.abs(b.numpy() - np.asarray(a))
                far = d > 1e-6 * step
                assert far.sum() <= max(1, d.size // 10_000)
                assert d.max() <= 1.0001 * step


# ---------------------------------------------------------------- train steps

def _assert_state_close(jstate: dict, state: dict, grads=None):
    """Optimizer state after one step from one state, against the JAX
    package's: every float32 leaf (moments, scales) within GRAD_REL of its
    largest entry, since each is the gradients scaled or squared; the error
    buffer, a remainder below half a quantization step of the gradient
    ``grads``, within GRAD_REL of that gradient's largest entry; the int8
    moments within 1.  A counted few entries may differ by more where a
    value lies within that tolerance of a rounding edge of an int8 grid (a
    moment's, or the compressed gradient's, where the error buffer and the
    moments take a whole quantization step apart): at most 1 in 10,000."""
    assert sorted(state) == sorted(jstate)
    off = total = 0
    for key in sorted(state):
        base = leaves(grads) if key == "err" else leaves(state[key])
        for a, b, c in zip(jax.tree.leaves(jstate[key]), leaves(state[key]), base,
                           strict=True):
            a = np.asarray(a).astype(np.float64)
            assert a.shape == tuple(b.shape)
            d = np.abs(b.numpy().astype(np.float64) - a)
            if b.dtype == torch.int8:
                assert d.max() <= 1
                off += int((d > 0).sum())
            else:
                top = float(c.abs().max()) if key == "err" else np.abs(a).max()
                off += int((d > GRAD_REL * max(1e-30, top)).sum())
            total += d.size
    assert off <= total // 10_000


_STEP_CASES = {"0": dict(microbatch=0), "4": dict(microbatch=4),
               "8bit": dict(adam_8bit=True), "compression": dict(grad_compression=True),
               "micro2": dict(microbatch=2), "remat": dict(remat=True)}


@pytest.mark.parametrize("case", list(_STEP_CASES))
def test_train_step_matches_jax(case):
    """One train step from one state (reduced SmolLM2, seq 16, batch 8),
    plain, with microbatches (4, 2), 8-bit moments, gradient compression or
    remat: the step writes every state leaf in place (each keeps its
    ``data_ptr``); loss within 1e-6 relative and the lr metric within 1 ulp
    (XLA's cos on the CPU is not numpy's); every parameter within 1e-6 of
    the JAX package's except where a near-zero gradient's sign differs,
    which Adam's first step turns into a difference of 2 * lr: such entries
    are counted, at most 1 in 10,000, and none differs by more than 2 * lr;
    the optimizer state as :func:`_assert_state_close` says."""
    run = dict(F32, warmup_steps=1, **_STEP_CASES[case])
    jm, m = _pair(16, 8, **run)
    jopt = jmake_optimizer(JRun(**run), 10)
    opt = make_optimizer(RunConfig(**run), 10)
    jst = JTrainState.create(jm.init(jax.random.PRNGKey(1)), jopt)
    if run.get("grad_compression"):
        jst.opt_state["err"] = jcompression.init_error_buffer(jst.params)
    st = from_jax_state(np.asarray(jst.step), _np(jst.params), _np(jst.opt_state))
    ptrs = [t.data_ptr() for t in leaves({"p": st.params, "o": st.opt_state})]
    b = _batch(16, 8)
    _, grads = value_and_grad(m, st.params, b)
    jst2, jmet = jax.jit(jmake_train_step(jm, jopt, JRun(**run)))(
        jst, {k: jnp.asarray(v) for k, v in b.items()})
    st2, met = make_train_step(m, opt, RunConfig(**run))(st, b)
    assert st2.step == int(jst2.step) == 1
    assert [t.data_ptr() for t in leaves({"p": st2.params, "o": st2.opt_state})] == ptrs
    assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-6)
    assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=2 ** -22)
    lr = opt.schedule(0)
    off, total = 0, 0
    for a, b_ in zip(jax.tree.leaves(jst2.params), leaves(st2.params)):
        d = np.abs(b_.numpy() - np.asarray(a))
        assert d.max() <= 2 * lr * 1.0001
        off += int((d > 1e-6).sum())
        total += d.size
    assert off <= total // 10_000
    _assert_state_close(jst2.opt_state, st2.opt_state, grads)


@pytest.mark.parametrize("eightbit", [False, True], ids=["f32", "8bit"])
def test_optimizer_state_leaves_own_their_storage(jparams, eightbit):
    """The step writes every state leaf in place, so no two leaves of the
    parameters, ``AdamW.init`` and the error buffer may share storage (the
    JAX package's 8-bit init gives a 1-D leaf's m and v one buffer, ROADMAP
    C3)."""
    p = from_jax_params(_np(jparams))
    state = AdamW(eightbit=eightbit).init(p)
    state["err"] = compression.init_error_buffer(p)
    ptrs = [t.untyped_storage().data_ptr() for t in leaves({"p": p, "o": state})]
    assert len(set(ptrs)) == len(ptrs)


def test_step_scalars_match_jax(jparams):
    """The step's scalars at steps 0, 1 and ``warmup_steps``: float32 [lr,
    bc1, bc2] equal to ``schedule`` and within 1 ulp of the JAX package's
    schedule and bias corrections ``1 - b ** (step + 1)`` (XLA's cos and pow
    on the CPU are not numpy's); the update's lr metric is that value, on
    the parameters' device."""
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20)
    jopt, opt = JAdamW(**kw), AdamW(**kw)
    jbc = jax.jit(lambda step: [1 - b ** (step.astype(jnp.float32) + 1.0)
                                for b in (jopt.b1, jopt.b2)])
    p = from_jax_params(_np(jparams))
    state = opt.init(p)
    g = from_jax_params(_grads_like(jparams, 0))
    for step in (0, 1, kw["warmup_steps"]):
        sc = opt.scalars(step, "cpu")
        assert sc.dtype == torch.float32 and tuple(sc.shape) == (3,)
        assert float(sc[0]) == opt.schedule(step)
        want = [float(jopt.schedule(jnp.int32(step))), *map(float, jbc(jnp.int32(step)))]
        assert sc.tolist() == pytest.approx(want, rel=2 ** -22)
        _, _, met = opt.update(g, state, p, sc)
        assert met["lr"].device == sc.device and float(met["lr"]) == float(sc[0])


# ------------------------------------------------- kernel calls of a step

@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_train_step_kernel_calls(jparams, remat, monkeypatch):
    """The CPU's analogue of the card's launch counts (chip_smoke.py checks
    them per step): one value_and_grad of reduced SmolLM2 calls each kernel
    wrapper as often as the card launches it.  Per layer: 7 linears, each
    packing its weight (pack_rhs) and running mmt4d, dgrad and wgrad; the
    Q/K/V exits store unpacked, so their gradients are packed back; the O
    linear packs its input; the gate's pre-activation is recomputed once in
    its backward; every pack's gradient is an unpack.  Plus the stream
    entry and the tied head.  Remat runs each layer's forward twice."""
    # the module (repro_torch.core.mmt4d is the function the package exports)
    core_mmt4d = importlib.import_module("repro_torch.core.mmt4d")
    from repro_torch.core import packing as core_packing
    calls = {}

    def counted(mod, attr, key):
        fn = getattr(mod, attr)

        def wrapper(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, attr, wrapper)

    for mod, attr, key in ((core_packing, "pack", "pack"), (core_packing, "unpack", "unpack"),
                           (core_mmt4d, "mmt4d_kernel", "mmt4d"),
                           (core_mmt4d, "mmt4d_dgrad", "mmt4d_dgrad"),
                           (core_mmt4d, "mmt4d_wgrad", "mmt4d_wgrad")):
        counted(mod, attr, key)
    _, m = _pair(32, 2, remat=remat)
    value_and_grad(m, from_jax_params(_np(jparams)), _batch(32, 2))
    layers = 2
    want = {"mmt4d": 8 * layers + 1 + 7 * layers * remat, "mmt4d_dgrad": 7 * layers + 1,
            "mmt4d_wgrad": 7 * layers + 1, "pack": 11 * layers + 3 + 8 * layers * remat,
            "unpack": 8 * layers + 2}
    assert calls == want


# ---------------------------------------------------------------- launcher

def test_launcher_runs_on_cpu(capsys):
    state, history = launch_train.main(["--reduced", "--device", "cpu", "--steps", "3",
                                        "--seq", "16", "--batch", "2"])
    assert state.step == 3 and len(history) == 3 and all(np.isfinite(history))
    assert "[train] smollm2-135m-smoke: step 3  loss" in capsys.readouterr().out


def test_launcher_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        launch_train.main(["--reduced", "--steps", "1", "--seq", "16", "--batch", "2"])
