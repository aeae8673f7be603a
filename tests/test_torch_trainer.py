"""The port's checkpoints and trainer against the JAX package's, on the CPU.

- Checkpoints: the same on-disk format (``manifest.json`` + ``arrays.npz``,
  bf16 as uint16 views, checksums, atomic rename): a round trip of
  float32, int8, int32 and bf16 leaves, a fingerprint mismatch, a corrupt
  save skipped by ``latest_step``, ``prune``; a checkpoint the JAX package
  writes restores in the port and one the port writes restores in the JAX
  package, leaf for leaf.
- ``fingerprint_of`` gives the JAX package's hash for equal configs.
- The trainers: a JAX-written step-0 checkpoint (so one state) resumed by
  the port's ``Trainer`` and by the JAX package's for 4 steps, loss
  histories compared; and crash/resume in the port bit for bit against an
  uninterrupted run (history and parameters).
- The compiled train step counts its signatures in
  ``model.trace_counts["train"]`` as the JAX trainer's jitted step traces.
"""

import os
import shutil

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
from repro.training import checkpoint as jckpt
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import fingerprint_of as jfingerprint_of
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import leaves
from repro_torch.training.trainer import Trainer, fingerprint_of

torch.set_num_threads(1)

RUN = dict(param_dtype="float32", compute_dtype="float32", remat=False,
           warmup_steps=2)
SHAPE = ("t", 16, 4, "train")


def _tree(scalar=False):
    tree = {"params": {"w": torch.randn(4, 3), "n": torch.arange(5, dtype=torch.int32)},
            "opt": {"q": torch.arange(-3, 3, dtype=torch.int8),
                    "bf": torch.randn(3, 2).to(torch.bfloat16)}}
    if scalar:      # a 0-d leaf: the 8-bit state's scale of a 1-D parameter
        tree["opt"]["s"] = torch.tensor(0.5)
    return tree


def test_checkpoint_roundtrip(tmp_path):
    """Including a 0-d leaf, which the JAX package's checkpoint code cannot
    save (ROADMAP C)."""
    tree = _tree(scalar=True)
    ckpt.save(str(tmp_path), 7, tree, extra={"note": "x"}, fingerprint="fp")
    got, extra, step = ckpt.restore(str(tmp_path), fingerprint="fp")
    assert step == 7 and extra == {"note": "x"}
    for a, b in zip(leaves(tree), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_fingerprint_corrupt_and_prune(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"x": torch.zeros(3)}, fingerprint="aaa")
    with pytest.raises(ValueError):
        ckpt.restore(d, fingerprint="bbb")
    ckpt.save(d, 2, {"x": torch.ones(3)})
    os.remove(os.path.join(d, "step_00000002", "arrays.npz"))
    assert ckpt.latest_step(d) == 1
    for s in range(3, 8):
        ckpt.save(d, s, {"x": torch.zeros(1)})
    ckpt.prune(d, keep=2)
    assert ckpt.latest_step(d) == 7
    assert sorted(os.listdir(d)) == ["step_00000006", "step_00000007"]


def test_checkpoints_cross_restore(tmp_path):
    """The JAX package restores what the port writes, and the port what
    the JAX package writes: every leaf, dtype (bf16 included) and the
    extra and step."""
    tree = _tree()
    ckpt.save(str(tmp_path / "p"), 3, tree, extra={"ewma_ms": 1.5}, fingerprint="f")
    jtree, extra, step = jckpt.restore(str(tmp_path / "p"), fingerprint="f")
    assert step == 3 and extra == {"ewma_ms": 1.5}
    for a, b in zip(leaves(tree), jax.tree.leaves(jtree)):
        b = np.asarray(b)
        assert str(b.dtype) == str(a.dtype).removeprefix("torch.")
        assert np.array_equal(b.astype(np.float32), a.float().numpy())
    jckpt.save(str(tmp_path / "j"), 4, jtree, fingerprint="f")
    back, _, step = ckpt.restore(str(tmp_path / "j"), fingerprint="f")
    assert step == 4
    for a, b in zip(leaves(tree), leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _models(run):
    jcfg = jreduced(jget_config("smollm2-135m"), layers=2)
    cfg = reduced_config(get_config("smollm2-135m"), layers=2)
    jm = jbuild_model(jcfg, JRun(**run), JShape(*SHAPE))
    m = build_model(cfg, RunConfig(**run), ShapeSpec(*SHAPE), device="cpu")
    return jm, m


@pytest.mark.parametrize("extra", [{}, {"adam_8bit": True, "grad_compression": True}],
                         ids=["adamw", "8bit+compression"])
def test_fingerprints_equal(extra):
    jm, m = _models({**RUN, **extra})
    assert fingerprint_of(m.cfg, RunConfig(**RUN, **extra)) == \
        jfingerprint_of(jm.cfg, JRun(**RUN, **extra))


def test_trainer_from_jax_checkpoint_matches_jax_trainer(tmp_path):
    """One state for both: the JAX trainer's initial state saved at step 0
    with the JAX package's checkpoint code; each trainer resumes from its
    own copy of it (the port's restore checks the JAX fingerprint) and runs
    4 steps on the same stream.  Loss histories within 1e-5 relative
    (float32 sums in another order; the fourth step's loss already carries
    three AdamW updates)."""
    jm, m = _models(RUN)
    jcfg = jm.cfg
    jdata = JSyntheticLM(jcfg, JShape(*SHAPE), seed=0)
    data = SyntheticLM(m.cfg, ShapeSpec(*SHAPE), seed=0)
    quiet = lambda *_: None
    jt = JTrainer(jm, jdata, JRun(**RUN), ckpt_dir=str(tmp_path / "j"),
                  total_steps=4, ckpt_every=2, log_fn=quiet)
    st0 = jt.init_state(jax.random.PRNGKey(0))
    jckpt.save(str(tmp_path / "j"), 0, {"params": st0.params, "opt_state": st0.opt_state},
               fingerprint=jt.fingerprint)
    shutil.copytree(tmp_path / "j", tmp_path / "p")
    logs = []
    t = Trainer(m, data, RunConfig(**RUN), ckpt_dir=str(tmp_path / "p"),
                total_steps=4, ckpt_every=2, log_fn=logs.append)
    assert t.fingerprint == jt.fingerprint
    jstate, jhist = jt.fit(jax.random.PRNGKey(0))
    state, hist = t.fit(torch.Generator().manual_seed(0))
    assert logs[0] == "[trainer] resumed from step 0"
    assert state.step == int(jstate.step) == 4 and len(hist) == len(jhist) == 4
    np.testing.assert_allclose(hist, jhist, rtol=1e-5)
    assert ckpt.latest_step(str(tmp_path / "p")) == 4


def test_trainer_crash_resume_bitwise(tmp_path):
    """Crash at step 5 (after the checkpoint at 4), resume: the loss
    history and the final parameters and optimizer state equal an
    uninterrupted run's bit for bit."""
    _, m = _models(RUN)
    data = SyntheticLM(m.cfg, ShapeSpec(*SHAPE), seed=0)

    def mk(d):
        return Trainer(m, data, RunConfig(**RUN), ckpt_dir=str(d), total_steps=6,
                       ckpt_every=2, log_fn=lambda *_: None)

    ref, ref_hist = mk(tmp_path / "ref").fit(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="injected failure at step 5"):
        mk(tmp_path / "a").fit(torch.Generator().manual_seed(0), fail_at=5)
    assert ckpt.latest_step(str(tmp_path / "a")) == 4
    got, hist = mk(tmp_path / "a").fit(torch.Generator().manual_seed(0))
    assert got.step == ref.step == 6 and hist == ref_hist[4:]
    for a, b in zip(leaves({"p": ref.params, "o": ref.opt_state}),
                    leaves({"p": got.params, "o": got.opt_state})):
        assert torch.equal(a, b)


def test_train_step_signatures_count_like_jax_jit():
    """The JAX trainer jits its step (``donate_argnums=(0,)``); over one
    batch shape, a second, then the first again its cache holds two
    programs, and the port trainer's compiled step counts the same in
    ``model.trace_counts["train"]`` and ``trace_log`` after every call.
    float32 AdamW: the JAX trainer cannot run 8-bit moments (ROADMAP C3).
    A model that never trained keeps the reference's three kinds."""
    jm, m = _models(RUN)
    assert sorted(m.trace_counts) == sorted(jm.trace_counts)
    quiet = lambda *_: None
    jt = JTrainer(jm, JSyntheticLM(jm.cfg, JShape(*SHAPE), seed=0), JRun(**RUN),
                  log_fn=quiet)
    t = Trainer(m, SyntheticLM(m.cfg, ShapeSpec(*SHAPE), seed=0), RunConfig(**RUN),
                log_fn=quiet)
    jst = jt.init_state(jax.random.PRNGKey(0))
    st = t.init_state(torch.Generator().manual_seed(0))
    for seq in (16, 8, 16):
        b = JSyntheticLM(jm.cfg, JShape("t", seq, 4, "train"), seed=0).batch_at(0)
        jst, _ = jt._step_fn(jst, {k: jnp.asarray(v) for k, v in b.items()})
        st, _ = t.step_fn(st, b)
        assert m.trace_counts["train"] == jt._step_fn._cache_size()
    assert m.trace_counts["train"] == 2 and st.step == 3
    assert [e["args"]["tokens"] for e in m.trace_log if e["kind"] == "train"] == \
        [((4, 16), "torch.int32"), ((4, 8), "torch.int32")]
