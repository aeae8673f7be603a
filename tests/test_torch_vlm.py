"""The vlm family (InternVL2-26B's language model over a stub vision
prefix) against the JAX package, on ``reduced_config`` in float32 with
the reference's parameters (``vision_proj`` carried by
``from_jax_params``).

- ``forward``: the ``vision_proj`` of the patches prepended to the token
  embeddings, logits over both within 1e-5 (float32 sums in another
  order); ``loss`` (the vision positions carry no label) within 1e-5;
- ``generate_static``: the prefill of ``vision_tokens + plen`` positions
  with the embeddings standing in, then lock-step decode, greedy tokens
  identical to the JAX engine's; ``generate`` takes that path; a second
  call makes no new program;
- the engine's refusals of the continuous path's options, and
  ``input_specs``' patches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models.model import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 2, "decode")
ARCH = "internvl2-26b"


@pytest.fixture(scope="module")
def models():
    jm = jbuild_model(jreduced(jget_config(ARCH), layers=2), JRun(**F32),
                      JShape(*SHAPE))
    m = build_model(reduced_config(get_config(ARCH), layers=2),
                    RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    jparams = jm.init(jax.random.PRNGKey(0))
    return jm, jparams, m, from_jax_params(jax.tree.map(np.asarray, jparams))


def _batch(m, b=2, plen=12, seed=3, labels=False):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 512, (b, plen)).astype(np.int32),
             "patches": rng.standard_normal(
                 (b, m.cfg.vision_tokens, m.cfg.d_model)).astype(np.float32)}
    if labels:
        batch["labels"] = rng.integers(0, 512, (b, plen)).astype(np.int32)
    return batch


def test_vision_proj_carried_and_initialised(models):
    jm, jparams, m, params = models
    own = m.init(torch.Generator().manual_seed(0))
    d = m.cfg.d_model
    assert own["vision_proj"]["w"].shape == params["vision_proj"]["w"].shape == (d, d)
    assert np.array_equal(params["vision_proj"]["w"].numpy(),
                          np.asarray(jparams["vision_proj"]["w"]))


def test_forward_and_loss_match_reference(models):
    jm, jparams, m, params = models
    batch = _batch(m, labels=True)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    got, _ = m.forward(params, batch)
    want, _ = jm.forward(jparams, jbatch)
    assert got.shape == (2, m.cfg.vision_tokens + 12, m.cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    loss, metrics = m.loss(params, batch)
    jloss, jmetrics = jm.loss(jparams, jbatch)
    np.testing.assert_allclose(loss.item(), float(jloss), atol=1e-5, rtol=0)
    np.testing.assert_allclose(metrics["nll"].item(), float(jmetrics["nll"]),
                               atol=1e-5, rtol=0)


def test_generate_static_matches_reference(models):
    jm, jparams, m, params = models
    batch = _batch(m, seed=5)
    eng, jeng = Engine(m, params, device="cpu"), JEngine(jm, jparams)
    assert not eng.continuous and not jeng.continuous
    want = jeng.generate_static({k: jnp.asarray(v) for k, v in batch.items()}, 8)
    got = eng.generate_static(batch, 8)
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)
    counts = dict(m.trace_counts)
    np.testing.assert_array_equal(eng.generate(batch, 8), want)
    assert dict(m.trace_counts) == counts == {"decode": 2, "paged": 0, "flat": 0}


@pytest.mark.parametrize("opt", [dict(chunk_tokens=16), dict(flat=True),
                                 dict(prefix_cache=True), dict(spec_tokens=2)])
def test_engine_refuses_the_continuous_options(models, opt):
    jm, jparams, m, params = models
    with pytest.raises(ValueError, match="generate_static"):
        Engine(m, params, device="cpu", **opt)


def test_input_specs_match_reference(models):
    jm, jparams, m, params = models
    for kind in ("train", "prefill"):
        got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
               for k, v in m.input_specs(kind).items()}
        want = {k: (tuple(v.shape), str(v.dtype))
                for k, v in jm.input_specs(kind).items()}
        assert got == want
