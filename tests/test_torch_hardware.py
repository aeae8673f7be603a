"""The port's hardware descriptors and the geometry they set, against the
JAX package's, on the CPU.

- The five presets equal the reference's field for field; ``vl``,
  ``native_tile``, ``peak_flops`` and ``scaled(2 | 4)`` give the
  reference's values.
- ``query`` resolves ``name``, then ``$REPRO_HW``, then the device's own
  descriptor, as the reference's ``tests/test_layout.py`` has it; an
  ``h100*`` name on the CPU and an unknown name raise.
- Tiles, page sizes, chunk ladders, flat ladders and prefill buckets equal
  the reference's for every policy x {tpu_v5e, tpu_vl256, tpu_vl512} x
  {float32, bfloat16} (templates ``tests/test_scheduler.py``).
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
from repro.core import hardware as jhardware
from repro.core.layout import make_layout as jmake_layout
from repro.models.model import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.core import hardware
from repro_torch.core.layout import make_layout
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

NAMES = ["tpu_v5e", "tpu_v4", "tpu_vl128", "tpu_vl256", "tpu_vl512"]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
POLICIES = ["scalable", "fixed", "unpacked"]
JFIELDS = [f.name for f in dataclasses.fields(jhardware.HardwareSpec)]


def _fields(hw) -> dict:
    return {k: getattr(hw, k) for k in JFIELDS}


def test_presets_mirror_the_reference():
    assert sorted(hardware.presets) == sorted(jhardware.presets) == sorted(NAMES)
    for name in NAMES:
        assert _fields(hardware.presets[name]) == _fields(jhardware.presets[name]), name


@pytest.mark.parametrize("name", NAMES)
def test_vl_native_tile_scaled_match_the_reference(name):
    hw, jhw = hardware.presets[name], jhardware.presets[name]
    for dt, jdt in DTYPES.values():
        assert hw.vl(dt) == jhw.vl(jdt)
        assert hw.native_tile(dt) == jhw.native_tile(jdt)
        assert hw.peak_flops(dt) == jhw.peak_flops(jdt)
    for f in (2, 4):
        assert _fields(hw.scaled(f)) == _fields(jhw.scaled(f))
    assert hw.scaled(4).hbm_bw == hw.hbm_bw and hw.scaled(4).ici_bw == hw.ici_bw


def test_query_resolution_order(monkeypatch):
    """name, then $REPRO_HW, then the device's own (the CPU: tpu_v5e), as
    the reference's ``test_hardware_query_env``."""
    monkeypatch.delenv("REPRO_HW", raising=False)
    assert query_cpu() is hardware.presets["tpu_v5e"]
    monkeypatch.setenv("REPRO_HW", "tpu_vl256")
    assert query_cpu().lanes == 256 == jhardware.query().lanes
    assert query_cpu("tpu_vl512").lanes == 512          # name beats the variable
    monkeypatch.setenv("REPRO_HW", "h100_vl512")
    with pytest.raises(ValueError, match="describes the card"):
        query_cpu()
    monkeypatch.delenv("REPRO_HW")
    assert query_cpu().name in hardware.presets
    for name in ("h100", "h100_vl256"):
        with pytest.raises(ValueError):
            query_cpu(name)
    with pytest.raises(KeyError):
        query_cpu("tpu_v9")


def query_cpu(name=None):
    return hardware.query("cpu", name)


def test_query_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cuda'"):
        hardware.query()


@pytest.fixture(scope="module")
def jparams():
    jm = jbuild_model(jreduced(jget_config("smollm2-135m"), layers=1),
                      JRun(param_dtype="float32", compute_dtype="float32"),
                      JShape("serve", 64, 3, "decode"))
    return jm.init(jax.random.PRNGKey(0))


ENGINES = {"monolithic": dict(), "dense": dict(chunk_tokens=16, flat=False),
           "flat": dict(chunk_tokens=16, token_budget=24)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("hw", ["tpu_v5e", "tpu_vl256", "tpu_vl512"])
@pytest.mark.parametrize("policy", POLICIES)
def test_tiles_pages_and_ladders_match_the_reference(jparams, policy, hw, dtype):
    dt, jdt = DTYPES[dtype]
    lay = make_layout(policy, hardware.presets[hw], dt)
    jlay = jmake_layout(policy, jhardware.presets[hw], jdt)
    assert (lay.m_r, lay.n_r, lay.k_r, lay.dtype) == \
        (jlay.m_r, jlay.n_r, jlay.k_r, jlay.dtype)
    # the unpacked product is torch.matmul in the port, XLA's dot there
    assert lay.kernel_name == ("plain_matmul" if policy == "unpacked"
                               else jlay.kernel_name)
    run = dict(param_dtype=dtype, compute_dtype=dtype, layout_policy=policy)
    jm = jbuild_model(jreduced(jget_config("smollm2-135m"), layers=1), JRun(**run),
                      JShape("serve", 64, 3, "decode"), hw=jhardware.presets[hw])
    m = build_model(reduced_config(get_config("smollm2-135m"), layers=1),
                    RunConfig(**run), ShapeSpec("serve", 64, 3, "decode"),
                    hw=hardware.presets[hw], device="cpu")
    params = from_jax_params(jax.tree.map(lambda a: np.asarray(a, np.float32), jparams))
    for family in ENGINES.values():
        for page in (3, 16):
            kw = dict(max_slots=3, page_tokens=page, prepack=False, **family)
            eng, jeng = Engine(m, params, device="cpu", **kw), JEngine(jm, jparams, **kw)
            assert eng.pool.page_tokens == jeng.pool.page_tokens
            assert eng.pool.page_tokens % lay.m_r == 0
            assert (eng.chunk_tokens, eng.flat) == (jeng.chunk_tokens, jeng.flat)
            if eng.chunked:
                assert eng._chunk_shapes() == jeng._chunk_shapes()
            if eng.flat:
                assert eng._flat_shapes() == jeng._flat_shapes()
                assert [eng._flat_shape(n) for n in range(1, 25)] == \
                    [jeng._flat_shape(n) for n in range(1, 25)]
            assert [eng._prefill_bucket(n) for n in range(1, 70)] == \
                [jeng._prefill_bucket(n) for n in range(1, 70)]
