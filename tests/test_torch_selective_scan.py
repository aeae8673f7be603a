"""mamba's selective scan in the port (``kernels/selective_scan``) against
the JAX package, on the CPU in float32, and jamba-v0.1 (moe on) served by
the port's engine against the JAX engine:

- the plain version (through the wrapper, as a CPU tensor takes it)
  against the reference mixer's own expressions
  (src/repro/models/mamba.py:110-132: ``da``, ``dbx``, its associative
  ``_ssm_scan``, the einsum, skip and gate) in the three modes: from a
  zero state (train/prefill), one step from a cached state (decode) and
  a prefill from a cached state; y and the final state within 1e-5 of
  max(1, max |value|) (float32 sums in another order);
- the plain version against the mixer's body before the scan became one
  call (a copy kept here), bit for bit, in float32 and bfloat16;
- the wrapper takes the plain version for CPU tensors only (no launch
  counted) and refuses a tensor on any other device without a card;
- reduced jamba-v0.1 (8 layers: seven mamba mixers, attention at index 4,
  moe on every second layer) through the monolithic engine, prepacked,
  at an undersized pool that preempts: greedy tokens identical to the
  JAX engine's, at ``capacity_factor=8`` (nothing dropped) and at the
  default;
- the kernel calls of each of jamba's model calls at one and two periods,
  the CPU's analogue of the launches per call the card is held to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import RunConfig as JRun
from repro.configs import ShapeSpec as JShape
from repro.configs import get_config as jget_config
from repro.configs import reduced_config as jreduced
from repro.models import mamba as jmamba
from repro.models.model import build_model as jbuild_model
from repro.serving.engine import Engine as JEngine
from repro_torch import kernels
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import _ssm_scan, selective_scan_ref
from repro_torch.models.model import build_model
from repro_torch.serving.engine import Engine
from repro_torch.weights import from_jax_params
from test_torch_rwkv import _drain

torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"
F32 = dict(param_dtype="float32", compute_dtype="float32", remat=False)
SHAPE = ("serve", 64, 3, "decode")
# (mode, rows, steps): from zero state, one step from a cached state, a
# prefill from a cached state
MODES = [("zero", 2, 37), ("decode", 3, 1), ("prefill", 2, 23)]


def _inputs(mode, b, s, di=24, n=16, seed=0):
    """Numpy inputs at the mixer's scales: delta a softplus of N(-2, 1),
    x a silu of N(0, 1), z, B and C ~ N(0, 1), a_log = log(1..N) plus
    N(0, 0.1), d_skip ~ 1 + N(0, 0.1), h0 ~ N(0, 1) (zero in the zero
    mode)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    pre = rng.standard_normal((b, s, di)) - 2
    delta = np.log1p(np.exp(pre)).astype(f)
    xr = rng.standard_normal((b, s, di))
    x = (xr / (1 + np.exp(-xr))).astype(f)
    z = rng.standard_normal((b, s, di)).astype(f)
    bm = rng.standard_normal((b, s, n)).astype(f)
    cm = rng.standard_normal((b, s, n)).astype(f)
    a_log = (np.log(np.arange(1, n + 1))[None] + 0.1 * rng.standard_normal(
        (di, n))).astype(f)
    d_skip = (1 + 0.1 * rng.standard_normal(di)).astype(f)
    h0 = (np.zeros((b, di, n)) if mode == "zero"
          else rng.standard_normal((b, di, n))).astype(f)
    return delta, x, z, bm, cm, a_log, d_skip, h0


def _reference(mode, delta, x, z, bm, cm, a_log, d_skip, h0):
    """The reference mixer's expressions (src/repro/models/mamba.py:110-132)
    on the scan's inputs: y and the final state."""
    delta, x, z, bm, cm, a_log, d_skip, h0 = map(
        jnp.asarray, (delta, x, z, bm, cm, a_log, d_skip, h0))
    a = -jnp.exp(a_log)
    da = jnp.exp(delta[..., None] * a)
    dbx = delta[..., None] * bm[:, :, None, :] * x[..., None]
    if mode == "zero":
        h = jmamba._ssm_scan(da, dbx)
    elif x.shape[1] == 1:
        h = (da[:, 0] * h0 + dbx[:, 0])[:, None]
    else:
        dbx = dbx.at[:, 0].add(da[:, 0] * h0)
        h = jmamba._ssm_scan(da, dbx)
    y = jnp.einsum("bsdn,bsn->bsd", h, cm)
    y = y + d_skip * x
    return np.asarray(y * jax.nn.silu(z)), np.asarray(h[:, -1])


def _close(got, want, scale=1e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=scale * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("mode,b,s", MODES, ids=[m[0] for m in MODES])
def test_plain_matches_reference_expressions(mode, b, s, n):
    args = _inputs(mode, b, s, n=n)
    want_y, want_h = _reference(mode, *args)
    t = [torch.from_numpy(a.copy()) for a in args]
    kernels.reset_launch_counts()
    y = selective_scan(*t)
    assert kernels.launch_counts()["selective_scan"] == 0      # the plain version
    assert y.shape == (b, s, args[0].shape[-1]) and y.dtype == torch.float32
    _close(y.numpy(), want_y)
    _close(t[-1].numpy(), want_h)                  # the state, written in place


def _pre_refactor(delta, x_c, z, b_ssm, c_ssm, a_log, d_skip, h0):
    """``mamba_apply``'s body between ``_delta`` and ``out_proj`` as it was
    before the scan became one call (``h0`` None: no cache)."""
    a = -torch.exp(a_log)                                        # [di,N]
    da = torch.exp(delta[..., None] * a)                         # [B,S,di,N]
    dbx = (delta[..., None] * b_ssm[:, :, None, :].float()
           * x_c[..., None].float())
    s = x_c.shape[1]
    if h0 is None:
        h = _ssm_scan(da, dbx)
    else:
        if s == 1:
            h = (da[:, 0] * h0 + dbx[:, 0])[:, None]
        else:       # a prefill from the cached state: h0 enters step 0
            dbx = torch.cat([(dbx[:, 0] + da[:, 0] * h0)[:, None], dbx[:, 1:]], 1)
            h = _ssm_scan(da, dbx)
        h0.copy_(h[:, -1])
    y = torch.einsum("bsdn,bsn->bsd", h, c_ssm.float())
    y = y + d_skip * x_c.float()
    y = (y * F.silu(z.float())).to(x_c.dtype)
    return y, h[:, -1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("mode,b,s", MODES, ids=[m[0] for m in MODES])
def test_plain_is_the_pre_refactor_body_bit_for_bit(mode, b, s, dtype):
    args = [torch.from_numpy(a) for a in _inputs(mode, b, s, seed=3)]
    delta, x, z, bm, cm, a_log, d_skip, h0 = args
    x, z, bm, cm = (t.to(dtype) for t in (x, z, bm, cm))
    want, want_h = _pre_refactor(delta, x, z, bm, cm, a_log, d_skip,
                                 None if mode == "zero" else h0.clone())
    state = h0.clone()
    got = selective_scan_ref(delta, x, z, bm, cm, a_log, d_skip, state)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(state, want_h)


def test_wrapper_plain_for_cpu_tensors_only():
    """Strided views (z from the in-projection's output, B and C from the
    x-projection's) take the plain version on the CPU; a tensor on another
    device than the CPU needs the kernel, and without a card the call
    raises instead of falling back."""
    delta, x, z, bm, cm, a_log, d_skip, h0 = (
        torch.from_numpy(a) for a in _inputs("prefill", 2, 9, seed=5))
    xz = torch.cat([x, z], -1)
    proj = torch.cat([torch.zeros(2, 9, 4), bm, cm], -1)
    di, n = x.shape[-1], bm.shape[-1]
    views = (xz[..., :di], xz[..., di:], proj[..., 4:4 + n], proj[..., 4 + n:])
    state = h0.clone()
    got = selective_scan(delta, *views, a_log, d_skip, state)
    want_h = h0.clone()
    want = selective_scan_ref(delta, *views, a_log, d_skip, want_h)
    assert torch.equal(got, want) and torch.equal(state, want_h)
    dense_h = h0.clone()         # the same values, contiguous: sums may reorder
    _close(got.numpy(), selective_scan_ref(delta, x, z, bm, cm, a_log, d_skip,
                                           dense_h).numpy())
    _close(state.numpy(), dense_h.numpy())
    meta = [t.to("meta") for t in (delta, x, z, bm, cm, a_log, d_skip, h0)]
    with pytest.raises(ValueError, match="CUDA device"):
        selective_scan(*meta)


@pytest.mark.parametrize("cf", [8.0, None], ids=["cf8", "default"])
def test_jamba_moe_drain_matches_jax_engine(cf):
    """Reduced jamba-v0.1 with its moe layers (4 experts, top-2), 8 layers,
    through the monolithic engine with prepacked weights at an undersized
    pool: a request is preempted and re-prefilled from zero state; greedy
    tokens equal the JAX engine's."""
    jcfg, cfg = jreduced(jget_config(ARCH)), reduced_config(get_config(ARCH))
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        cfg = dataclasses.replace(cfg, capacity_factor=cf)
    assert cfg.moe and cfg.n_layers == len(cfg.block_pattern) == 8
    jm = jbuild_model(jcfg, JRun(**F32), JShape(*SHAPE))
    m = build_model(cfg, RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    pool = dict(max_slots=3, page_tokens=8, num_pages=1 + 6)
    eng = Engine(m, from_jax_params(jp), device="cpu", **pool)
    assert "w_pack" in eng.params["lm_head"]
    assert "ffn" in eng.params["groups"]["p1"] and \
        eng.params["groups"]["p1"]["ffn"]["wg"]["w_pack"].ndim == 6   # experts
    want = _drain(JEngine(jm, jax.tree.map(jnp.asarray, jp), **pool))
    kernels.reset_launch_counts()
    got = _drain(eng)
    assert got == want
    assert eng.num_preemptions >= 1 and eng.pool.num_used == 0
    assert kernels.launch_counts()["selective_scan"] == 0      # the CPU's plain path


@pytest.mark.parametrize("periods", [1, 2])
def test_jamba_kernel_calls_per_model_call(periods, monkeypatch):
    """The CPU's analogue of the card's launch counts (chip_smoke.py's
    ``jamba_per_call`` checks them on the card): every model call of the
    monolithic engine, prefill or decode, calls each kernel's plain
    version as often as the card launches the kernel.  Per period of 8
    layers: 7 mamba mixers (3 linears stored unpacked, 3 packs, 1 scan),
    1 attention (4 linears, the O input's pack), 4 moe FFNs (the stream's
    unpack, 3 packs, 3 expert products), 4 dense MLPs (3 linears kept
    packed); per call the stream entry pack, the final unpack, the logits
    rows' pack and the untied head."""
    from repro_torch.kernels.mmt4d import ops as mmt4d_ops
    from repro_torch.kernels.pack import ops as pack_ops
    from repro_torch.kernels.selective_scan import ops as scan_ops
    from repro_torch.kernels.unpack import ops as unpack_ops
    calls = {}

    def counted(mod, attr, key):
        fn = getattr(mod, attr)

        def wrapper(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, attr, wrapper)

    for mod, attr, key in ((mmt4d_ops, "mmt4d_ref", "mmt4d"),
                           (pack_ops, "pack_ref", "pack"),
                           (unpack_ops, "unpack_ref", "unpack"),
                           (scan_ops, "selective_scan_ref", "selective_scan")):
        counted(mod, attr, key)
    cfg = reduced_config(get_config(ARCH), layers=8 * periods)
    m = build_model(cfg, RunConfig(**F32), ShapeSpec(*SHAPE), device="cpu")
    eng = Engine(m, m.init(torch.Generator().manual_seed(0)), device="cpu",
                 max_slots=3, page_tokens=16)
    n, run = [], eng._run_paged
    eng._run_paged = lambda *a, **k: n.append(1) or run(*a, **k)
    rng = np.random.default_rng(0)
    for plen in (5, 9):
        eng.add_request(rng.integers(0, cfg.vocab, plen), 3)
    calls.clear()
    eng.drain()
    g = periods
    want = {"mmt4d": 49 * g + 1, "pack": 34 * g + 2, "unpack": 4 * g + 1,
            "selective_scan": 7 * g}
    assert calls == {k: v * len(n) for k, v in want.items()}
