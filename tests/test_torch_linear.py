"""A linear's exit through mmt4d's unpacked store, against the JAX package.

- ``linear_apply`` (which now has mmt4d write its result unpacked,
  ``unpack_to``) against ``repro.core.linear.linear_apply`` in float32 on
  ``presets["tpu_v5e"]`` on both sides, over SmolLM2's Q and K/V exits, a
  narrow tied head and ragged shapes, leading dims (1,) and (2,), with and
  without bias and activation.  Tolerance: max |port - JAX| <= 1e-5 of the
  largest |JAX| value (float32 sums in another order; the port applies
  bias and activation before its one cast, JAX after, equal in float32).
- ``ops.mmt4d(..., unpack_to=)`` equals ``unpack_ref(mmt4d_ref(...))`` bit
  for bit on the CPU.
- The Python mirror of the unpacked store's index map
  (``Split.stores`` + ``unpacked_index``, as ``csrc/mmt4d.cu`` computes it)
  writes every element of C[..., m, n] exactly once and no tile padding.
- A reduced SmolLM2 flat step on the CPU calls the unpack wrapper once
  (the final stream before the logits gather): the CPU's analogue of the
  card's one unpack launch per step.
"""

import importlib
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import presets
from repro.core.linear import MatmulContext as JCtx
from repro.core.linear import linear_apply as jlinear_apply
from repro_torch.configs import RunConfig, ShapeSpec, get_config, reduced_config
from repro_torch.core import packing
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.hardware import presets as tpresets
from repro_torch.core.layout import make_layout
from repro_torch.core.linear import MatmulContext, linear_apply, prepack_params
from repro_torch.kernels.mmt4d.ops import mmt4d, pick_split, unpacked_index
from repro_torch.kernels.mmt4d.ref import mmt4d_ref
from repro_torch.kernels.unpack.ref import unpack_ref
from repro_torch.models.model import build_model

torch.set_num_threads(1)

# (m, k, n): Q exit and K/V exit at decode, a narrow tied head, ragged shapes
MKN = [(16, 576, 576), (16, 576, 192), (4, 576, 1000), (13, 100, 70),
       (33, 128, 130)]
EPILOGUES = {"plain": (False, None), "bias": (True, None),
             "silu": (False, "silu"), "bias+gelu": (True, "gelu")}
JAX_ACT = {None: None, "silu": jax.nn.silu, "gelu": jax.nn.gelu}


def _arr(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("epilogue", list(EPILOGUES))
@pytest.mark.parametrize("lead", [(1,), (2,)], ids=["lead1", "lead2"])
@pytest.mark.parametrize("mkn", MKN, ids=[f"{m}x{k}x{n}" for m, k, n in MKN])
def test_linear_exit_unpacked_matches_jax(mkn, lead, epilogue):
    m, k, n = mkn
    has_bias, act = EPILOGUES[epilogue]
    p = {"w": _arr((k, n), 1) * k ** -0.5}
    if has_bias:
        p["b"] = _arr((n,), 2)
    x = _arr((*lead, m, k), 3)
    jy = np.asarray(jlinear_apply({kk: jnp.asarray(v) for kk, v in p.items()},
                                  jnp.asarray(x), JCtx(hw=presets["tpu_v5e"]),
                                  activation=JAX_ACT[act]))
    ty = linear_apply({kk: torch.from_numpy(v) for kk, v in p.items()},
                      torch.from_numpy(x), MatmulContext(hw=tpresets["tpu_v5e"]),
                      activation=act)
    assert ty.shape == (*lead, m, n)
    err = np.abs(ty.numpy() - jy).max() / np.abs(jy).max()
    assert err <= 1e-5, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("lead", [(), (1,), (2, 3)], ids=["nolead", "lead1", "lead2x3"])
def test_mmt4d_unpack_to_is_unpack_of_packed(lead, dtype):
    lay = make_layout("scalable", tpresets["tpu_v5e"], dtype)
    m, k, n = 21, 200, 136
    ap = packing.pack_lhs(torch.from_numpy(_arr((*lead, m, k), 4)).to(dtype), lay)
    bp = packing.pack_rhs(torch.from_numpy(_arr((k, n), 5)).to(dtype), lay)
    bias = torch.from_numpy(_arr((bp.shape[0], lay.n_r), 6)).to(dtype)
    a4 = ap.reshape(-1, *ap.shape[-3:])
    for b in (None, bias):
        got = mmt4d(ap, bp, b, activation="gelu", unpack_to=(m, n))
        packed = mmt4d_ref(a4, bp, b, activation="gelu").reshape(
            *lead, ap.shape[-4], *bp.shape[:1], lay.m_r, lay.n_r)
        assert got.shape == (*lead, m, n)
        assert torch.equal(got, unpack_ref(packed, m, n))
        assert torch.equal(mmt4d(ap, bp, b, activation="gelu"), packed)
    with pytest.raises(ValueError, match="unpack_to"):
        mmt4d(ap, bp, unpack_to=(ap.shape[-4] * lay.m_r + 1, n))


# (batch, m, k, n) on the card's bf16 tiles (m_r 16, n_r = k_r = 128):
# Q / K/V exits and the tied head at decode, the Q exit at W = 512 (tm > 1),
# the down projection (split-K in a cluster), two batch elements with a
# ragged m, and N not a multiple of 4 (the kernel's scalar stores)
STORE_CASES = [(1, 16, 576, 576), (1, 16, 576, 192), (1, 4, 576, 49152),
               (1, 512, 576, 576), (1, 16, 1536, 576), (2, 17, 576, 192),
               (2, 15, 128, 130), (1, 1, 1536, 1000)]


@pytest.mark.parametrize("case", STORE_CASES, ids=["x".join(map(str, c)) for c in STORE_CASES])
def test_unpacked_store_writes_every_element_once(case):
    batch, m, k, n = case
    hw = HardwareSpec(name="h100", sm_count=132)
    lay = make_layout("scalable", hw, torch.bfloat16)
    m_r, n_r = lay.m_r, lay.n_r
    mo_b, n_o, k_o = -(-m // m_r), -(-n // n_r), -(-k // lay.k_r)
    m_o = batch * mo_b
    s = pick_split(m_o, n_o, k_o, m_r, n_r, lay.k_r, hw.sm_count)
    hits = np.zeros((batch * m, n), np.int32)
    dropped = 0
    for x in range(s.grid[0]):
        for y in range(s.grid[1]):
            for z in range(s.grid[2]):
                for mo, no, mi, n0 in s.stores(x, y, z, m_o, m_r, n_r):
                    for e in range(4):
                        at = unpacked_index(mo, no, mi, n0 + e, m=m, n_cols=n,
                                            mo_per_batch=mo_b, m_r=m_r, n_r=n_r)
                        if at is None:
                            dropped += 1
                        else:
                            hits[at] += 1
    assert (hits == 1).all(), (s, np.unique(hits, return_counts=True))
    assert dropped == m_o * m_r * n_o * n_r - batch * m * n


def test_flat_step_unpacks_once_on_the_cpu(monkeypatch):
    """Reduced SmolLM2 (2 layers): the unpack wrapper runs once per flat
    step (the final stream), and mmt4d writes unpacked at the 3 Q/K/V exits
    of each layer and the tied head."""
    # the module (repro_torch.core.mmt4d is the function the package exports)
    core_mmt4d = importlib.import_module("repro_torch.core.mmt4d")
    cfg = reduced_config(get_config("smollm2-135m"), layers=2)
    model = build_model(cfg, RunConfig(param_dtype="float32", compute_dtype="float32"),
                        ShapeSpec("serve", 64, 3, "decode"), device="cpu")
    params = prepack_params(model.init(torch.Generator().manual_seed(0)), model.ctx)
    calls = {"unpack": 0, "unpacked": 0}
    unpack, kernel = packing.unpack, core_mmt4d.mmt4d_kernel

    def counting_unpack(*a, **kw):
        calls["unpack"] += 1
        return unpack(*a, **kw)

    def counting_mmt4d(*a, unpack_to=None, **kw):
        calls["unpacked"] += unpack_to is not None
        return kernel(*a, unpack_to=unpack_to, **kw)

    monkeypatch.setattr(packing, "unpack", counting_unpack)
    monkeypatch.setattr(core_mmt4d, "mmt4d_kernel", counting_mmt4d)
    pages, t, w = 14, 8, 16
    caches = model.init_paged_cache(pages, t, 3)
    bt = torch.arange(1, 13, dtype=torch.int32).reshape(3, 4)
    row_ids = torch.full((w,), -1, dtype=torch.int32)
    q_pos = torch.zeros(w, dtype=torch.int32)
    row_ids[:6], q_pos[:6] = torch.tensor([0, 1, 1, 1, 2, 2]), torch.tensor([5, 0, 1, 2, 9, 10])
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (1, w)))
    logits, _ = model.flat_decode_step(
        params, caches, tokens, block_tables=bt, row_ids=row_ids, q_pos=q_pos,
        logits_idx=torch.tensor([0, 3, 5]))
    assert torch.isfinite(logits).all()
    assert calls == {"unpack": 1, "unpacked": 3 * cfg.n_layers + 1}
