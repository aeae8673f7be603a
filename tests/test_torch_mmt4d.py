"""Port mmt4d and linear_apply vs the JAX package.

- ``mmt4d`` (plain version on the CPU) against the Pallas mmt4d kernel in
  interpret mode and against its jnp oracle, with every epilogue.
  Tolerances: float32 rtol 1e-5 (sums in another order); bfloat16 2e-2
  (one rounding of the output, both sides accumulate in float32).
- ``linear_apply`` with and without ``keep_packed`` against the JAX
  ``linear_apply``.  The port fuses bias and activation into mmt4d before
  its cast, the JAX model path applies them after the cast: equal up to
  float32 rounding in float32, one bf16 ulp apart in bfloat16 (atol 2e-2
  at these magnitudes).
- ``prepack_params``: the same keys and shapes as the JAX package's.
- ``pick_split``: the bfloat16 kernel's decomposition of every SmolLM2
  linear at every flat width on an H100 (132 SMs), checked through
  ``Split.work``, which mirrors the kernel's index arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_layout, packing as jpacking, presets
from repro.core.linear import MatmulContext as JCtx
from repro.core.linear import linear_apply as jlinear_apply
from repro.core.linear import prepack_params as jprepack
from repro.kernels.mmt4d.ops import mmt4d as jmmt4d_op
from repro.kernels.mmt4d.ref import mmt4d_ref as jmmt4d_ref
from repro_torch.core import packing
from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.hardware import presets as tpresets
from repro_torch.core.layout import make_layout as tmake_layout
from repro_torch.core.linear import MatmulContext, linear_apply, prepack_params
from repro_torch.core.mmt4d import mmt4d
from repro_torch.core.propagation import PackedArray, pack_activation
from repro_torch.kernels.mmt4d.ops import (CHUNKS_IN_FLIGHT, MAX_CLUSTER, MAX_COLS,
                                          WARPS, pick_split)
from repro_torch.weights import from_jax_params

torch.set_num_threads(1)

ACTS = [None, "gelu", "silu", "relu", "tanh"]
DTYPES = [("float32", torch.float32, jnp.float32, 1e-5),
          ("bfloat16", torch.bfloat16, jnp.bfloat16, 2e-2)]


def _arr(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("name,tdt,jdt,tol", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("act", ACTS, ids=[str(a) for a in ACTS])
def test_mmt4d_matches_pallas_and_ref(act, name, tdt, jdt, tol):
    m, k, n = 40, 200, 136
    lay = make_layout("scalable", presets["tpu_v5e"], jdt)
    tlay = tmake_layout("scalable", tpresets["tpu_v5e"], tdt)
    a, b, bias = _arr((m, k), 0), _arr((k, n), 1), _arr((1, n), 2)
    ja = jpacking.pack_lhs(jnp.asarray(a).astype(jdt), lay)
    jb = jpacking.pack_rhs(jnp.asarray(b).astype(jdt), lay)
    jbias = jpacking.pad_to_tiles(jnp.asarray(bias).astype(jdt), 1,
                                  lay.n_r).reshape(-1, lay.n_r)
    ta = packing.pack_lhs(torch.from_numpy(a).to(tdt), tlay)
    tb = packing.pack_rhs(torch.from_numpy(b).to(tdt), tlay)
    tbias = torch.tensor(_f32(jbias)).to(tdt)
    got = _f32(mmt4d(ta, tb, tbias, activation=act))
    kern = _f32(jmmt4d_op(ja, jb, jbias, activation=act, interpret=True))
    ref = _f32(jmmt4d_ref(ja, jb, jbias, activation=act))
    np.testing.assert_allclose(got, kern, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_mmt4d_folds_leading_dims():
    """[1, W] stream: the leading dim folds into M_o and comes back."""
    tlay = tmake_layout("scalable", tpresets["tpu_v5e"], torch.float32)
    x = torch.from_numpy(_arr((1, 20, 64), 3))
    w = torch.from_numpy(_arr((64, 48), 4))
    cp = mmt4d(packing.pack_lhs(x, tlay), packing.pack_rhs(w, tlay))
    assert cp.shape == (1, 3, 1, 8, 128)
    np.testing.assert_allclose(packing.unpack_out(cp, 20, 48).numpy(),
                               (x @ w).numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name,tdt,jdt,tol", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("keep_packed", [False, True])
def test_linear_apply_matches_jax(keep_packed, name, tdt, jdt, tol):
    jctx = JCtx(hw=presets["tpu_v5e"])
    ctx = MatmulContext(hw=tpresets["tpu_v5e"])
    p = {"w": _arr((64, 160), 5), "b": _arr((160,), 6)}
    jp = {k: jnp.asarray(v).astype(jdt) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(tdt) for k, v in p.items()}
    x = _arr((2, 11, 64), 7)
    jy = jlinear_apply(jp, jnp.asarray(x).astype(jdt), jctx,
                       activation=jax.nn.silu, keep_packed=keep_packed)
    ty = linear_apply(tp, torch.from_numpy(x).to(tdt), ctx, activation="silu",
                      keep_packed=keep_packed)
    if keep_packed:
        assert isinstance(ty, PackedArray)
        assert (ty.m, ty.k, tuple(ty.data.shape)) == (jy.m, jy.k, jy.data.shape)
        jy, ty = jy.data, ty.data
    np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=tol, atol=tol)
    # a packed input gives exactly the result of the plain one
    xp = pack_activation(torch.from_numpy(x).to(tdt), ctx.layout(tdt))
    ty2 = linear_apply(tp, xp, ctx, activation="silu", keep_packed=keep_packed)
    assert torch.equal(ty2.data if keep_packed else ty2, ty)


def test_prepack_params_keys_and_shapes():
    jctx = JCtx(hw=presets["tpu_v5e"])
    ctx = MatmulContext(hw=tpresets["tpu_v5e"])
    tree = {"a": {"w": _arr((64, 160), 8)},
            "b": {"w": _arr((200, 72), 9), "b": _arr((72,), 10)},
            "ln": {"g": _arr((64,), 11)}}
    jt = jprepack(jax.tree.map(jnp.asarray, tree), jctx)
    tt = prepack_params(from_jax_params(tree), ctx)
    for name in tree:
        assert sorted(tt[name]) == sorted(jt[name]), name
        for key, v in jt[name].items():
            if key == "w_n":
                assert tt[name][key] == v.shape[0]
            else:
                assert tuple(tt[name][key].shape) == v.shape, (name, key)
                np.testing.assert_array_equal(_f32(tt[name][key]), _f32(v))
    # prepacked weights give the same linear as packing on the fly
    x = torch.from_numpy(_arr((5, 200), 12))
    assert torch.equal(linear_apply(tt["b"], x, ctx),
                       linear_apply(from_jax_params(tree["b"]), x, ctx))


# SmolLM2-135M's linears as (K, N)
SMOLLM_LINEARS = {"gate/up": (576, 1536), "q/o": (576, 576), "k/v": (576, 192),
                  "down": (1536, 576), "tied head": (576, 49152)}


@pytest.mark.parametrize("width", [16, 32, 64, 128, 256, 512])
@pytest.mark.parametrize("linear", list(SMOLLM_LINEARS))
def test_pick_split_covers_every_output_once(linear, width):
    hw = HardwareSpec(name="h100", sm_count=132)
    k, n = SMOLLM_LINEARS[linear]
    for policy, kernel in [("fixed", "mxu_outer_product"),
                           ("scalable", "mxu_outer_product"),
                           ("scalable", "mxu_outer_product_2x")]:
        lay = tmake_layout(policy, hw, torch.bfloat16, kernel=kernel)
        m_o, n_o, k_o = -(-width // lay.m_r), -(-n // lay.n_r), -(-k // lay.k_r)
        s = pick_split(m_o, n_o, k_o, lay.m_r, lay.n_r, lay.k_r, hw.sm_count)
        where = (policy, kernel, s)
        assert 1 <= s.cluster <= MAX_CLUSTER and s.cluster == s.splits <= k_o, where
        assert s.tm * lay.m_r <= MAX_COLS and lay.n_r % s.rows == 0, where
        # the splits cut [0, K_o) into consecutive ranges, none empty
        ranges = [s.work(0, 0, z, m_o, k_o, lay.n_r)[3] for z in range(s.splits)]
        assert all(len(r) > 0 for r in ranges), where
        assert [i for r in ranges for i in r] == list(range(k_o)), where
        # for each split, the grid's blocks cover each output element once
        for z in range(s.splits):
            hits = np.zeros((m_o, n_o, lay.n_r), np.int32)
            for x in range(s.grid[0]):
                for y in range(s.grid[1]):
                    mos, no, rows, _ = s.work(x, y, z, m_o, k_o, lay.n_r)
                    assert len(mos) > 0, where
                    hits[mos.start:mos.stop, no, rows.start:rows.stop] += 1
            assert (hits == 1).all(), where
        if s.grid[0] * s.grid[1] < hw.sm_count:
            # too few output slices to fill the SMs (a decode linear): the
            # most blocks without a split, K split in a cluster only until
            # no warp walks more than CHUNKS_IN_FLIGHT chunks
            assert s.rows == 16 and s.tm == 1, where
            per_warp = -(-k_o * (lay.k_r // 32) // s.splits) / (WARPS // (s.rows // 16))
            assert per_warp <= CHUNKS_IN_FLIGHT or s.splits == min(MAX_CLUSTER, k_o), where
            if s.splits > 1:
                assert -(-k_o * (lay.k_r // 32) // (s.splits - 1)) / WARPS > CHUNKS_IN_FLIGHT, where
        else:
            assert s.splits == 1, where
