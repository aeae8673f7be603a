"""Gradients of the packed pipeline against the JAX package, on the CPU.

The port's autograd Functions (``core/mmt4d.py``: mmt4d with its dgrad and
wgrad kernels; ``core/packing.py``: pack and unpack as each other's
transposes; ``models/common.py``: the embedding gather) take their plain
versions here, and are held to ``jax.vjp`` of the JAX package's jnp
functions in float32 on ``presets["tpu_v5e"]``, with M and K off the
tiles.  Tolerance: max |port - JAX| <= 1e-5 of the largest |JAX| value
(float32 sums in another order).  Each Function also passes a float64
``gradcheck`` on tiny shapes, and the plain dgrad/wgrad agree with a
Python mirror of the CUDA kernel's address arithmetic
(``gemm_operands``/``gemm_view``); the bfloat16 kernel's TMA boxes, its
store and its split of the reduction (``grad_tma``, ``grad_store_offset``,
``pick_grad_split``) are held to the same mirror.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as jpacking
from repro.core import presets
from repro.core.layout import make_layout as jmake_layout
from repro.core.linear import MatmulContext as JCtx
from repro.core.linear import linear_apply as jlinear_apply
from repro.core.mmt4d import Epilogue as JEpilogue
from repro.core.mmt4d import mmt4d as jmmt4d
from repro.core.propagation import PackedArray as JPacked
from repro_torch.core import packing
from repro_torch.core.hardware import presets as tpresets
from repro_torch.core.layout import make_layout
from repro_torch.core.linear import MatmulContext, linear_apply
from repro_torch.core.mmt4d import Epilogue, mmt4d
from repro_torch.core.propagation import PackedArray
from repro_torch.core.hardware import HardwareSpec
from repro_torch.kernels.mmt4d.ops import (GRAD_MIN_CHUNKS, GRAD_TILE, MAX_CLUSTER,
                                           gemm_operands, grad_store_offset,
                                           grad_tiles_ok, grad_tma,
                                           mmt4d_dgrad, mmt4d_wgrad, pick_grad_split)
from repro_torch.kernels.mmt4d.ref import ACTIVATION_GRADS, ACTIVATIONS
from repro_torch.models.common import embed_apply

torch.set_num_threads(1)

ACTS = [None, "gelu", "silu", "relu", "tanh"]
JAX_ACT = {None: None, "gelu": jax.nn.gelu, "silu": jax.nn.silu,
           "relu": jax.nn.relu, "tanh": jnp.tanh}
M, K, N = 13, 100, 70          # off every tile: m_r 8, k_r = n_r 128
REL = 1e-5                     # float32 sums in another order


def _arr(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a)).requires_grad_(True)


def _close(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= REL * max(1.0, np.abs(want).max())


LAYOUT = make_layout("scalable", tpresets["tpu_v5e"], torch.float32)
JLAYOUT = jmake_layout("scalable", presets["tpu_v5e"], jnp.float32)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_mmt4d_grads_match_jax(act, bias):
    """mmt4d with the bias and activation epilogue: gradients of A_pack,
    B_pack and the bias against jax.vjp of the jnp mmt4d + Epilogue (the
    JAX package casts before the epilogue; in float32 the orders agree)."""
    a = jpacking.pack_lhs(jnp.asarray(_arr((2, M, K), 1)), JLAYOUT)
    b = jpacking.pack_rhs(jnp.asarray(_arr((K, N), 2, 0.1)), JLAYOUT)
    bv = jnp.asarray(_arr((N,), 3))
    epi = JEpilogue(activation=JAX_ACT[act], has_bias=bias)
    f = lambda a_, b_, bv_: epi.apply_packed(jmmt4d(a_, b_), JLAYOUT, bv_ if bias else None)
    out, vjp = jax.vjp(f, a, b, bv)
    ct = _arr(out.shape, 4)
    ja, jb, jbv = vjp(jnp.asarray(ct))

    ta, tb, tbv = _t(a), _t(b), _t(bv)
    bp = Epilogue().bias_pack(tbv, LAYOUT) if bias else None
    y = mmt4d(ta, tb, bp, activation=act)
    _close(y, out)
    y.backward(torch.from_numpy(ct))
    _close(ta.grad, ja)
    _close(tb.grad, jb)
    if bias:
        _close(tbv.grad, jbv)


@pytest.mark.parametrize("fn", ["pack_lhs", "pack_rhs", "pack_out", "unpack_out"])
def test_pack_unpack_grads_match_jax(fn):
    """The gradient of a pack is the unpack of the incoming gradient, and
    the gradient of an unpack its zero-padded pack."""
    if fn == "unpack_out":
        x = jpacking.pack_out(jnp.asarray(_arr((2, M, N), 5)), JLAYOUT)
        jf = lambda x_: jpacking.unpack_out(x_, M, N)
        tf = lambda x_: packing.unpack_out(x_, M, N)
    else:
        x = jnp.asarray(_arr((2, M, K), 5))
        jf = lambda x_: getattr(jpacking, fn)(x_, JLAYOUT)
        tf = lambda x_: getattr(packing, fn)(x_, LAYOUT)
    out, vjp = jax.vjp(jf, x)
    ct = _arr(out.shape, 6)
    (jg,) = vjp(jnp.asarray(ct))
    tx = _t(x)
    y = tf(tx)
    assert np.array_equal(y.detach().numpy(), np.asarray(out))
    y.backward(torch.from_numpy(ct))
    assert np.array_equal(tx.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("chain", ["plain", "keep_packed"])
@pytest.mark.parametrize("act", [None, "silu", "gelu"])
def test_linear_apply_grads_match_jax(chain, act):
    """``linear_apply`` on unpacked weights (packed every call, so the
    gradient reaches ``w``), M and K off the tiles.  ``keep_packed``: two
    linears chained in the packed domain, gate-style (activation fused in
    the first), through a PackedArray, unpacked at the end; padding rows
    and columns get no gradient that leaks into dW or dx."""
    p1 = {"w": _arr((K, N), 7, K ** -0.5), "b": _arr((N,), 8)}
    p2 = {"w": _arr((N, 40), 9, N ** -0.5)}
    x = _arr((2, M, K), 10)
    jctx, ctx = JCtx(hw=presets["tpu_v5e"]), MatmulContext(hw=tpresets["tpu_v5e"])

    def jf(x_, p1_, p2_):
        if chain == "plain":
            return jlinear_apply(p1_, x_, jctx, activation=JAX_ACT[act])
        h = jlinear_apply(p1_, x_, jctx, activation=JAX_ACT[act], keep_packed=True)
        assert isinstance(h, JPacked)
        return jlinear_apply(p2_, h, jctx, keep_packed=True).unpack()

    def tf(x_, p1_, p2_):
        if chain == "plain":
            return linear_apply(p1_, x_, ctx, activation=act)
        h = linear_apply(p1_, x_, ctx, activation=act, keep_packed=True)
        assert isinstance(h, PackedArray)
        return linear_apply(p2_, h, ctx, keep_packed=True).unpack()

    jp = lambda p: {k: jnp.asarray(v) for k, v in p.items()}
    out, vjp = jax.vjp(jf, jnp.asarray(x), jp(p1), jp(p2))
    ct = _arr(out.shape, 11)
    jx, jp1, jp2 = vjp(jnp.asarray(ct))
    tx = _t(x)
    tp1, tp2 = ({k: _t(v) for k, v in p.items()} for p in (p1, p2))
    y = tf(tx, tp1, tp2)
    _close(y, out)
    y.backward(torch.from_numpy(ct))
    _close(tx.grad, jx)
    pairs = [(tp1, jp1)] + ([(tp2, jp2)] if chain != "plain" else [])
    for tp, jpp in pairs:
        for k in tp:
            _close(tp[k].grad, jpp[k])


# ---------------------------------------------------------------- gradcheck

F64 = dict(dtype=torch.float64)


def _rand64(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g, **F64).requires_grad_(True)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("unpack_to", [None, (6, 10)], ids=["packed", "unpacked"])
def test_mmt4d_function_gradcheck(act, unpack_to):
    """mmt4d's Function (a, b and the bias; packed and unpacked store) on
    tiny float64 tiles m_r = 4, n_r = 4, k_r = 8."""
    a, b, bias = _rand64(2, 2, 4, 8, seed=1), _rand64(3, 2, 4, 8, seed=2), \
        _rand64(3, 4, seed=3)
    f = lambda a_, b_, c_: mmt4d(a_, b_, c_, activation=act, unpack_to=unpack_to)
    assert torch.autograd.gradcheck(f, (a, b, bias))


@pytest.mark.parametrize("fn", ["pack", "unpack"])
def test_pack_unpack_function_gradcheck(fn):
    lay = make_layout("fixed", tpresets["tpu_v5e"], torch.float64)
    lay = type(lay)(**{**lay.__dict__, "m_r": 4, "k_r": 8, "n_r": 8})
    if fn == "pack":
        x = _rand64(2, 5, 11, seed=4)
        assert torch.autograd.gradcheck(lambda x_: packing.pack_lhs(x_, lay), (x,))
        w = _rand64(11, 5, seed=5)
        assert torch.autograd.gradcheck(lambda w_: packing.pack_rhs(w_, lay), (w,))
    else:
        xp = _rand64(2, 2, 2, 4, 8, seed=6)
        assert torch.autograd.gradcheck(lambda x_: packing.unpack_lhs(x_, 5, 11), (xp,))


def test_gather_function_gradcheck():
    """The embedding gather's deterministic gradient (repeated tokens sum)."""
    e = _rand64(10, 4, seed=7)
    tokens = torch.tensor([[1, 3, 3], [9, 1, 0]])
    assert torch.autograd.gradcheck(lambda e_: embed_apply({"e": e_}, tokens), (e,))


# ------------------------------------------- the kernels' address arithmetic

def gemm_view(buf: torch.Tensor, desc: tuple, rows: int, cols: int) -> torch.Tensor:
    """The logical [rows, cols] matrix ``desc`` reads from ``buf``: a
    Python mirror of the gradient kernels' address arithmetic."""
    rs, ti, ii, cs, tj, ij = desc
    i, j = torch.arange(rows), torch.arange(cols)
    off = ((i // ti) * rs + (i % ti) * ii)[:, None] + ((j // tj) * cs + (j % tj) * ij)[None, :]
    return buf.reshape(-1)[off]


def tma_box(buf: torch.Tensor, tensor_map: tuple, origin: tuple) -> torch.Tensor:
    """A Python mirror of one TMA box load: the elements of the box at
    ``origin`` (dims innermost first, strides in elements for dims 1 and
    up), zero where the box leaves the tensor, as [rows, box[0]] in the
    order the copy lays them down."""
    dims, strides, box = tensor_map
    idx = torch.meshgrid(*[torch.arange(b) + o for b, o in zip(box[::-1], origin[::-1])],
                         indexing="ij")[::-1]
    ok = torch.ones(idx[0].shape, dtype=torch.bool)
    for i, d in zip(idx, dims):
        ok &= (i >= 0) & (i < d)
    off = idx[0] + sum(i * s for i, s in zip(idx[1:], strides))
    vals = buf.reshape(-1)[torch.where(ok, off, 0)]
    return torch.where(ok, vals, torch.zeros((), dtype=buf.dtype)).reshape(-1, box[0])


def _padded(m: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    out = torch.zeros(rows, cols, dtype=m.dtype)
    out[:m.shape[0], :m.shape[1]] = m
    return out


def _check_tma_mirror(kind, shape, x_src, y):
    """Every box the bfloat16 kernel loads (each block, each chunk) holds
    the elements ``gemm_view`` names for it, zero beyond P, Q or R; its
    store puts C[p, q] where C's descriptor says."""
    bp, bq, bk = GRAD_TILE
    p, q, r, (dx, dy, dc), _ = gemm_operands(kind, *shape)
    maps, loads = grad_tma(kind, *shape)
    pp, qq, rr = -(-p // bp) * bp, -(-q // bq) * bq, -(-r // bk) * bk
    xv = _padded(gemm_view(x_src, dx, p, r), pp, rr)
    yv = _padded(gemm_view(y, dy, r, q), rr, qq)
    src = {"x": x_src, "y": y}
    for p0 in range(0, p, bp):
        for q0 in range(0, q, bq):
            for r0 in range(0, r, bk):
                for op, origin in loads(p0, q0, r0):
                    got = tma_box(src[op], maps[op], origin)
                    if op == "x" and kind == "dgrad":     # K-major, [p][r]
                        assert torch.equal(got, xv[p0:p0 + bp, r0:r0 + bk])
                        continue
                    # MN-major pieces [piece][r][64 of p or q]
                    for h, piece in enumerate(got.reshape(-1, bk, 64)):
                        if op == "x":
                            want = xv[p0 + 64 * h:p0 + 64 * h + 64, r0:r0 + bk].T
                        else:
                            want = yv[r0:r0 + bk, q0 + 64 * h:q0 + 64 * h + 64]
                        assert torch.equal(piece, want), (kind, op, h, p0, q0, r0)
    p_t, q_t = dc[1], dc[4]
    i, j = torch.arange(p)[:, None], torch.arange(q)[None, :]
    want = (i // dc[1]) * dc[0] + (i % dc[1]) * dc[2] + (j // dc[4]) * dc[3] + (j % dc[4]) * dc[5]
    assert torch.equal(grad_store_offset(i, j, p_t, q_t, q // q_t), want)


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape", [(3, 2, 2, 8, 16, 16), (5, 3, 2, 8, 128, 128),
                                   (3, 3, 3, 16, 64, 128), (9, 2, 2, 32, 128, 64)])
def test_grad_products_match_kernel_index_mirror(shape, act):
    """dgrad and wgrad (plain versions) equal the product the CUDA kernel
    forms from its operand descriptors: C[p, q] = sum_r X(p, r) Y(r, q),
    each matrix read through ``gemm_view``; the bias gradient is X's row
    sums, and with an activation X is dY * act'(Z).  Where the bfloat16
    kernel takes the tiles, its TMA boxes and its store are held to the
    same views (M ragged against the 256-row block: P = 40, 48, 288; N
    ragged in wgrad's p at n_r = 64: 64-wide pieces past P).  Each block
    loads one box per operand and chunk."""
    m_o, n_o, k_o, m_r, n_r, k_r = shape
    g = torch.Generator().manual_seed(sum(shape))
    dz = torch.randn(m_o, n_o, m_r, n_r, generator=g, dtype=torch.float64)
    z = torch.randn(m_o, n_o, m_r, n_r, generator=g, dtype=torch.float64) \
        if act else None
    a = torch.randn(m_o, k_o, m_r, k_r, generator=g, dtype=torch.float64)
    b = torch.randn(n_o, k_o, n_r, k_r, generator=g, dtype=torch.float64)
    x_src = dz if act is None else dz * ACTIVATION_GRADS[act](z)
    got = {"dgrad": mmt4d_dgrad(dz, b, z, activation=act)}
    got["wgrad"], dbias = mmt4d_wgrad(dz, a, z, activation=act, bias=True)
    for kind, y in (("dgrad", b), ("wgrad", a)):
        p, q, r, (dx, dy, dc), _ = gemm_operands(kind, *shape)
        x = gemm_view(x_src, dx, p, r)
        assert torch.allclose(gemm_view(got[kind], dc, p, q),
                              x @ gemm_view(y, dy, r, q), rtol=1e-12, atol=1e-12)
        if kind == "wgrad":
            assert torch.allclose(dbias.reshape(-1), x.sum(1), rtol=1e-12, atol=1e-12)
        if grad_tiles_ok(*shape[3:]):
            _check_tma_mirror(kind, shape, x_src, y)


# shapes of the bfloat16 kernel's products: (P, Q, R) of a 4,096-token
# SmolLM2 linear (m_r 16, n_r = k_r = 128), dgrad and wgrad
def _products(k, n, tokens=4096):
    kp, np_ = -(-k // 128) * 128, -(-n // 128) * 128
    return {"dgrad": (tokens, kp, np_), "wgrad": (np_, kp, tokens)}


TRAIN_LINEARS = {"gate": (576, 1536), "down": (1536, 576), "tied head": (576, 49152),
                 "k proj": (576, 192), "q proj": (576, 576)}


@pytest.mark.parametrize("linear", sorted(TRAIN_LINEARS))
@pytest.mark.parametrize("tokens", [512, 4096, 16384])
def test_grad_split_ranges_cover_the_reduction(linear, tokens):
    """The kernel's split of each product (block z of a cluster of s takes
    chunks [z n // s, (z + 1) n // s)): contiguous ascending ranges that
    cover the reduction exactly, none empty nor, split, shorter than
    GRAD_MIN_CHUNKS, at most MAX_CLUSTER blocks to a cluster, and no more
    blocks than one wave where the tiles leave room for a split."""
    sms = HardwareSpec(name="h100", sm_count=132).sm_count
    for kind, (p, q, r) in _products(*TRAIN_LINEARS[linear], tokens).items():
        s = pick_grad_split(p, q, r, sms)
        n = -(-r // GRAD_TILE[2])
        assert 1 <= s <= MAX_CLUSTER
        ranges = [range(z * n // s, (z + 1) * n // s) for z in range(s)]   # c_lo, c_hi
        assert all(len(rg) >= (GRAD_MIN_CHUNKS if s > 1 else 1) for rg in ranges)
        assert [c for rg in ranges for c in rg] == list(range(n))
        tiles = -(-p // GRAD_TILE[0]) * -(-q // GRAD_TILE[1])
        assert s == 1 or tiles * s <= sms


def test_grad_split_at_the_training_linears():
    """At 4,096 tokens on 132 SMs: wgrad's outputs at every layer linear
    (5-36 tiles of 256 x 128) cannot fill the SMs, so their 64-chunk
    reduction is split as far as one wave of blocks allows (the gate's 30
    tiles 4 ways, down's 36 3 ways, the Q and K projections' 15 and 5 the
    8 of a portable cluster); every dgrad (80-192 tiles, the tied head's
    included) and the tied head's wgrad (960 tiles) keep their reduction
    whole: a second wave of blocks buys nothing where L2 sets the pace."""
    got = {(lin, kind): pick_grad_split(*pqr, 132)
           for lin, kn in TRAIN_LINEARS.items()
           for kind, pqr in _products(*kn).items()}
    assert got == {("gate", "dgrad"): 1, ("gate", "wgrad"): 4,
                   ("down", "dgrad"): 1, ("down", "wgrad"): 3,
                   ("tied head", "dgrad"): 1, ("tied head", "wgrad"): 1,
                   ("k proj", "dgrad"): 1, ("k proj", "wgrad"): 8,
                   ("q proj", "dgrad"): 1, ("q proj", "wgrad"): 8}


@pytest.mark.parametrize("preset", ["tpu_v5e", "h100"])
@pytest.mark.parametrize("policy", ["scalable", "fixed"])
def test_grad_kernel_takes_every_preset_bf16_tile(preset, policy):
    """The bfloat16 gradient kernel takes the tiles each hardware
    preset's layouts give bfloat16 (the h100 descriptor keeps the
    reference's lanes, sublanes and MXU depth)."""
    hw = tpresets["tpu_v5e"] if preset == "tpu_v5e" else HardwareSpec(name="h100", sm_count=132)
    lay = make_layout(policy, hw, torch.bfloat16)
    assert grad_tiles_ok(lay.m_r, lay.n_r, lay.k_r), (lay.m_r, lay.n_r, lay.k_r)
    assert not grad_tiles_ok(24, 128, 128) and not grad_tiles_ok(16, 96, 128)
    assert not grad_tiles_ok(16, 192, 128)


@pytest.mark.parametrize("symbol,name", [
    ("void (anonymous namespace)::packed_gemm_wgmma_kernel<false, false>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, __nv_bfloat16*, __nv_bfloat16*, (anonymous "
     "namespace)::Geom, int)", "mmt4d_dgrad"),
    ("void (anonymous namespace)::packed_gemm_wgmma_kernel<true, false>(CUtensorMap_st, "
     "CUtensorMap_st", "mmt4d_wgrad"),
    ("void (anonymous namespace)::packed_gemm_wgmma_kernel<true, true>(CUtensorMap_st",
     "mmt4d_wgrad"),
    ("void (anonymous namespace)::packed_gemm_wgmma_kernel<false, false, true>("
     "CUtensorMap_st", "mmt4d_dgrad"),
    ("void (anonymous namespace)::packed_gemm_wgmma_kernel<true, false, true>("
     "CUtensorMap_st", "mmt4d_wgrad"),
    ("void (anonymous namespace)::packed_gemm_kernel<false>(float const*, float const*",
     "mmt4d_dgrad"),
    ("void (anonymous namespace)::packed_gemm_kernel<true>(float const*", "mmt4d_wgrad"),
    ("void (anonymous namespace)::mmt4d_bf16_kernel<4, true>(__nv_bfloat16 const*", "mmt4d"),
    ("void (anonymous namespace)::wkv6_kernel<64>(float const*, float const*", "wkv6"),
    ("void (anonymous namespace)::wkv6_decode_kernel<64>(float const*", "wkv6"),
    ("void (anonymous namespace)::selective_scan_kernel<__nv_bfloat16, 16>(float "
     "const*", "selective_scan"),
    ("void (anonymous namespace)::wkv6_bwd_kernel<64>(float const*, float const*",
     "wkv6_bwd"),
    ("void (anonymous namespace)::wkv6_bwd_sum_kernel(repro::SumJob)", "wkv6_bwd_sum"),
    ("void (anonymous namespace)::selective_scan_bwd_kernel<__nv_bfloat16, 16>(float "
     "const*", "selective_scan_bwd"),
    ("void (anonymous namespace)::selective_scan_bwd_kernel<float, 8>(float const*",
     "selective_scan_bwd"),
    ("void (anonymous namespace)::selective_scan_bwd_sum_kernel(repro::SumJob, "
     "repro::SumJob", "selective_scan_bwd_sum"),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8", "pytorch")])
def test_profiles_name_the_gradient_kernels(symbol, name):
    """The launchers' ``--profile`` sums device time per port kernel by
    symbol: each gradient kernel (bf16 with and without the bias gradient,
    f32), both of wkv6's and the recurrences' backward kernels land on
    their wrappers' names, as the kernel line counts them; the backward
    wrappers' second kernels (the sums of their partials) on names of
    their own, which the launch counts leave out."""
    from repro_torch.launch.serve import port_kernel
    assert port_kernel(symbol) == name


def test_activation_grads_are_the_derivatives():
    z = torch.linspace(-4, 4, 101, dtype=torch.float64).requires_grad_(True)
    for name, grad in ACTIVATION_GRADS.items():
        (d,) = torch.autograd.grad(ACTIVATIONS[name](z).sum(), z)
        assert torch.allclose(grad(z.detach()), d, rtol=1e-10, atol=1e-12), name


@pytest.mark.parametrize("kind", ["dgrad", "wgrad"])
def test_expert_tma_boxes_read_their_expert(kind):
    """The expert-batched bfloat16 kernel's boxes (``grad_tma(...,
    experts=E)``: each map's outer tile dimension folds the experts in)
    hold each expert's own operands: every row a block uses equals its
    expert's view.  Rows past the expert's edge come from the next expert
    (or are zero past the last): dgrad's past P are never stored, and
    wgrad's past R in the last chunk (M_o m_r = 48 here, not a multiple
    of the 64-deep chunk) the kernel zeroes in X before its MMAs."""
    e, shape = 3, (3, 2, 2, 16, 64, 64)
    m_o, n_o, k_o, m_r, n_r, k_r = shape
    bp, bq, bk = GRAD_TILE
    g = torch.Generator().manual_seed(5)
    dz = torch.randn(e, m_o, n_o, m_r, n_r, generator=g, dtype=torch.float64)
    a = torch.randn(e, m_o, k_o, m_r, k_r, generator=g, dtype=torch.float64)
    b = torch.randn(e, n_o, k_o, n_r, k_r, generator=g, dtype=torch.float64)
    y = b if kind == "dgrad" else a
    p, q, r, (dx, dy, _), _ = gemm_operands(kind, *shape)
    maps, loads = grad_tma(kind, *shape, experts=e)
    pp, qq, rr = -(-p // bp) * bp, -(-q // bq) * bq, -(-r // bk) * bk
    for ex in range(e):
        xv = _padded(gemm_view(dz[ex], dx, p, r), pp, rr)
        yv = _padded(gemm_view(y[ex], dy, r, q), rr, qq)
        for p0 in range(0, p, bp):
            for q0 in range(0, q, bq):
                for r0 in range(0, r, bk):
                    rows = min(bk, r - r0)            # this expert's rows of r
                    for op, origin in loads(p0, q0, r0, ex):
                        got = tma_box({"x": dz, "y": y}[op], maps[op], origin)
                        if op == "x" and kind == "dgrad":     # [p][r], p < P stored
                            keep = min(bp, p - p0)
                            assert torch.equal(got[:keep], xv[p0:p0 + keep, r0:r0 + bk])
                            continue
                        for h, piece in enumerate(got.reshape(-1, bk, 64)):
                            want = (xv[p0 + 64 * h:p0 + 64 * h + 64, r0:r0 + bk].T
                                    if op == "x" else
                                    yv[r0:r0 + bk, q0 + 64 * h:q0 + 64 * h + 64])
                            assert torch.equal(piece[:rows], want[:rows]), (kind, op, ex)
