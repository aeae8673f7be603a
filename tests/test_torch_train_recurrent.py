"""Training the recurrent families in the port against the JAX package, on
the CPU in float32 (bfloat16 where a case says so):

- (a) C10: ``selective_scan_ref`` differentiable under autograd (it once
  wrote its final state into the tensor autograd had saved), its
  serving contract kept (the state overwritten in place without
  autograd);
- (b) ``wkv6_bwd_ref`` against ``jax.vjp`` of the reference's
  ``_wkv_scan`` and against autograd through ``wkv6_ref``, at lengths 1,
  15, 16, 17, 35 and 256 (chunk edges of the 16-token checkpoints and
  the reference's 128-token ones), ordinary and extreme decays (1e-30,
  1 - 1e-7), from a zero and a nonzero state; and the backward kernel's
  decomposition (``wkv6_bwd_sliced_ref``) at ragged lengths, a decay of
  1e-30 and a nonzero state, two row slices;
- (c) ``selective_scan_bwd_ref`` against ``jax.vjp`` of the reference's
  mamba body (``src/repro/models/mamba.py:114-132``, expression for
  expression, around its ``_ssm_scan``), f32 and bf16, N 8 and 16, from
  zero and from h0; the port's autograd Function (the wrappers' CPU path)
  equal to the plain backward bit for bit; the backward kernel's
  decomposition (``selective_scan_bwd_windowed_ref``) over 40 steps of 300
  channels from h0;
- (d) and (e), the models, are in ``test_torch_train_recurrent_models.py``
  (the two files split the run's time).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro.models import rwkv6 as jrwkv6
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import (
    selective_scan_bwd_ref, selective_scan_bwd_windowed_ref, selective_scan_ref)
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import (wkv6_bwd_ref, wkv6_bwd_sliced_ref,
                                          wkv6_ref)

torch.set_num_threads(1)

def _rel_close(got, want, rel):
    """Every entry within ``rel`` of ``want``'s largest |entry|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(1e-30, np.abs(want).max())


# ------------------------------------------------------------------- (a) C10

def _scan_inputs(rng, b, s, di, n, dtype, h0=True):
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    delta = np.log1p(np.exp(f(b, s, di) - 2)).astype(np.float32)   # softplus
    x, z = f(b, s, di), f(b, s, di)
    bm, cm = f(b, s, n), f(b, s, n)
    if dtype == "bfloat16":      # values a bf16 tensor holds, in both packages
        x, z, bm, cm = (np.asarray(jnp.asarray(t, jnp.bfloat16).astype(jnp.float32))
                        for t in (x, z, bm, cm))
    a_log = np.log(np.arange(1, n + 1, dtype=np.float32))[None].repeat(di, 0) \
        + 0.1 * f(di, n)
    d_skip = 1 + 0.1 * f(di)
    state = f(b, di, n) if h0 else np.zeros((b, di, n), np.float32)
    dout = f(b, s, di)
    return [delta, x, z, bm, cm, a_log, d_skip, state], dout


def _torch(arrays, dtype):
    out = [torch.tensor(a) for a in arrays]
    if dtype == "bfloat16":
        for i in (1, 2, 3, 4):
            out[i] = out[i].to(torch.bfloat16)
    return out


def test_c10_selective_scan_ref_differentiable():
    """Under autograd the plain version runs from a copy of the state and
    leaves ``state`` unwritten (the parent wrote it in place, and autograd
    raised on backward); without autograd it overwrites it in place."""
    arrays, dout = _scan_inputs(np.random.default_rng(0), 2, 9, 6, 8, "float32")
    ops = _torch(arrays, "float32")
    ts = [t.clone().requires_grad_(i < 7) for i, t in enumerate(ops)]
    h0 = ts[7].clone()
    y = selective_scan_ref(*ts)
    grads = torch.autograd.grad((y * torch.tensor(dout)).sum(), ts[:7])
    assert all(torch.isfinite(g).all() for g in grads)
    assert torch.equal(ts[7], h0)
    state = ops[7].clone()
    selective_scan_ref(*ops[:7], state)
    assert not torch.equal(state, ops[7])
    want = selective_scan_bwd_ref(*ops, torch.tensor(dout))
    for g, w in zip(grads, want):
        _rel_close(g, w, 1e-5)


# ------------------------------------------------------------------- (b) wkv6

def _wkv6_inputs(s, decay, nonzero, b=2, h=2, dh=16):
    rng = np.random.default_rng(s + 7 * len(decay))
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    r, k, v = f(b, s, h, dh), f(b, s, h, dh), f(b, s, h, dh)
    if decay == "ordinary":
        w = np.exp(-np.exp(f(b, s, h, dh) - 2)).astype(np.float32)
    else:                         # each row extreme, the rest ordinary
        w = np.exp(-np.exp(f(b, s, h, dh) - 2)).astype(np.float32)
        w[..., ::2] = np.float32(1e-30 if decay == "tiny" else 1 - 1e-7)
    u = f(h, dh)
    s0 = f(b, h, dh, dh) if nonzero else np.zeros((b, h, dh, dh), np.float32)
    dy, ds = f(b, s, h, dh), f(b, h, dh, dh)
    return (r, k, v, w, u, s0), dy, ds


# (s, decay, nonzero s0, algorithm, dh): every length, decay and start
# for the backward's plain algorithm (``wkv6_bwd_ref``, dh 16); for the
# backward kernel's decomposition (``wkv6_bwd_sliced_ref``: 16-row slices,
# so dh 32 gives two and dv crosses them) lengths no chunk divides, a
# decay of 1e-30 and a nonzero s0 (ds is always nonzero here)
_WKV6_CASES = (
    [pytest.param(s, decay, nz, "token", 16,
                  id=f"{s}-{decay}-{'s0' if nz else 's0zero'}")
     for s in (1, 15, 16, 17, 35, 256) for decay in ("ordinary", "tiny", "near1")
     for nz in (False, True)]
    + [pytest.param(s, decay, True, "sliced", 32, id=f"sliced-{s}-{decay}-s0")
       for s, decay in ((1, "tiny"), (17, "tiny"), (35, "ordinary"), (40, "near1"))])


@pytest.mark.parametrize("s, decay, nonzero, algo, dh", _WKV6_CASES)
def test_wkv6_bwd_matches_jax_vjp(s, decay, nonzero, algo, dh):
    """Every gradient (dr, dk, dv, dw, du, ds0) within 1e-5 of its largest
    entry of ``jax.vjp`` of the reference's checkpointed scan, and of
    autograd through ``wkv6_ref``; for the plain algorithm the wrapper's
    autograd Function (the CPU path) equal to ``wkv6_bwd_ref`` bit for
    bit, for the kernel's decomposition ``wkv6_bwd_sliced_ref`` within
    1e-5 of it."""
    ops, dy, ds = _wkv6_inputs(s, decay, nonzero, dh=dh)
    _, vjp = jax.vjp(jrwkv6._wkv_scan, *map(jnp.asarray, ops))
    want = vjp((jnp.asarray(dy), jnp.asarray(ds)))
    t = [torch.tensor(a) for a in ops]
    bwd = wkv6_bwd_ref if algo == "token" else wkv6_bwd_sliced_ref
    got = bwd(*t, torch.tensor(dy), torch.tensor(ds))
    for g, w in zip(got, want):
        _rel_close(g.numpy(), w, 1e-5)
    ts = [a.clone().requires_grad_() for a in t]
    y, st = wkv6_ref(*ts)
    auto = torch.autograd.grad((y * torch.tensor(dy)).sum()
                               + (st * torch.tensor(ds)).sum(), ts)
    for g, w in zip(got, auto):
        _rel_close(g.numpy(), w.numpy(), 1e-5)
    if algo == "sliced":
        plain = wkv6_bwd_ref(*t, torch.tensor(dy), torch.tensor(ds))
        for g, w in zip(got, plain):
            _rel_close(g.numpy(), w.numpy(), 1e-5)
        return
    ts = [a.clone().requires_grad_() for a in t]
    y, st = wkv6(*ts)
    fn = torch.autograd.grad((y * torch.tensor(dy)).sum()
                             + (st * torch.tensor(ds)).sum(), ts)
    assert all(torch.equal(a, b) for a, b in zip(fn, got))


# ------------------------------------------------------ (c) selective scan

def _jax_body(delta, x, z, bm, cm, a_log, d_skip, h0):
    """The reference's mamba body (src/repro/models/mamba.py:114-132),
    from delta to the gated output, with h0 injected as its cache path
    does (s > 1) and its ``_ssm_scan``."""
    a = -jnp.exp(a_log)
    da = jnp.exp(delta[..., None] * a)
    dbx = (delta[..., None] * bm[:, :, None, :].astype(jnp.float32)
           * x[..., None].astype(jnp.float32))
    if x.shape[1] == 1:
        h = (da[:, 0] * h0 + dbx[:, 0])[:, None]
    else:
        dbx = dbx.at[:, 0].add(da[:, 0] * h0)
        h = jmamba._ssm_scan(da, dbx)
    y = jnp.einsum("bsdn,bsn->bsd", h, cm.astype(jnp.float32))
    y = y + d_skip * x.astype(jnp.float32)
    return (y * jax.nn.silu(z.astype(jnp.float32))).astype(x.dtype)


# bf16: the gradients of x, z, B and C are rounded to bfloat16 in both
# packages, where the reference also rounds each of x's two float32 uses'
# cotangent before adding them (the port adds in float32, then rounds):
# a few bf16 ulps of each leaf's largest entry
SCAN_REL = {"float32": 1e-5, "bfloat16": 2e-2}


# (dtype, n, h0, algorithm, steps, channels): the backward's plain
# algorithm (``selective_scan_bwd_ref``) over 37 steps of 24 channels; the
# backward kernel's decomposition (``selective_scan_bwd_windowed_ref``:
# da kept a chunk, states recomputed 8 steps at a time, dB and dC summed
# by blocks and clusters of channels) over 40 steps (no chunk length
# divides it) of 300 channels (a partial cluster), from a nonzero h0
_SCAN_CASES = (
    [pytest.param(dtype, n, h0, "step", 37, 24, id=f"{dtype}-{n}-{'h0' if h0 else 'zero'}")
     for dtype in ("float32", "bfloat16") for n in (8, 16) for h0 in (False, True)]
    + [pytest.param(dtype, n, True, "windowed", 40, 300, id=f"windowed-{dtype}-{n}-h0")
       for dtype in ("float32", "bfloat16") for n in (8, 16)])


@pytest.mark.parametrize("dtype, n, h0, algo, s, di", _SCAN_CASES)
def test_selective_scan_bwd_matches_jax_vjp(dtype, n, h0, algo, s, di):
    """(ddelta, dx, dz, dB, dC, da_log, dD, dh0) within ``SCAN_REL`` of
    each leaf's largest entry of ``jax.vjp`` of the reference's body (the
    checkpoints of every chunk length, 16, 24 and 32, cut the steps
    unevenly); for the plain algorithm the Function (the wrapper's CPU
    path) equal to the plain backward bit for bit, for the kernel's
    decomposition within ``SCAN_REL`` of it."""
    arrays, dout = _scan_inputs(np.random.default_rng(n), 2, s, di, n,
                                dtype, h0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jops = [jnp.asarray(a, jdt if i in (1, 2, 3, 4) else jnp.float32)
            for i, a in enumerate(arrays)]
    _, vjp = jax.vjp(_jax_body, *jops)
    want = vjp(jnp.asarray(dout, jdt))
    ops = _torch(arrays, dtype)
    d = torch.tensor(dout).to(ops[1].dtype)
    if algo == "windowed":
        got = selective_scan_bwd_windowed_ref(*ops, d, block=128 // (n // 4))
    else:
        got = selective_scan_bwd_ref(*ops, d)
    for g, w in zip(got, want):
        _rel_close(g.float().numpy(), np.asarray(w, np.float32), SCAN_REL[dtype])
    for g, o in zip(got[1:5], ops[1:5]):
        assert g.dtype == o.dtype
    if algo == "windowed":
        for g, w in zip(got, selective_scan_bwd_ref(*ops, d)):
            _rel_close(g.float().numpy(), w.float().numpy(), SCAN_REL[dtype])
        return
    ts = [t.clone().requires_grad_() for t in ops]
    fn = torch.autograd.grad((selective_scan(*ts).float() * d.float()).sum(), ts)
    assert all(torch.equal(a, b) for a, b in zip(fn, got))
