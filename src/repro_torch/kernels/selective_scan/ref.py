"""Plain PyTorch version of the selective_scan kernel: mamba's selective
SSM body between ``_delta`` and ``out_proj`` (the JAX package's
``models/mamba.py:110-132``), expression for expression: ``da``, ``dbx``,
the sequential scan from ``h0``, the einsum, the skip and the gate; and
``selective_scan_bwd_ref``, its backward's algorithm; and, which only the
tests use, ``selective_scan_bwd_windowed_ref``, the backward kernel's
decomposition (``csrc/selective_scan_bwd.cu``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _ssm_scan(da: torch.Tensor, dbx: torch.Tensor) -> torch.Tensor:
    """h_t = da_t * h_{t-1} + dbx_t over axis 1 from h_{-1} = 0; da, dbx
    [B, S, di, N].  Returns every h_t."""
    h = dbx[:, 0]
    hs = [h]
    for t in range(1, da.shape[1]):
        h = da[:, t] * h + dbx[:, t]
        hs.append(h)
    return torch.stack(hs, 1)


def scan_chunk(dtype: torch.dtype, n: int) -> int:
    """Steps between two checkpoints of the state: the kernel's staged
    chunk (``csrc/selective_scan.cu``: ScanShape::kSteps)."""
    return 16 if n == 8 else 32 if dtype == torch.bfloat16 else 24


def selective_scan_ref(delta: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, a_log: torch.Tensor,
                       d_skip: torch.Tensor, state: torch.Tensor, *,
                       ckpt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """delta [B, S, di] float32; x, z [B, S, di] and b, c [B, S, N] in the
    compute dtype; a_log [di, N] and d_skip [di] float32; state [B, di, N]
    float32, the recurrence's h0, overwritten with the final state unless
    autograd records the call (an operand requires a gradient: then
    ``state`` is only read, and the scan runs from a copy of it, which no
    write can change under autograd's saved tensors).  Returns y [B, S,
    di] in x's dtype.  A zero ``state`` is the train/prefill mode (``da *
    0 + dbx`` is ``dbx``).  ``ckpt`` [B, ceil(S / L) - 1, di, N] (L =
    :func:`scan_chunk`) takes the state before each chunk but the first."""
    recorded = torch.is_grad_enabled() and any(
        t.requires_grad for t in (delta, x, z, b, c, a_log, d_skip, state))
    h0 = state.clone() if recorded else state
    a = -torch.exp(a_log)                                        # [di,N]
    da = torch.exp(delta[..., None] * a)                         # [B,S,di,N]
    dbx = (delta[..., None] * b[:, :, None, :].float()
           * x[..., None].float())
    if x.shape[1] == 1:
        h = (da[:, 0] * h0 + dbx[:, 0])[:, None]
    else:           # h0 enters the first step
        dbx = torch.cat([(dbx[:, 0] + da[:, 0] * h0)[:, None], dbx[:, 1:]], 1)
        h = _ssm_scan(da, dbx)
    if ckpt is not None:
        step = scan_chunk(x.dtype, a_log.shape[-1])
        for i in range(ckpt.shape[1]):
            ckpt[:, i] = h[:, (i + 1) * step - 1]
    if not recorded:
        state.copy_(h[:, -1])
    y = torch.einsum("bsdn,bsn->bsd", h, c.float())
    y = y + d_skip * x.float()
    return (y * F.silu(z.float())).to(x.dtype)


def selective_scan_bwd_ref(delta, x, z, b, c, a_log, d_skip, h0, dout,
                           ckpt: Optional[torch.Tensor] = None):
    """The gradients of :func:`selective_scan_ref` by the backward's
    algorithm: (ddelta [B, S, di] float32,
    dx, dz [B, S, di] and db, dc [B, S, N] in x's dtype, da_log [di, N] and
    dd_skip [di] float32, dh0 [B, di, N] float32) from dout [B, S, di].

    With a = -exp(a_log), da_t = exp(delta_t a), y_t the output before its
    gate and G_t the gradient of h_t, walking the steps backwards:

    - the gate: ``dy = dout silu(z)``, ``dz = dout y silu'(z)``;
    - ``G_t = dy_t C_t + da_{t+1} G_{t+1}``;
    - ``dC_t = sum_d dy_t h_t`` and ``dB_t = sum_d G_t delta_t x_t`` (over
      the channels); ``dx_t = dy_t D + sum_n G_t delta_t B_t``;
      ``ddelta_t = sum_n G_t (B_t x_t + h_{t-1} da_t a)``;
    - ``da_log = a sum_t G_t h_{t-1} da_t delta_t`` and ``dD = sum_t dy_t
      x_t``, per row, then the rows added in order; ``dh0 = da_0 G_0``.

    The states h_{t-1} come from each chunk's checkpoint (``ckpt`` as
    :func:`selective_scan_ref` writes it; made here when None), never from
    h_t by division."""
    rows, s, di = delta.shape
    n = a_log.shape[-1]
    step = scan_chunk(x.dtype, n)
    chunks = -(-s // step)
    if ckpt is None:
        ckpt = delta.new_empty((rows, max(0, chunks - 1), di, n))
        with torch.no_grad():
            selective_scan_ref(delta, x, z, b, c, a_log, d_skip, h0.clone(),
                               ckpt=ckpt)
    a = -torch.exp(a_log)
    xf, zf, bf, cf, dof = (t.float() for t in (x, z, b, c, dout))
    sig = torch.sigmoid(zf)
    g = torch.zeros_like(h0)
    ddelta, dx, dz = (torch.empty_like(delta) for _ in range(3))
    db, dc = (delta.new_empty((rows, s, n)) for _ in range(2))
    da_rows = torch.zeros_like(h0)                      # sum_t G h da delta
    dd_rows = delta.new_zeros((rows, di))
    for ch in range(chunks - 1, -1, -1):
        t0, t1 = ch * step, min(s, (ch + 1) * step)
        h, prev = (h0 if ch == 0 else ckpt[:, ch - 1]), []
        for t in range(t0, t1):
            prev.append(h)
            h = (torch.exp(delta[:, t, :, None] * a) * h
                 + delta[:, t, :, None] * bf[:, t, None, :] * xf[:, t, :, None])
        for t in range(t1 - 1, t0 - 1, -1):
            hp = prev[t - t0]
            dt, xt = delta[:, t], xf[:, t]
            dat = torch.exp(dt[..., None] * a)              # [B,di,N]
            ht = dat * hp + dt[..., None] * bf[:, t, None, :] * xt[..., None]
            y = (ht * cf[:, t, None, :]).sum(-1) + d_skip * xt
            dy = dof[:, t] * zf[:, t] * sig[:, t]
            dz[:, t] = dof[:, t] * y * sig[:, t] * (1 + zf[:, t] * (1 - sig[:, t]))
            g = g + dy[..., None] * cf[:, t, None, :]
            dc[:, t] = (dy[..., None] * ht).sum(1)
            db[:, t] = (g * (dt * xt)[..., None]).sum(1)
            dx[:, t] = dy * d_skip + (g * bf[:, t, None, :]).sum(-1) * dt
            ddelta[:, t] = (g * (bf[:, t, None, :] * xt[..., None]
                                 + hp * dat * a)).sum(-1)
            da_rows = da_rows + g * hp * dat * dt[..., None]
            dd_rows = dd_rows + dy * xt
            g = dat * g
    da_log, dd = da_rows[0] * a, dd_rows[0]
    for row in range(1, rows):
        da_log, dd = da_log + da_rows[row] * a, dd + dd_rows[row]
    cast = lambda t: t.to(x.dtype)
    return ddelta, cast(dx), cast(dz), cast(db), cast(dc), da_log, dd, g


def selective_scan_bwd_windowed_ref(delta, x, z, b, c, a_log, d_skip, h0, dout,
                                    ckpt: Optional[torch.Tensor] = None,
                                    window: int = 8, block: int = 32,
                                    cluster: int = 4):
    """:func:`selective_scan_bwd_ref`'s gradients by the backward kernel's
    decomposition (``csrc/selective_scan_bwd.cu``), for the tests: each
    chunk's da_t computed once, in a forward pass from its checkpoint that
    keeps the state at every ``window``-th step; each window's states then
    recomputed from its start with the kept da_t and walked back; silu(z)
    and dy once a (step, channel); dB and dC summed over ``block``
    channels, then over ``cluster`` blocks in order, then over the
    clusters in order (the channels past di counted as zeros).  Same
    arguments and results as :func:`selective_scan_bwd_ref`."""
    rows, s, di = delta.shape
    n = a_log.shape[-1]
    step = scan_chunk(x.dtype, n)
    chunks = -(-s // step)
    if ckpt is None:
        ckpt = delta.new_empty((rows, max(0, chunks - 1), di, n))
        with torch.no_grad():
            selective_scan_ref(delta, x, z, b, c, a_log, d_skip, h0.clone(),
                               ckpt=ckpt)
    a = -torch.exp(a_log)
    xf, zf, bf, cf, dof = (t.float() for t in (x, z, b, c, dout))
    sig = torch.sigmoid(zf)
    dyv = dof * zf * sig
    g = torch.zeros_like(h0)
    ddelta, dx, dz = (torch.empty_like(delta) for _ in range(3))
    db, dc = (delta.new_empty((rows, s, n)) for _ in range(2))
    da_rows = torch.zeros_like(h0)
    dd_rows = delta.new_zeros((rows, di))
    group = block * cluster
    padded = -(-di // group) * group

    def over_channels(part):      # [B, di, N] -> [B, N], the kernel's order
        part = torch.cat([part, part.new_zeros((rows, padded - di, n))], 1)
        blocks = part.reshape(rows, padded // group, cluster, block, n).sum(3)
        tiles = blocks[:, :, 0]
        for m in range(1, cluster):
            tiles = tiles + blocks[:, :, m]
        out = tiles[:, 0]
        for q in range(1, tiles.shape[1]):
            out = out + tiles[:, q]
        return out

    def advance(h, t, da):
        return da * h + delta[:, t, :, None] * bf[:, t, None, :] * xf[:, t, :, None]

    for ch in range(chunks - 1, -1, -1):
        t0, t1 = ch * step, min(s, (ch + 1) * step)
        h = h0 if ch == 0 else ckpt[:, ch - 1]
        kept, starts = {}, {}
        for t in range(t0, t1):
            if (t - t0) % window == 0:
                starts[t] = h
            kept[t] = torch.exp(delta[:, t, :, None] * a)
            h = advance(h, t, kept[t])
        for w0 in sorted(starts, reverse=True):
            hs = [starts[w0]]
            for t in range(w0, min(t1, w0 + window)):
                hs.append(advance(hs[-1], t, kept[t]))
            for t in range(min(t1, w0 + window) - 1, w0 - 1, -1):
                hp, ht, dat = hs[t - w0], hs[t - w0 + 1], kept[t]
                dt, xt, dy = delta[:, t], xf[:, t], dyv[:, t]
                y = (ht * cf[:, t, None, :]).sum(-1) + d_skip * xt
                dz[:, t] = dof[:, t] * y * sig[:, t] * (1 + zf[:, t] * (1 - sig[:, t]))
                g = g + dy[..., None] * cf[:, t, None, :]
                dc[:, t] = over_channels(dy[..., None] * ht)
                db[:, t] = over_channels(g * (dt * xt)[..., None])
                dx[:, t] = dy * d_skip + (g * bf[:, t, None, :]).sum(-1) * dt
                ddelta[:, t] = (g * (bf[:, t, None, :] * xt[..., None]
                                     + hp * dat * a)).sum(-1)
                da_rows = da_rows + g * hp * dat * dt[..., None]
                dd_rows = dd_rows + dy * xt
                g = dat * g
    da_log, dd = da_rows[0] * a, dd_rows[0]
    for row in range(1, rows):
        da_log, dd = da_log + da_rows[row] * a, dd + dd_rows[row]
    cast = lambda t: t.to(x.dtype)
    return ddelta, cast(dx), cast(dz), cast(db), cast(dc), da_log, dd, g
