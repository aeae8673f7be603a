"""Plain PyTorch versions of the wkv6 kernels: ``wkv6_ref``, the token loop
of the JAX package's ``_wkv_scan`` step (src/repro/models/rwkv6.py:96),
einsum for einsum, which the wrapper takes for CPU tensors;
``wkv6_bwd_ref``, the backward's algorithm: the reverse recurrence, each
chunk's states recomputed from its checkpoint; and, which only the tests
use, ``wkv6_chunked_ref``, the chunked algebra the forward kernel
computes, and ``wkv6_bwd_sliced_ref``, the backward kernel's
decomposition (``csrc/wkv6_bwd.cu``)."""

from __future__ import annotations

from typing import Optional

import torch


# tokens between two checkpoints of the state (csrc/wkv6.cu: kL)
CHUNK = 16


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
             state_out: Optional[torch.Tensor] = None,
             ckpt: Optional[torch.Tensor] = None):
    """r, k, v, w: [B, S, H, dh] float32; u: [H, dh]; s0: [B, H, dh, dh].
    Returns (y [B, S, H, dh], the state after the last token), the state
    written into ``state_out`` when given.  ``ckpt`` [B, H, ceil(S / 16) -
    1, dh, dh] takes the state before each chunk of :data:`CHUNK` tokens
    but the first (the backward's checkpoints)."""
    state, ys = s0, []
    for t in range(r.shape[1]):
        if ckpt is not None and t and t % CHUNK == 0:
            ckpt[:, :, t // CHUNK - 1] = state
        a = k[:, t, :, :, None] * v[:, t, :, None, :]          # [B,H,dh,dh]
        ys.append(torch.einsum("bhij,bhi->bhj", state + u[..., None] * a,
                               r[:, t]))
        state = w[:, t, :, :, None] * state + a
    if state_out is not None:
        state = state_out.copy_(state)
    return torch.stack(ys, 1), state


def wkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
                     chunk: int = 16, state_out: Optional[torch.Tensor] = None):
    """The kernel's chunked algebra (``csrc/wkv6.cu``) in plain PyTorch,
    for the tests: the same result as :func:`wkv6_ref` with the token loop
    cut into chunks of ``chunk`` tokens.  In a chunk, from its start state
    S0, with every decay a product of w (at most 1: no overflow, no
    division; over no tokens, 1):

    - ``A[t, s] = sum_i r_t k_s prod_{s<tau<t} w_tau`` (s < t) and
      ``A[t, t] = sum_i r_t u k_t``;
    - ``y_t = (r_t prod_{tau<t} w_tau) S0 + sum_{s<=t} A[t, s] v_s``;
    - ``S = (prod_tau w_tau) S0 + sum_s (k_s prod_{s<tau} w_tau) v_s^T``.

    The products run as the kernel's: forwards for y's decay, backwards
    from the chunk's end for the state's (so a one-token chunk decays by w
    itself).  Same arguments and results as :func:`wkv6_ref`."""
    b, s, h, dh = r.shape
    state, ys = s0, []
    for t0 in range(0, s, chunk):
        rc, kc, vc, wc = (a[:, t0:t0 + chunk].transpose(1, 2)   # [B,H,L,dh]
                          for a in (r, k, v, w))
        n = rc.shape[2]
        ones = torch.ones_like(wc[:, :, :1])
        before = torch.cumprod(torch.cat([ones, wc[:, :, :-1]], 2), 2)
        # after[s] = w_{n-1} ... w_{s+1}, taken from the end; after[-1] is all
        after = [ones[:, :, 0]]
        for i in range(n - 1, -1, -1):
            after.append(after[-1] * wc[:, :, i])
        decay = after.pop()
        after = torch.stack(after[::-1], 2)                    # [B,H,L,dh]
        a = r.new_zeros((b, h, n, n))
        for j in range(n):
            a[:, :, j, j] = (rc[:, :, j] * u * kc[:, :, j]).sum(-1)
            g = kc[:, :, j]
            for t in range(j + 1, n):
                if t > j + 1:
                    g = g * wc[:, :, t - 1]
                a[:, :, t, j] = (rc[:, :, t] * g).sum(-1)
        y = (torch.einsum("bhti,bhij->bhtj", rc * before, state)
             + torch.einsum("bhts,bhsj->bhtj", a, vc))
        state = (decay[..., None] * state
                 + torch.einsum("bhsi,bhsj->bhij", kc * after, vc))
        ys.append(y.transpose(1, 2))
    if state_out is not None:
        state = state_out.copy_(state)
    return torch.cat(ys, 1), state


def wkv6_bwd_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                 dy: torch.Tensor, ds: Optional[torch.Tensor] = None,
                 ckpt: Optional[torch.Tensor] = None):
    """The gradients of :func:`wkv6_ref` by the backward kernel's algorithm:
    (dr, dk, dv, dw [B, S, H, dh], du [H, dh], ds0 [B, H, dh, dh]) from dy
    [B, S, H, dh] and ds, the final state's gradient (None: zero).

    With ``G_t`` the gradient of the state after token t (``ds`` after the
    last), walking the tokens backwards:

    - ``dr_t = S_{t-1} dy_t + u k_t (v_t . dy_t)``,
      ``dk_t = G_t v_t + u r_t (v_t . dy_t)``,
      ``dv_t = G_t^T k_t + dy_t (r_t . u k_t)``,
      ``dw_t[i] = sum_j G_t[i, j] S_{t-1}[i, j]``;
    - ``du = sum_t r_t k_t (v_t . dy_t)``, per row, then the rows added in
      order;
    - ``G_{t-1} = w_t G_t + r_t dy_t^T``; ds0 is G before the first token.

    ``S_{t-1}`` is never recovered by dividing by w (a decay of 1e-30
    would lose it): each chunk of :data:`CHUNK` tokens recomputes its
    states from its checkpoint, ``ckpt`` as :func:`wkv6_ref` writes it
    (made here when None)."""
    b, s, h, dh = r.shape
    n = -(-s // CHUNK)
    if ckpt is None:
        ckpt = r.new_empty((b, h, max(0, n - 1), dh, dh))
        wkv6_ref(r, k, v, w, u, s0, ckpt=ckpt)
    g = torch.zeros_like(s0) if ds is None else ds.clone()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du_rows = r.new_zeros((b, h, dh))
    for c in range(n - 1, -1, -1):
        t0, t1 = c * CHUNK, min(s, (c + 1) * CHUNK)
        state, prev = (s0 if c == 0 else ckpt[:, :, c - 1]), []
        for t in range(t0, t1):
            prev.append(state)
            state = (w[:, t, :, :, None] * state
                     + k[:, t, :, :, None] * v[:, t, :, None, :])
        for t in range(t1 - 1, t0 - 1, -1):
            sp = prev[t - t0]
            rt, kt, vt, wt, dyt = (a[:, t] for a in (r, k, v, w, dy))
            vd = (vt * dyt).sum(-1, keepdim=True)                # [B,H,1]
            ruk = (rt * u * kt).sum(-1, keepdim=True)
            dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, dyt) + u * kt * vd
            dk[:, t] = torch.einsum("bhij,bhj->bhi", g, vt) + u * rt * vd
            dv[:, t] = torch.einsum("bhij,bhi->bhj", g, kt) + dyt * ruk
            dw[:, t] = (g * sp).sum(-1)
            du_rows = du_rows + rt * kt * vd
            g = wt[..., None] * g + rt[..., :, None] * dyt[..., None, :]
    du = du_rows[0]
    for row in range(1, b):
        du = du + du_rows[row]
    return dr, dk, dv, dw, du, g


def wkv6_bwd_sliced_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                        dy: torch.Tensor, ds: Optional[torch.Tensor] = None,
                        ckpt: Optional[torch.Tensor] = None, rows: int = 16):
    """:func:`wkv6_bwd_ref`'s gradients by the backward kernel's
    decomposition (``csrc/wkv6_bwd.cu``), for the tests: the state's rows
    in slices of ``rows`` (a row's S and G evolve on their own, and dr, dk,
    dw and du are sums within a row), each chunk's states recomputed from
    its checkpoint half a chunk at a time (the later half first: the first
    half advanced, then the later half kept), and dv a sum over the slices,
    in slice order, of each slice's ``sum_i k_t[i] (G_t[i, :] + r_t[i] u[i]
    dy_t)``: the bonus term's share folded into each row's.  Same
    arguments and results as :func:`wkv6_bwd_ref`."""
    b, s, h, dh = r.shape
    n = -(-s // CHUNK)
    half = CHUNK // 2
    if ckpt is None:
        ckpt = r.new_empty((b, h, max(0, n - 1), dh, dh))
        wkv6_ref(r, k, v, w, u, s0, ckpt=ckpt)
    # the chunks padded to whole: r = k = v = dy = 0 and w = 1 change nothing
    pad = n * CHUNK - s
    rp, kp, vp, dyp = (torch.cat([a, a.new_zeros((b, pad, h, dh))], 1)
                       for a in (r, k, v, dy))
    wp = torch.cat([w, w.new_ones((b, pad, h, dh))], 1)
    g = torch.zeros_like(s0) if ds is None else ds.clone()
    dr, dk, dv, dw = (r.new_empty((b, n * CHUNK, h, dh)) for _ in range(4))
    du_rows = r.new_zeros((b, h, dh))
    slices = [slice(q, q + rows) for q in range(0, dh, rows)]
    for c in range(n - 1, -1, -1):
        start = s0 if c == 0 else ckpt[:, :, c - 1]
        for part in (1, 0):
            st, kept = start, []
            for t in range(c * CHUNK, c * CHUNK + part * half):
                st = wp[:, t, :, :, None] * st + kp[:, t, :, :, None] * vp[:, t, :, None, :]
            t0 = c * CHUNK + part * half
            for t in range(t0, t0 + half):
                kept.append(st)
                st = wp[:, t, :, :, None] * st + kp[:, t, :, :, None] * vp[:, t, :, None, :]
            for t in range(t0 + half - 1, t0 - 1, -1):
                sp = kept[t - t0]
                rt, kt, vt, wt, dyt = (a[:, t] for a in (rp, kp, vp, wp, dyp))
                vd = (vt * dyt).sum(-1, keepdim=True)                # [B,H,1]
                dr[:, t] = torch.einsum("bhij,bhj->bhi", sp, dyt) + u * kt * vd
                dk[:, t] = torch.einsum("bhij,bhj->bhi", g, vt) + u * rt * vd
                dw[:, t] = (g * sp).sum(-1)
                fold = (g + (rt * u)[..., :, None] * dyt[..., None, :]) * kt[..., :, None]
                acc = fold[:, :, slices[0]].sum(2)
                for sl in slices[1:]:
                    acc = acc + fold[:, :, sl].sum(2)
                dv[:, t] = acc
                du_rows = du_rows + rt * kt * vd
                g = wt[..., None] * g + rt[..., :, None] * dyt[..., None, :]
    du = du_rows[0]
    for row in range(1, b):
        du = du + du_rows[row]
    return dr[:, :s], dk[:, :s], dv[:, :s], dw[:, :s], du, g
