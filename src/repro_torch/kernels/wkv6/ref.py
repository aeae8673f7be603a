"""Plain PyTorch versions of the wkv6 kernel: ``wkv6_ref``, the token loop
of the JAX package's ``_wkv_scan`` step (src/repro/models/rwkv6.py:96),
einsum for einsum, which the wrapper takes for CPU tensors; and
``wkv6_chunked_ref``, the chunked algebra the kernel computes, which only
the tests use."""

from __future__ import annotations

from typing import Optional

import torch


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor, *,
             state_out: Optional[torch.Tensor] = None):
    """r, k, v, w: [B, S, H, dh] float32; u: [H, dh]; s0: [B, H, dh, dh].
    Returns (y [B, S, H, dh], the state after the last token), the state
    written into ``state_out`` when given."""
    state, ys = s0, []
    for t in range(r.shape[1]):
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
