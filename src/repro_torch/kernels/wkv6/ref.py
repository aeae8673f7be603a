"""Plain PyTorch version of the wkv6 kernel: the token loop of the JAX
package's ``_wkv_scan`` step (src/repro/models/rwkv6.py:96), einsum for
einsum."""

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
