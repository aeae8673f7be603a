"""Plain PyTorch version of the selective_scan kernel: mamba's selective
SSM body between ``_delta`` and ``out_proj`` (the JAX package's
``models/mamba.py:110-132``), expression for expression: ``da``, ``dbx``,
the sequential scan from ``h0``, the einsum, the skip and the gate."""

from __future__ import annotations

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


def selective_scan_ref(delta: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, a_log: torch.Tensor,
                       d_skip: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """delta [B, S, di] float32; x, z [B, S, di] and b, c [B, S, N] in the
    compute dtype; a_log [di, N] and d_skip [di] float32; state [B, di, N]
    float32, the recurrence's h0, overwritten with the final state.
    Returns y [B, S, di] in x's dtype.  A zero ``state`` is the
    train/prefill mode (``da * 0 + dbx`` is ``dbx``)."""
    a = -torch.exp(a_log)                                        # [di,N]
    da = torch.exp(delta[..., None] * a)                         # [B,S,di,N]
    dbx = (delta[..., None] * b[:, :, None, :].float()
           * x[..., None].float())
    if x.shape[1] == 1:
        h = (da[:, 0] * state + dbx[:, 0])[:, None]
    else:           # h0 enters the first step
        dbx = torch.cat([(dbx[:, 0] + da[:, 0] * state)[:, None], dbx[:, 1:]], 1)
        h = _ssm_scan(da, dbx)
    state.copy_(h[:, -1])
    y = torch.einsum("bsdn,bsn->bsd", h, c.float())
    y = y + d_skip * x.float()
    return (y * F.silu(z.float())).to(x.dtype)
