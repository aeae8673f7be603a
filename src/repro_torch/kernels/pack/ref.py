"""Plain PyTorch version of the pack kernel (same math as core/packing)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pack_ref(a: torch.Tensor, t0: int, t1: int) -> torch.Tensor:
    """A[..., M, K] -> A_pack[..., ceil(M/t0), ceil(K/t1), t0, t1],
    zero-padded tiles."""
    *lead, m, k = a.shape
    a = F.pad(a, (0, (-k) % t1, 0, (-m) % t0))
    mo, ko = a.shape[-2] // t0, a.shape[-1] // t1
    return a.reshape(*lead, mo, t0, ko, t1).transpose(-3, -2).contiguous()
