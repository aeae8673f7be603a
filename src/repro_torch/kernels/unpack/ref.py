"""Plain PyTorch version of the unpack kernel."""

from __future__ import annotations

import torch


def unpack_ref(a_pack: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """A_pack[..., M_o, K_o, t0, t1] -> A[..., m, k] (padding dropped)."""
    *lead, mo, ko, t0, t1 = a_pack.shape
    a = a_pack.transpose(-3, -2).reshape(*lead, mo * t0, ko * t1)
    return a[..., :m, :k]
