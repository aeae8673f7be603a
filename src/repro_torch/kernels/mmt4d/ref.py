"""Plain PyTorch version of the mmt4d kernel."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

ACTIVATIONS = {
    None: lambda x: x,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # jax.nn.gelu's default
    "silu": F.silu,
    "relu": F.relu,
    "tanh": torch.tanh,
}


def mmt4d_ref(a_pack: torch.Tensor, b_pack: torch.Tensor,
              bias_pack: Optional[torch.Tensor] = None, *,
              activation: Optional[str] = None) -> torch.Tensor:
    """C_pack[m_o,n_o] = act(sum_k A_pack[m_o,k] @ B_pack[n_o,k]^T + bias),
    float32 accumulation and epilogue, one cast to A's dtype."""
    out = torch.einsum("mkab,nkcb->mnac", a_pack.float(), b_pack.float())
    if bias_pack is not None:
        out = out + bias_pack[None, :, None, :].float()
    return ACTIVATIONS[activation](out).to(a_pack.dtype)
