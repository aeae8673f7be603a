"""Packed matrix multiplication (``linalg.mmt4d``) with fused epilogues.

    C_pack[m_o, n_o, :, :] = act(sum_k A_pack[m_o, k_o] @ B_pack[n_o, k_o]^T + bias)

runs in the mmt4d kernel (``repro_torch.kernels.mmt4d``) for CUDA tensors
and its plain version for CPU tensors.  :class:`Epilogue` carries the bias
and activation that the kernel applies in float32 before its one cast.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.layout import PackedLayout
from repro_torch.core import packing
from repro_torch.kernels.mmt4d.ops import mmt4d as mmt4d_kernel

__all__ = ["mmt4d", "Epilogue"]


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Pointwise epilogue fused into the packed-domain matmul: an optional
    bias add and an activation named as in ``kernels/mmt4d``
    (None | "gelu" (tanh) | "silu" | "relu" | "tanh")."""

    activation: Optional[str] = None

    def bias_pack(self, bias: Optional[torch.Tensor],
                  layout: PackedLayout) -> Optional[torch.Tensor]:
        """An unpacked ``[N]`` bias tiled along n_r: ``[N_o, n_r]``
        (None without a bias)."""
        if bias is None:
            return None
        bp = packing.pad_to_tiles(bias[None, :], 1, layout.n_r)
        return bp.reshape(-1, layout.n_r).contiguous()


def mmt4d(a_pack: torch.Tensor, b_pack: torch.Tensor,
          bias_pack: Optional[torch.Tensor] = None, *,
          activation: Optional[str] = None,
          unpack_to: Optional[tuple] = None) -> torch.Tensor:
    """a_pack [..., M_o, K_o, m_r, k_r], b_pack [N_o, K_o, n_r, k_r] ->
    C_pack [..., M_o, N_o, m_r, n_r] in a_pack's dtype, or with
    ``unpack_to=(m, n)`` C [..., m, n] (the kernel's unpacked store: the
    result leaves the packed domain without an unpack launch).

    Leading LHS dims fold into M_o (a free reshape of contiguous packed
    tiles, done by the kernel wrapper), as the JAX package's
    ``core/mmt4d.py`` does for a plain weight."""
    if b_pack.ndim != 4:
        raise NotImplementedError("expert-batched B_pack [E, N_o, K_o, n_r, "
                                  "k_r] comes with the MoE family")
    return mmt4d_kernel(a_pack, b_pack, bias_pack, activation=activation,
                        unpack_to=unpack_to)
