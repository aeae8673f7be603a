"""Pack / unpack transformations (paper §4.1, ``linalg.pack``/``unpack``).

Packing is an explicit data transformation: the packed tensor holds its
tiles contiguously, and out-of-bounds elements of partial tiles are stored
as explicit zeros so the compute kernel runs unmasked (paper §4.3).
Leading batch dims are kept: ``pack_lhs`` on ``[..., M, K]`` packs the
trailing two dims.  Each function dispatches to the pack or unpack kernel
(``repro_torch.kernels``) for a CUDA tensor and to its plain version for a
CPU tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.layout import PackedLayout
from repro_torch.kernels.pack.ops import pack
from repro_torch.kernels.unpack.ops import unpack

__all__ = ["pad_to_tiles", "pack_lhs", "pack_rhs", "pack_out", "unpack_out",
           "unpack_lhs"]


def pad_to_tiles(x: torch.Tensor, t0: int, t1: int) -> torch.Tensor:
    """Zero-pad the trailing two dims of ``x`` up to multiples of (t0, t1)."""
    p0 = (-x.shape[-2]) % t0
    p1 = (-x.shape[-1]) % t1
    if p0 == 0 and p1 == 0:
        return x
    return F.pad(x, (0, p1, 0, p0))


def pack_lhs(a: torch.Tensor, layout: PackedLayout) -> torch.Tensor:
    """A[..., M, K] -> A_pack[..., M_o, K_o, m_r, k_r]."""
    return pack(a, layout.m_r, layout.k_r)


def pack_rhs(b: torch.Tensor, layout: PackedLayout) -> torch.Tensor:
    """B[..., K, N] -> B_pack[..., N_o, K_o, n_r, k_r] (transposed packing:
    the kernel reads the transposed view through its strides, no copy)."""
    return pack(b.transpose(-1, -2), layout.n_r, layout.k_r)


def pack_out(c: torch.Tensor, layout: PackedLayout) -> torch.Tensor:
    """C[..., M, N] -> C_pack[..., M_o, N_o, m_r, n_r]."""
    return pack(c, layout.m_r, layout.n_r)


def unpack_out(cp: torch.Tensor, m: int, n: int) -> torch.Tensor:
    """C_pack[..., M_o, N_o, m_r, n_r] -> C[..., M, N].  A linear's own exit
    does not come here: ``core/linear.py`` has mmt4d write its result
    unpacked (``unpack_to``)."""
    return unpack(cp, m, n)


def unpack_lhs(ap: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """A_pack[..., M_o, K_o, m_r, k_r] -> A[..., M, K]."""
    return unpack(ap, m, k)
