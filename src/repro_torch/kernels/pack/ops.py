"""Wrapper of the pack kernel (``csrc/pack.cu``).

Replaces the Pallas ``pack_kernel_call`` (src/repro/kernels/pack/kernel.py:46).
A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.  The input is read through its strides, so packing a
transposed view costs no copy; leading dims must fold into one batch dim
(``view(-1, M, K)``).  Bound by bytes: one block per tile, 16-byte copies
for contiguous rows, a staged transpose for a transposed view, a scalar
branch for other strides (see the source).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.pack.ref import pack_ref

__all__ = ["pack"]


def pack(a: torch.Tensor, t0: int, t1: int) -> torch.Tensor:
    """A[..., M, K] -> A_pack[..., ceil(M/t0), ceil(K/t1), t0, t1]."""
    if a.device.type == "cpu":
        return pack_ref(a, t0, t1)
    build.require_cuda("pack", a)
    code = build.require_dtype("pack", a.dtype, a)
    *lead, m, k = a.shape
    a3 = a.view(-1, m, k)          # raises if the lead dims do not fold
    mo, ko = -(-m // t0), -(-k // t1)
    out = torch.empty((*lead, mo, ko, t0, t1), dtype=a.dtype, device=a.device)
    sb, sm, sk = a3.stride()
    rc = build.load_library().repro_pack(
        a3.data_ptr(), out.data_ptr(), code, a3.shape[0], m, k, sb, sm, sk,
        t0, t1, build.stream_of(a))
    build.check(rc, "pack")
    pack.launches += 1
    return out


pack.launches = 0
