"""Wrapper of the pack kernel (``csrc/pack.cu``).

Replaces the Pallas ``pack_kernel_call`` (src/repro/kernels/pack/kernel.py:46).
The kernel is the op ``torch.ops.repro_torch.pack``
(:mod:`repro_torch.kernels.library`): a CPU tensor takes the plain version
(``ref.py``), a CUDA tensor launches the kernel or raises.  The input is
read through its strides, so packing a transposed view costs no copy;
leading dims must fold into one batch dim (``view(-1, M, K)``).  Bound by
bytes: one block per tile, 16-byte copies for contiguous rows, a staged
transpose for a transposed view, a scalar branch for other strides (see
the source).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, library
from repro_torch.kernels.pack.ref import pack_ref

__all__ = ["pack"]


def pack(a: torch.Tensor, t0: int, t1: int) -> torch.Tensor:
    """A[..., M, K] -> A_pack[..., ceil(M/t0), ceil(K/t1), t0, t1]."""
    return _OP(a, t0, t1)


pack.launches = 0


def _packed_shape(a: torch.Tensor, t0: int, t1: int) -> tuple:
    *lead, m, k = a.shape
    return (*lead, -(-m // t0), -(-k // t1), t0, t1)


def _pack_cpu(a, t0, t1):
    return library.fresh(pack_ref(a, t0, t1), a)


def _pack_cuda(a, t0, t1):
    build.require_cuda("pack", a)
    code = build.require_dtype("pack", a.dtype, a)
    m, k = a.shape[-2:]
    out = torch.empty(_packed_shape(a, t0, t1), dtype=a.dtype, device=a.device)
    if a.numel() == 0:             # nothing to pack (a rank's empty share of
        return out                 # a weight's tiles): no launch
    a3 = a.view(-1, m, k)          # raises if the lead dims do not fold
    sb, sm, sk = a3.stride()
    rc = build.load_library().repro_pack(
        a3.data_ptr(), out.data_ptr(), code, a3.shape[0], m, k, sb, sm, sk,
        t0, t1, build.stream_of(a))
    build.check(rc, "pack")
    pack.launches += 1
    return out


def _pack_fake(a, t0, t1):
    return a.new_empty(_packed_shape(a, t0, t1))


library.register("pack", cpu=_pack_cpu, cuda=_pack_cuda, fake=_pack_fake)
_OP = library.op("pack")
