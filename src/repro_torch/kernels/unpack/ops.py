"""Wrapper of the unpack kernel (``csrc/unpack.cu``).

Replaces the Pallas ``unpack_kernel_call``
(src/repro/kernels/unpack/kernel.py:31).  A CPU tensor takes the plain
version (``ref.py``); a CUDA tensor launches the kernel or raises.  Takes
leading batch dims; the packed input must be contiguous.  Bound by bytes;
at decode widths the launch dominates, so later work should fuse it into
its producer rather than speed it up.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.unpack.ref import unpack_ref

__all__ = ["unpack"]


def unpack(a_pack: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """A_pack[..., M_o, K_o, t0, t1] -> A[..., m, k] (contiguous)."""
    if a_pack.device.type == "cpu":
        return unpack_ref(a_pack, m, k)
    build.require_cuda("unpack", a_pack)
    code = build.require_dtype("unpack", a_pack.dtype, a_pack)
    build.require_contiguous("unpack", a_pack=a_pack)
    *lead, mo, ko, t0, t1 = a_pack.shape
    if not (0 <= m <= mo * t0 and 0 <= k <= ko * t1):
        raise ValueError(f"unpack: ({m}, {k}) outside the packed extent "
                         f"({mo * t0}, {ko * t1})")
    out = torch.empty((*lead, m, k), dtype=a_pack.dtype, device=a_pack.device)
    batch = a_pack.numel() // max(1, mo * ko * t0 * t1)
    rc = build.load_library().repro_unpack(
        a_pack.data_ptr(), out.data_ptr(), code, batch, mo, ko, t0, t1, m, k,
        build.stream_of(a_pack))
    build.check(rc, "unpack")
    unpack.launches += 1
    return out


unpack.launches = 0
