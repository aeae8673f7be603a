"""Wrapper of the unpack kernel (``csrc/unpack.cu``).

Replaces the Pallas ``unpack_kernel_call``
(src/repro/kernels/unpack/kernel.py:31).  A CPU tensor takes the plain
version (``ref.py``); a CUDA tensor launches the kernel or raises.  Takes
leading batch dims; the packed input must be contiguous.

Each thread copies 16 bytes of one output row (8 bf16 or 4 float32).  That
needs ``k`` and the tile width ``t1`` to be multiples of those 16 bytes'
worth of elements and both tensors to start on 16 bytes; where one of
these fails (:func:`vector_path`), the wrapper launches the kernel's
scalar variant, one element per thread, on the same grid.  Bound by bytes,
and at decode widths by the launch.

A linear's exits no longer come here: ``core/linear.py`` has mmt4d's
epilogue write the unpacked layout (``kernels/mmt4d/ops.py``, ``unpack_to``).
On the serving path what remains is the final stream before the logits
row gather, one launch per step.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.unpack.ref import unpack_ref

__all__ = ["unpack", "vector_path", "empty_launch"]

VECTOR_BYTES = 16


def vector_path(a_pack: torch.Tensor, out: torch.Tensor, k: int) -> bool:
    """Whether the kernel can move 16 bytes per thread: ``k`` and the tile
    width are multiples of the vector's elements and both tensors start on
    16 bytes."""
    per = VECTOR_BYTES // a_pack.element_size()
    return (k % per == 0 and a_pack.shape[-1] % per == 0
            and (a_pack.data_ptr() | out.data_ptr()) % VECTOR_BYTES == 0)


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
        int(vector_path(a_pack, out, k)), build.stream_of(a_pack))
    build.check(rc, "unpack")
    unpack.launches += 1
    return out


unpack.launches = 0


def empty_launch(like: torch.Tensor, wait: bool = False) -> None:
    """Launch an empty kernel on ``like``'s stream, as unpack launches
    (programmatic dependent launch): the floor a call of a few kilobytes
    is held against.  ``wait``: the kernel also waits on its predecessor,
    as unpack does before its first read.  Not counted as an unpack
    launch."""
    build.require_cuda("empty_launch", like)
    build.check(build.load_library().repro_empty_launch(
        int(wait), build.stream_of(like)), "empty_launch")
