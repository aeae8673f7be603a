"""Scalable packed layouts (paper §4.2).

    A in R^{M x K}  ->  A_pack in R^{ceil(M/m_r) x ceil(K/k_r) x m_r x k_r}
    A_pack[i_o, k_o, i_i, k_i] = A[i_o*m_r + i_i, k_o*k_r + k_i]

Tile sizes are functions of the hardware descriptor (``scalable``), frozen
constants (``fixed``), or absent (``unpacked``).  A direct port of the JAX
package's ``core/layout.py``; dtype widths come from ``torch.dtype.itemsize``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import torch

from repro_torch.core.hardware import HardwareSpec, sublane_packing

__all__ = ["LayoutPolicy", "Microkernel", "PackedLayout", "MICROKERNELS",
           "make_layout", "ceil_div", "round_up"]


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return ceil_div(a, b) * b


class LayoutPolicy(str, enum.Enum):
    SCALABLE = "scalable"   # tiles = f(HardwareSpec)
    FIXED = "fixed"         # compile-time constants
    UNPACKED = "unpacked"   # no data tiling


@dataclasses.dataclass(frozen=True)
class Microkernel:
    """A microkernel family: tile-size functions ``f(hw, dtype)``."""

    name: str
    f_m: Callable[[HardwareSpec, torch.dtype], int]
    f_n: Callable[[HardwareSpec, torch.dtype], int]
    f_k: Callable[[HardwareSpec, torch.dtype], int]

    def tiles(self, hw: HardwareSpec, dtype: torch.dtype) -> tuple[int, int, int]:
        return (self.f_m(hw, dtype), self.f_n(hw, dtype), self.f_k(hw, dtype))


def _outer_product(s_m: int = 1, s_n: int = 1, s_k: int = 1) -> Microkernel:
    """``m_r = sublanes * pack(dt) * s_m``, ``n_r = lanes * s_n``,
    ``k_r = mxu_k * s_k``; with ``s_n == s_k`` an output tile is a valid
    input tile of the next matmul (chain compatibility)."""
    return Microkernel(
        name=f"mxu_outer_product_{s_m}x{s_n}x{s_k}",
        f_m=lambda hw, dt: hw.sublanes * sublane_packing(dt) * s_m,
        f_n=lambda hw, dt: hw.lanes * s_n,
        f_k=lambda hw, dt: hw.mxu_k * s_k,
    )


MICROKERNELS: dict[str, Microkernel] = {
    "mxu_outer_product": _outer_product(),
    "mxu_outer_product_2x": _outer_product(s_m=2),
    "fixed_8x128x128": Microkernel(name="fixed_8x128x128",
                                   f_m=lambda hw, dt: 8,
                                   f_n=lambda hw, dt: 128,
                                   f_k=lambda hw, dt: 128),
}


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class PackedLayout:
    """A concrete packed layout for one matmul; all pack/unpack/mmt4d shape
    arithmetic flows through it."""

    policy: LayoutPolicy
    kernel_name: str
    m_r: int
    n_r: int
    k_r: int
    dtype: str

    def outer(self, dim: int, tile: int) -> int:
        return ceil_div(dim, tile)

    def packed_lhs_shape(self, m: int, k: int) -> tuple[int, int, int, int]:
        return (self.outer(m, self.m_r), self.outer(k, self.k_r), self.m_r, self.k_r)

    def packed_rhs_shape(self, k: int, n: int) -> tuple[int, int, int, int]:
        return (self.outer(n, self.n_r), self.outer(k, self.k_r), self.n_r, self.k_r)

    def packed_out_shape(self, m: int, n: int) -> tuple[int, int, int, int]:
        return (self.outer(m, self.m_r), self.outer(n, self.n_r), self.m_r, self.n_r)

    @property
    def chain_compatible(self) -> bool:
        """True iff an mmt4d output tile is a valid LHS input tile."""
        return self.n_r == self.k_r

    def flops(self, m: int, n: int, k: int) -> int:
        """FLOPs executed on packed (padded) operands."""
        mp = self.outer(m, self.m_r) * self.m_r
        np_ = self.outer(n, self.n_r) * self.n_r
        kp = self.outer(k, self.k_r) * self.k_r
        return 2 * mp * np_ * kp


def make_layout(policy: LayoutPolicy | str, hw: HardwareSpec,
                dtype: torch.dtype = torch.float32,
                kernel: str = "mxu_outer_product") -> PackedLayout:
    """Instantiate a packed layout from (policy, hardware, dtype)."""
    policy = LayoutPolicy(policy)
    if policy is LayoutPolicy.UNPACKED:
        return PackedLayout(policy=policy, kernel_name="plain_matmul", m_r=1,
                            n_r=1, k_r=1, dtype=_dtype_name(dtype))
    mk = MICROKERNELS["fixed_8x128x128" if policy is LayoutPolicy.FIXED
                      else kernel]
    m_r, n_r, k_r = mk.tiles(hw, dtype)
    return PackedLayout(policy=policy, kernel_name=mk.name, m_r=m_r, n_r=n_r,
                        k_r=k_r, dtype=_dtype_name(dtype))
