"""Packed-layout propagation (paper §4.3 "Fusion and layout propagation").

:class:`PackedArray` carries an activation in packed layout so pointwise
ops, residual adds and normalizations run directly on the tiles, and a
chain ``linear -> norm -> act -> linear`` never unpacks in between.
Packed tiles are zero-padded: feature reductions sum zeros, and divide by
the true feature count ``k``.  Ops that are not padding-neutral (softmax,
top-k) must unpack first; PackedArray does not implement them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.layout import PackedLayout
from repro_torch.core import packing

__all__ = ["PackedArray", "pack_activation"]


@dataclasses.dataclass
class PackedArray:
    """``data``: [..., M_o, K_o, m_r, k_r], the packed form of a logical
    [..., m, k] tensor (m = tokens, k = features)."""

    data: torch.Tensor
    m: int
    k: int
    layout: PackedLayout

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def lead_shape(self) -> torch.Size:
        """The leading (batch) dims ahead of ``[M_o, K_o, m_r, k_r]``."""
        return self.data.shape[:-4]

    def astype(self, dtype: torch.dtype) -> "PackedArray":
        return self._with(self.data.to(dtype))

    def _with(self, data: torch.Tensor) -> "PackedArray":
        return PackedArray(data=data, m=self.m, k=self.k, layout=self.layout)

    # -- pointwise ops in the packed domain --
    def elementwise(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "PackedArray":
        """``fn`` on the tiles.  It must map 0 to 0 where the padding has
        to stay zero (a consumer's reduction sums it)."""
        return self._with(fn(self.data))

    def __add__(self, other: "PackedArray") -> "PackedArray":
        if not isinstance(other, PackedArray) or other.layout != self.layout:
            raise TypeError("PackedArray + needs a PackedArray of the same layout")
        return self._with(self.data + other.data)

    def __mul__(self, other) -> "PackedArray":
        if isinstance(other, PackedArray):
            return self._with(self.data * other.data)
        return self._with(self.data * other)

    def _feature_vec(self, v: torch.Tensor) -> torch.Tensor:
        """[K] -> [K_o, 1, k_r], broadcasting over M_o and m_r."""
        k_o, k_r = self.data.shape[-3], self.data.shape[-1]
        vp = packing.pad_to_tiles(v[None, :], 1, self.layout.k_r).reshape(k_o, k_r)
        return vp[:, None, :]

    def scale_features(self, v: torch.Tensor) -> "PackedArray":
        """x * v with v an unpacked per-feature vector (a norm gain)."""
        return self._with(self.data * self._feature_vec(v))

    def add_features(self, v: torch.Tensor) -> "PackedArray":
        """x + v; also writes the feature padding, which consumers ignore
        (their RHS rows are zero there)."""
        return self._with(self.data + self._feature_vec(v))

    # -- reductions over the (padded) feature dim, padding-corrected --
    @staticmethod
    def _sum_features(x: torch.Tensor) -> torch.Tensor:
        return x.sum(dim=(-3, -1), keepdim=True)      # over (K_o, k_r)

    def rms_norm(self, gain: Optional[torch.Tensor], eps: float = 1e-6,
                 upcast: bool = True) -> "PackedArray":
        x = self.data.float() if upcast else self.data
        ms = self._sum_features(x * x) / self.k       # true feature count
        out = self._with((x * torch.rsqrt(ms + eps)).to(self.dtype))
        if gain is not None:
            out = out.scale_features(gain.to(self.dtype))
        return out

    def layer_norm(self, gain: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], eps: float = 1e-5,
                   upcast: bool = True) -> "PackedArray":
        """LayerNorm with the centred value re-masked so the feature
        padding stays zero."""
        x = self.data.float() if upcast else self.data
        mask = self._feature_mask()
        mean = self._sum_features(x) / self.k
        xc = (x - mean) * mask
        var = self._sum_features(xc * xc) / self.k
        out = self._with((xc * torch.rsqrt(var + eps)).to(self.dtype))
        if gain is not None:
            out = out.scale_features(gain.to(self.dtype))
        if bias is not None:
            out = out.add_features(bias.to(self.dtype))
            out = out._with(out.data * mask.to(out.dtype))
        return out

    def _feature_mask(self) -> torch.Tensor:
        """[K_o, 1, k_r] mask of the true (non-padding) feature slots."""
        k_o, k_r = self.data.shape[-3], self.data.shape[-1]
        idx = torch.arange(k_o * k_r, device=self.data.device).reshape(k_o, k_r)
        return (idx < self.k).float()[:, None, :]

    # -- boundary ops --
    def unpack(self) -> torch.Tensor:
        return packing.unpack_lhs(self.data, self.m, self.k)


def pack_activation(x: torch.Tensor, layout: PackedLayout) -> PackedArray:
    """Pack an activation [..., M, K] into LHS layout (tokens x features)."""
    return PackedArray(data=packing.pack_lhs(x, layout), m=x.shape[-2],
                       k=x.shape[-1], layout=layout)
