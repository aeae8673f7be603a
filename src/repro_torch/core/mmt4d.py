"""Packed matrix multiplication (``linalg.mmt4d``) with fused epilogues.

    C_pack[m_o, n_o, :, :] = act(sum_k A_pack[m_o, k_o] @ B_pack[n_o, k_o]^T + bias)

runs in the mmt4d kernel (``repro_torch.kernels.mmt4d``) for CUDA tensors
and its plain version for CPU tensors.  :class:`Epilogue` carries the bias
and activation that the kernel applies in float32 before its one cast.

Under autograd :func:`mmt4d` is a ``torch.autograd.Function`` whose
backward launches mmt4d's two gradient kernels (``mmt4d_dgrad``,
``mmt4d_wgrad``, which also sums the bias gradient): it saves the packed
operands, and with ``unpack_to`` packs the incoming gradient first (the
gradient of the unpacked store is its zero-padded pack).  With an
activation the backward needs the pre-activation Z.  It recomputes Z (one
more mmt4d launch, without the activation, stored packed) rather than
saving it: no [tokens, d_ff] tensor is kept per activated linear, and the
recomputed Z is rounded to the compute dtype, which is the Z at which the
JAX package takes its gradient (it casts before the activation; the port's
forward applies the activation in float32 before its one cast; in float32
the two agree).  Tile padding needs nothing of its own: padding rows and
columns of the packed operands and of the packed gradient are zero, so
the padding of each gradient comes out zero and leaks into nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.layout import LayoutPolicy, PackedLayout
from repro_torch.core import packing
from repro_torch.kernels.mmt4d.ops import mmt4d as mmt4d_kernel
from repro_torch.kernels.mmt4d.ops import mmt4d_dgrad, mmt4d_wgrad
from repro_torch.kernels.mmt4d.ref import ACTIVATIONS

__all__ = ["mmt4d", "Epilogue", "packed_matmul", "matmul"]


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Pointwise epilogue fused into the packed-domain matmul: an optional
    bias add and an activation named as in ``kernels/mmt4d``
    (None | "gelu" (tanh) | "silu" | "relu" | "tanh")."""

    activation: Optional[str] = None

    def bias_pack(self, bias: Optional[torch.Tensor],
                  layout: PackedLayout) -> Optional[torch.Tensor]:
        """An unpacked ``[..., N]`` bias tiled along n_r: ``[..., N_o,
        n_r]`` (an expert-batched bias [E, N]: [E, N_o, n_r]; None without
        a bias)."""
        if bias is None:
            return None
        bp = packing.pad_to_tiles(bias[..., None, :], 1, layout.n_r)
        return bp.reshape(*bias.shape[:-1], -1, layout.n_r).contiguous()

    def apply_unpacked(self, c: torch.Tensor,
                       bias: Optional[torch.Tensor]) -> torch.Tensor:
        """The epilogue of a plain product ``c`` (already cast), in the
        JAX package's order: bias, then the activation."""
        if bias is not None:
            c = c + bias
        return ACTIVATIONS[self.activation](c)


def mmt4d(a_pack: torch.Tensor, b_pack: torch.Tensor,
          bias_pack: Optional[torch.Tensor] = None, *,
          activation: Optional[str] = None,
          unpack_to: Optional[tuple] = None,
          partial: bool = False) -> torch.Tensor:
    """a_pack [..., M_o, K_o, m_r, k_r], b_pack [N_o, K_o, n_r, k_r] ->
    C_pack [..., M_o, N_o, m_r, n_r] in a_pack's dtype, or with
    ``unpack_to=(m, n)`` C [..., m, n] (the kernel's unpacked store: the
    result leaves the packed domain without an unpack launch).

    Leading LHS dims fold into M_o (a free reshape of contiguous packed
    tiles, done by the kernel wrapper), as the JAX package's
    ``core/mmt4d.py`` does for a plain weight.  An expert-batched b_pack
    [E, N_o, K_o, n_r, k_r] (the MoE family's experts) takes a_pack [E,
    M_o, K_o, m_r, k_r] and bias_pack [E, N_o, n_r]: one launch over every
    expert, and one of each gradient kernel over every expert.

    ``partial``: the float32 sums without the epilogue or the cast, a
    rank's share of a row-parallel product across ranks.  Its gradient is
    the plain product's, with no epilogue: mmt4d_dgrad and mmt4d_wgrad
    over the rank's K tiles, the float32 dZ first cast to the operands'
    dtype, the dtype the non-partial path hands the gradient kernels."""
    tensors = (a_pack, b_pack) + (() if bias_pack is None else (bias_pack,))
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tensors)
    if partial:
        if grad:
            if bias_pack is not None or activation is not None:
                raise ValueError("mmt4d: a partial takes no epilogue")
            return _Mmt4dFn.apply(a_pack, b_pack, None, None, unpack_to, True)
        return mmt4d_kernel(a_pack, b_pack, activation=activation,
                            unpack_to=unpack_to, partial=True)
    if grad:
        return _Mmt4dFn.apply(a_pack, b_pack, bias_pack, activation, unpack_to,
                              False)
    return mmt4d_kernel(a_pack, b_pack, bias_pack, activation=activation,
                        unpack_to=unpack_to)


class _Mmt4dFn(torch.autograd.Function):
    """mmt4d with its gradients: dA by ``mmt4d_dgrad``, dB and the bias
    gradient by ``mmt4d_wgrad`` (one launch each, on the card; for an
    expert-batched B_pack each over every expert).  ``partial``: the
    float32 partial's (no epilogue), whose float32 dZ is cast to the
    operands' dtype first."""

    @staticmethod
    def forward(ctx, a_pack, b_pack, bias_pack, activation, unpack_to, partial):
        ctx.save_for_backward(a_pack, b_pack, bias_pack)
        ctx.activation, ctx.unpack_to = activation, unpack_to
        if partial:
            return mmt4d_kernel(a_pack, b_pack, unpack_to=unpack_to,
                                partial=True)
        return mmt4d_kernel(a_pack, b_pack, bias_pack, activation=activation,
                            unpack_to=unpack_to)

    @staticmethod
    def backward(ctx, grad):
        a_pack, b_pack, bias_pack = ctx.saved_tensors
        act = ctx.activation
        grad = grad.to(a_pack.dtype)
        if ctx.unpack_to is None:
            dz = grad.contiguous()
        else:                                  # the unpacked store's transpose
            dz = packing.repack(grad, a_pack.shape[-4], b_pack.shape[-4],
                                a_pack.shape[-2], b_pack.shape[-2])
        z = None
        if act is not None:
            z = mmt4d_kernel(a_pack, b_pack, bias_pack)
        da = db = dbias = None
        need_a, need_b, need_bias = ctx.needs_input_grad[:3]
        if need_a:
            da = mmt4d_dgrad(dz, b_pack, z, activation=act)
        if need_b or need_bias:
            db, dbias = mmt4d_wgrad(dz, a_pack, z, activation=act,
                                    bias=need_bias, experts=b_pack.ndim == 5)
        return da, db, dbias, None, None, None


def packed_matmul(a: torch.Tensor, b: torch.Tensor, layout: PackedLayout, *,
                  epilogue: Epilogue = Epilogue(),
                  bias: Optional[torch.Tensor] = None,
                  a_is_packed: bool = False,
                  keep_packed: bool = False) -> torch.Tensor:
    """pack -> mmt4d (epilogue fused) -> unpack, the paper's decomposition.
    a [..., M, K] (or A_pack with ``a_is_packed``), b [K, N]; returns
    C [..., M, N], or C_pack with ``keep_packed``.  The unpack is mmt4d's
    unpacked store; an A_pack's M is its padded M_o·m_r."""
    a_pack = a if a_is_packed else packing.pack_lhs(a, layout)
    m = a_pack.shape[-4] * a_pack.shape[-2] if a_is_packed else a.shape[-2]
    n = b.shape[-1]
    return mmt4d(a_pack, packing.pack_rhs(b, layout),
                 epilogue.bias_pack(bias, layout),
                 activation=epilogue.activation,
                 unpack_to=None if keep_packed else (m, n))


def matmul(a: torch.Tensor, b: torch.Tensor, layout: PackedLayout, *,
           epilogue: Epilogue = Epilogue(),
           bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Policy-dispatched matmul.  Under ``unpacked`` a plain
    ``torch.matmul`` (the JAX package's ``jnp.matmul``, which no Pallas
    kernel computes either) with the epilogue after it; otherwise
    :func:`packed_matmul`."""
    if layout.policy is LayoutPolicy.UNPACKED:
        return epilogue.apply_unpacked(torch.matmul(a, b), bias)
    return packed_matmul(a, b, layout, epilogue=epilogue, bias=bias)
