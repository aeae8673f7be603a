"""Packed linear layers — the single matmul entry point of the models.

``linear_apply`` packs its input (unless it already is a
:class:`PackedArray`) and runs mmt4d with the bias and activation fused;
unless asked to keep the result packed, mmt4d's epilogue writes it
unpacked (``unpack_to``), so no unpack kernel follows.  Under the
``unpacked`` policy it is a plain ``torch.matmul`` (the paper's baseline).
Weights live unpacked in the parameter tree; :func:`prepack_params` packs
them once for serving (paper §4.1: packing as a standalone operation on
the full operands).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.layout import LayoutPolicy, PackedLayout, make_layout
from repro_torch.core.mmt4d import Epilogue, matmul, mmt4d
from repro_torch.core import packing
from repro_torch.core.propagation import PackedArray, pack_activation

__all__ = ["MatmulContext", "linear_init", "linear_apply",
           "batched_linear_apply", "prepack_params", "PLAIN_PRODUCTS"]

# ``{"w"}`` leaves that no linear_apply reads, plain float32 products in
# both packages, which stay unpacked (and float32): mamba's ``dt_proj``
# (models/mamba.py) and the moe router (models/moe.py; the JAX package's
# prepack never packs it, a stacked [G, d, E] leaf)
PLAIN_PRODUCTS = frozenset({"dt_proj", "router"})


@dataclasses.dataclass(frozen=True)
class MatmulContext:
    """Layout policy + hardware descriptor threaded through model code.
    ``mesh_axes``, ``dp_size`` and ``tp_size`` mirror the JAX package's
    distributed fields and are no-ops in the port until it runs on a mesh."""

    policy: LayoutPolicy = LayoutPolicy.SCALABLE
    hw: Optional[HardwareSpec] = None
    propagate: bool = True
    kernel: str = "mxu_outer_product"
    mesh_axes: Optional[tuple] = None
    dp_size: int = 1
    tp_size: int = 1

    def __post_init__(self):
        # a policy given by name ("unpacked") is the enum member, so that
        # :attr:`packed` holds for it too
        object.__setattr__(self, "policy", LayoutPolicy(self.policy))

    def layout(self, dtype: torch.dtype) -> PackedLayout:
        if self.hw is None:
            raise ValueError("MatmulContext.hw is unset: query it with "
                             "repro_torch.core.hardware.query(device)")
        return make_layout(self.policy, self.hw, dtype, kernel=self.kernel)

    @property
    def packed(self) -> bool:
        return self.policy is not LayoutPolicy.UNPACKED


def linear_init(generator: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = False, dtype: torch.dtype = torch.float32,
                scale: Optional[float] = None) -> dict:
    """``{"w": [d_in, d_out]}`` drawn N(0, scale^2) from ``generator``, on
    the generator's device, ``scale`` defaulting to ``d_in ** -0.5``; plus
    a zero bias."""
    scale = (d_in ** -0.5) if scale is None else scale
    dev = generator.device
    w = torch.randn((d_in, d_out), generator=generator, device=dev) * scale
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=dev)
    return p


def _packed_weight(params: dict, layout: PackedLayout):
    """(B_pack, n): the prepacked weight when there is one."""
    if "w_pack" in params:
        return params["w_pack"], params["w_n"]
    w = params["w"]
    return packing.pack_rhs(w, layout), w.shape[-1]


def linear_apply(params: dict, x: Union[torch.Tensor, PackedArray],
                 ctx: MatmulContext, *, activation: Optional[str] = None,
                 keep_packed: bool = False) -> Union[torch.Tensor, PackedArray]:
    """y = act(x @ W + b).  x: [..., M, K] tensor or PackedArray; returns
    [..., M, N] (a PackedArray when ``keep_packed``).

    The bias and activation go into the mmt4d kernel, which applies them
    in float32 before its one cast, as the Pallas kernel does.  The JAX
    model path casts first and applies them after; the two orders agree in
    float32 and round differently in bfloat16."""
    epi = Epilogue(activation=activation)
    if not ctx.packed:
        if isinstance(x, PackedArray):
            raise TypeError("the unpacked policy takes a plain tensor, not "
                            "a PackedArray")
        return matmul(x, params["w"], ctx.layout(x.dtype), epilogue=epi,
                      bias=params.get("b"))
    if isinstance(x, PackedArray):
        layout, a_pack, m = x.layout, x.data, x.m
    else:
        layout = ctx.layout(x.dtype)
        a_pack, m = packing.pack_lhs(x, layout), x.shape[-2]
    b_pack, n = _packed_weight(params, layout)
    packed_out = keep_packed and ctx.propagate and layout.chain_compatible
    c = mmt4d(a_pack, b_pack, epi.bias_pack(params.get("b"), layout),
              activation=epi.activation, unpack_to=None if packed_out else (m, n))
    if packed_out:
        return PackedArray(data=c, m=m, k=n, layout=layout)
    if keep_packed and ctx.propagate:
        # output tile != input tile: round-trip through the plain domain
        return pack_activation(c, layout)
    return c


def batched_linear_apply(params: dict, x: Union[torch.Tensor, PackedArray],
                         ctx: MatmulContext, *,
                         activation: Optional[str] = None) -> torch.Tensor:
    """Expert-stacked linear: x [E, C, K] (or its PackedArray, packed
    [E, C_o, K_o, m_r, k_r]) @ w [E, K, N] -> [E, C, N], the JAX package's
    ``batched_linear_apply``: the paper's 2-D layouts mapped over the
    leading expert dim.  One mmt4d launch over every expert (the expert
    dim in the kernel's grid), the bias [E, N] and activation fused, the
    result stored unpacked.  Differentiable as :func:`linear_apply` is:
    through the pack of x and of w, and mmt4d's gradient kernels over
    every expert.  Under the ``unpacked`` policy a batched
    ``torch.matmul``."""
    epi = Epilogue(activation=activation)
    if not ctx.packed:
        if isinstance(x, PackedArray):
            raise TypeError("the unpacked policy takes a plain tensor, not "
                            "a PackedArray")
        return matmul(x, params["w"], ctx.layout(x.dtype), epilogue=epi,
                      bias=params.get("b"))
    if isinstance(x, PackedArray):
        layout, a_pack, m = x.layout, x.data, x.m
    else:
        layout = ctx.layout(x.dtype)
        a_pack, m = packing.pack_lhs(x, layout), x.shape[-2]
    b_pack, n = _packed_weight(params, layout)
    return mmt4d(a_pack, b_pack, epi.bias_pack(params.get("b"), layout),
                 activation=epi.activation, unpack_to=(m, n))


def prepack_params(params, ctx: MatmulContext, dtype: Optional[torch.dtype] = None,
                   *, consume: bool = False):
    """Serving-path weight packing: every linear's ``w`` [..., K, N] becomes
    ``w_pack`` [..., N_o, K_o, n_r, k_r] plus ``w_n = N`` (a plain int).

    Unlike the JAX package, which packs only 2-D weights and leaves the
    stacked ``[G, K, N]`` layer weights to be packed inside each jitted step,
    the port packs the stacked weights too (the moe experts' ``[G, E, K,
    N]`` among them): it runs eagerly, with no compiler to hoist a per-step
    pack of a constant.  A dict under a key of :data:`PLAIN_PRODUCTS` is a
    weight no ``linear_apply`` reads, and is left as it is.  A tree that is
    already packed comes back as it is.

    ``consume``: each ``w`` is removed from ``params`` once its pack is
    made, so the unpacked and the packed tree never exist whole side by
    side (a model whose weights fill most of the card's memory); the
    caller gives up ``params``."""
    if not ctx.packed:
        return params

    def rec(p):
        if not isinstance(p, dict):
            return p
        if isinstance(p.get("w"), torch.Tensor) and p["w"].ndim >= 2:
            w = p["w"] if dtype is None else p["w"].to(dtype)
            out = {k: rec(v) for k, v in p.items() if k != "w"}
            out["w_pack"] = packing.pack_rhs(w, ctx.layout(w.dtype))
            out["w_n"] = w.shape[-1]
            if consume:
                del p["w"], w
            return out
        return {k: v if k in PLAIN_PRODUCTS else rec(v) for k, v in p.items()}

    return rec(params)
