"""Packed linear layers — the single matmul entry point of the models.

``linear_apply`` packs its input (unless it already is a
:class:`PackedArray`) and runs mmt4d with the bias and activation fused;
unless asked to keep the result packed, mmt4d's epilogue writes it
unpacked (``unpack_to``), so no unpack kernel follows.  Under the
``unpacked`` policy it is a plain ``torch.matmul`` (the paper's baseline).
Weights live unpacked in the parameter tree; :func:`prepack_params` packs
them once for serving (paper §4.1: packing as a standalone operation on
the full operands).

Across the ranks of a mesh's ``model`` axis (``MatmulContext.tp``) a
weight the sharding rules split holds its rank's whole tiles and records
the cut as ``w_split`` (:mod:`repro_torch.distributed.sharding`), and
``linear_apply`` runs the JAX package's Megatron products on it:

- column-parallel (``("col", lo, hi, N)``): the rank's output tiles
  ``[lo, hi)`` with the bias and activation fused, then gathered whole
  on every rank (:meth:`~repro_torch.distributed.comm.ModelAxis.gather`),
  or kept the rank's (``gather=False``): for a row-parallel product next,
  or to be gathered with others in one collective (:func:`gather_columns`);
- row-parallel (``("row", lo, hi, K_o)``): the rank's contraction tiles,
  taken from a whole input or given as the rank's own, into a float32
  partial (mmt4d's ``partial``: no epilogue, no cast), summed over the
  ranks; the bias and the activation are applied once, to the sum, in
  float32, then one cast, as the kernel's epilogue does.

Under autograd (training across ranks) the same products are
differentiable: the gather's gradient is the rank's slice, the sum's
passes through, the float32 partial's runs mmt4d's gradient kernels over
the rank's K tiles, and a replicated tensor that a rank slices (a whole
input of a row-parallel product, the bias of a column-parallel one) first
enters the region (:meth:`~repro_torch.distributed.comm.MeshAxis.enter`),
so that its gradient is summed over the ranks.  The input of a
column-parallel product enters in the caller (:func:`tp_enter`), once for
every product that reads it.
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
from repro_torch.kernels.mmt4d.ref import ACTIVATIONS

__all__ = ["MatmulContext", "linear_init", "linear_apply", "gather_columns",
           "tp_enter", "batched_linear_apply", "prepack_params", "PLAIN_PRODUCTS"]

# ``{"w"}`` leaves that no linear_apply reads, plain float32 products in
# both packages, which stay unpacked (and float32): mamba's ``dt_proj``
# (models/mamba.py) and the moe router (models/moe.py; the JAX package's
# prepack never packs it, a stacked [G, d, E] leaf)
PLAIN_PRODUCTS = frozenset({"dt_proj", "router"})


@dataclasses.dataclass(frozen=True)
class MatmulContext:
    """Layout policy + hardware descriptor threaded through model code.

    The mesh fields are the JAX package's: ``mesh_axes`` (the mesh's axis
    names, None without a mesh), ``dp_size`` (pod x data), ``tp_size``
    ("model") and ``moe_local`` (per-data-shard moe dispatch,
    ``RunConfig.moe_local_dispatch``); ``dp_local`` says which view the
    process runs.  False is the global view (no mesh, or an
    ``AbstractMesh``): one process holds every token of the step and the
    moe layer blocks them into ``dp_size`` dispatch blocks itself, as the
    JAX package under GSPMD.  True is a rank of a ``DeviceMesh``: the
    process holds its own data shard's tokens, which are one block, and
    ``dp`` (below) is where the moe layer sums its aux losses' terms.

    ``tp``: the ranks of the mesh's ``model`` axis this process is one of
    (:class:`~repro_torch.distributed.comm.ModelAxis`: its rank and
    process group), None on one rank: the collectives of the
    tensor-parallel products (module docstring).  ``dp``: its data ranks
    (:class:`~repro_torch.distributed.comm.DataAxis`), None on one: the
    moe layer's aux losses, FSDP's gathers and the train step's
    reductions."""

    policy: LayoutPolicy = LayoutPolicy.SCALABLE
    hw: Optional[HardwareSpec] = None
    propagate: bool = True
    kernel: str = "mxu_outer_product"
    mesh_axes: Optional[tuple] = None
    dp_size: int = 1
    tp_size: int = 1
    moe_local: bool = False
    dp_local: bool = False
    tp: Optional[object] = dataclasses.field(default=None, compare=False)
    dp: Optional[object] = dataclasses.field(default=None, compare=False)

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

    @property
    def tp_axis(self) -> Optional[str]:
        if self.mesh_axes and "model" in self.mesh_axes:
            return "model"
        return None

    @property
    def dp_axes(self) -> tuple:
        return tuple(a for a in ("pod", "data") if self.mesh_axes
                     and a in self.mesh_axes)


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
                 keep_packed: bool = False, tp: Optional[str] = None,
                 gather: bool = True) -> Union[torch.Tensor, PackedArray]:
    """y = act(x @ W + b).  x: [..., M, K] tensor or PackedArray; returns
    [..., M, N] (a PackedArray when ``keep_packed``).

    The bias and activation go into the mmt4d kernel, which applies them
    in float32 before its one cast, as the Pallas kernel does.  The JAX
    model path casts first and applies them after; the two orders agree in
    float32 and round differently in bfloat16.

    ``tp`` ("col" or "row", the JAX package's): how the product splits
    across the ranks of ``ctx.tp``; the weight's ``w_split`` says what
    this rank holds (none: the rules left the weight whole, and the
    product runs whole on every rank), and a split of the other kind is
    refused.  ``gather=False`` keeps a column-parallel result the rank's
    own (its output tiles ``[lo, hi)``), for a row-parallel product."""
    split = params.get("w_split")
    if split is not None:
        if ctx.tp is None:
            raise ValueError("a weight split across ranks (w_split) on a "
                             "context without a model axis (ctx.tp)")
        if tp is not None and split[0] != tp:
            raise ValueError(f"a {split[0]}-parallel weight asked for a "
                             f"{tp}-parallel product")
    epi = Epilogue(activation=activation)
    if not ctx.packed:
        if isinstance(x, PackedArray):
            raise TypeError("the unpacked policy takes a plain tensor, not "
                            "a PackedArray")
        if split is not None:
            raise NotImplementedError("the unpacked policy across ranks: the "
                                      "port splits packed weights by tiles")
        return matmul(x, params["w"], ctx.layout(x.dtype), epilogue=epi,
                      bias=params.get("b"))
    if isinstance(x, PackedArray):
        layout, a_pack, m = x.layout, x.data, x.m
    else:
        layout = ctx.layout(x.dtype)
        a_pack, m = None, x.shape[-2]
    b_pack, n = _packed_weight(params, layout)
    packed_out = keep_packed and ctx.propagate and layout.chain_compatible
    if split is not None and split[0] == "row":
        c = _row_parallel(params, x, a_pack, b_pack, n, m, layout, split, ctx,
                          epi, packed_out)
    else:
        if a_pack is None:
            a_pack = packing.pack_lhs(x, layout)
        bias = params.get("b")
        if split is not None and bias is not None:      # the rank's columns
            bias = ctx.tp.enter(bias)[..., split[1] * layout.n_r:
                                      split[1] * layout.n_r + n]
        if n == 0:                                      # no tiles on this rank
            c = a_pack.new_zeros((*a_pack.shape[:-3], 0, layout.m_r, layout.n_r)
                                 if packed_out else (*a_pack.shape[:-4], m, 0))
        else:
            c = mmt4d(a_pack, b_pack, epi.bias_pack(bias, layout),
                      activation=epi.activation,
                      unpack_to=None if packed_out else (m, n))
        if split is not None:
            _, lo, _, total = split
            if gather:
                c = (ctx.tp.gather(c, -3, lo, -(-total // layout.n_r))
                     if packed_out else
                     ctx.tp.gather(c, -1, min(lo * layout.n_r, total), total))
                n = total
    if packed_out:
        return PackedArray(data=c, m=m, k=n, layout=layout)
    if keep_packed and ctx.propagate:
        # output tile != input tile: round-trip through the plain domain
        return pack_activation(c, layout)
    return c


def tp_enter(ctx: MatmulContext, x: Union[torch.Tensor, PackedArray]):
    """``x`` (a plain tensor or a PackedArray), replicated on the ranks of
    ``ctx.tp``, as it enters column-parallel products: the identity, whose
    gradient is summed over the ranks (each rank's products saw their own
    columns only).  Without a model axis, or a gradient, ``x`` itself."""
    if ctx.tp is None:
        return x
    if isinstance(x, PackedArray):
        data = ctx.tp.enter(x.data)
        return x if data is x.data else x._with(data)
    return ctx.tp.enter(x)


def gather_columns(ctx: MatmulContext, pairs: list) -> list:
    """The whole results of column-parallel products run with
    ``gather=False``: ``pairs`` is ``[(params, y)]``, each ``y`` [..., m,
    n] the rank's output columns (unpacked) of the linear ``params``.
    All of them are gathered by one collective (one all-reduce of their
    concatenation: ranks that share a card or a host pay per collective
    more than per byte); a result the rules left whole is whole already."""
    cut = [i for i, (p, _) in enumerate(pairs) if "w_split" in p]
    out = [y for _, y in pairs]
    if ctx.tp is None or not cut:
        return out
    parts = []
    for i in cut:
        p, y = pairs[i]
        _, lo, _, total = p["w_split"]
        parts.append((y, min(lo * ctx.layout(y.dtype).n_r, total), total))
    for i, whole in zip(cut, ctx.tp.gather_parts(parts)):
        out[i] = whole
    return out


def _row_parallel(params, x, a_pack, b_pack, n, m, layout, split, ctx, epi,
                  packed_out):
    """The rank's share of a row-parallel product, summed over the ranks,
    then the bias and activation in float32 and one cast (module
    docstring).  The input is the whole x or the rank's own K tiles."""
    _, lo, hi, k_tiles = split
    k_r = layout.k_r
    dtype = x.dtype
    if a_pack is None:                          # an unpacked input
        tiles = -(-x.shape[-1] // k_r)
        if tiles == k_tiles and hi - lo != k_tiles:
            x = ctx.tp.enter(x)[..., lo * k_r:hi * k_r]   # the rank's columns
        elif tiles != hi - lo:
            raise ValueError(f"a row-parallel input of {x.shape[-1]} columns: "
                             f"neither the whole ({k_tiles} tiles) nor the "
                             f"rank's {hi - lo}")
        a_pack = packing.pack_lhs(x, layout)
    elif a_pack.shape[-3] == k_tiles and hi - lo != k_tiles:
        a_pack = ctx.tp.enter(a_pack)[..., lo:hi, :, :].contiguous()
    elif a_pack.shape[-3] != hi - lo:
        raise ValueError(f"a row-parallel packed input of {a_pack.shape[-3]} "
                         f"K tiles: neither the whole ({k_tiles}) nor the "
                         f"rank's {hi - lo}")
    unpack_to = None if packed_out else (m, n)
    if hi == lo:                                # no tiles on this rank: zeros
        shape = (layout.packed_out_shape(m, n) if packed_out else (m, n))
        c = torch.zeros((*a_pack.shape[:-4], *shape), dtype=torch.float32,
                        device=a_pack.device)
    else:
        c = mmt4d(a_pack, b_pack, unpack_to=unpack_to, partial=True)
    c = ctx.tp.reduce(c) if c.requires_grad else ctx.tp.sum_(c)
    bias = params.get("b")
    if bias is not None:
        if packed_out:
            c = c + epi.bias_pack(bias, layout)[:, None, :].float()
        else:
            c = c + bias.float()
    return ACTIVATIONS[epi.activation](c).to(dtype)


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
    if "w_split" in params:
        raise NotImplementedError("an expert stack split across ranks: the "
                                  "moe family across ranks is ROADMAP A13.3")
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
