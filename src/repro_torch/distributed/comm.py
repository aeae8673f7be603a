"""The collectives across ranks: the ``model`` and ``data`` axes of a mesh.

The JAX package has no counterpart: under GSPMD its partitioner inserts
the collectives of a sharded program.  The port computes each rank's
tensors eagerly, so the model and training code ask for them here, on the
:class:`MeshAxis` its context carries (``MatmulContext.tp``, the
:class:`ModelAxis`; ``MatmulContext.dp``, the :class:`DataAxis`):

- :meth:`MeshAxis.sum_`: a sum across ranks, in place (the float32
  partials of a row-parallel product when no gradient is taken);
- :meth:`MeshAxis.gather`: each rank's slice of one dim put back whole on
  every rank (the outputs of a column-parallel product, the ranks' shares
  of the flash-decode; :meth:`~MeshAxis.gather_parts` several at once,
  in one collective).  The gather is an
  ``all_reduce`` sum into a zeroed buffer holding the rank's slice at its
  offset: every element has one contributor, so the sum is exact, and the
  one code path serves gloo, which takes CUDA tensors in ``all_reduce``
  and ``broadcast`` but not in ``all_gather``, as it serves NCCL;
- :meth:`MeshAxis.max`: the elementwise max over the ranks (an
  ``all_reduce`` with ``MAX``);
- :class:`SeqAxis`: the ranks a dense decode cache's sequence is cut
  over (``cache_specs``: ``model`` where the batch divides the data
  ranks, else the data and model dims flattened), over which the dense
  flash-decode combines its shares (``models/attention.py:combine_ranks``
  takes any axis);
- the reduce-scatter (the sum over the ranks, of which each keeps its
  slice) is an all-reduce, then the slice, for gloo's sake too: the
  backward of :meth:`~MeshAxis.gather_shards`.

Every collective refuses a tensor that is not contiguous: gloo reduces a
strided view's storage, not its elements, and raises nothing.

Under autograd (training across ranks) each collective is paired with its
transpose, the Megatron operators and FSDP's:

==========================================  ==============  ======================
operation                                   forward         backward
==========================================  ==============  ======================
:meth:`~MeshAxis.enter`: a replicated       identity        sum over the axis
input entering a Megatron region
:meth:`~MeshAxis.gather`: the column        gather          the rank's slice
product's gather
:meth:`~MeshAxis.reduce`: the row           sum             identity
product's sum of partials
:meth:`~MeshAxis.gather_shards`: FSDP's     gather over     reduce-scatter into
use of a weight                             ``data``        the rank's shard
==========================================  ==============  ======================

Backends (:func:`pick_backend`): gloo on the CPU and where ranks share a
card; NCCL only where each rank has a card of its own.  A gloo collective
is host work that a CUDA graph cannot capture, so steps across ranks run
uncaptured (``models/model.py:capture_graph`` refuses them).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["MeshAxis", "ModelAxis", "DataAxis", "SeqAxis", "pick_backend"]


def pick_backend(device_type: str, world_size: int) -> str:
    """``"nccl"`` where every rank has a card of its own (``world_size``
    ranks on a host with at least as many cards), else ``"gloo"``: the CPU,
    or ranks that share a card (NCCL refuses two ranks on one device)."""
    if torch.device(device_type).type == "cuda" \
            and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def _contiguous(t: torch.Tensor, what: str) -> None:
    if not t.is_contiguous():
        raise ValueError(f"{what} of a non-contiguous tensor (shape "
                         f"{tuple(t.shape)}, strides {t.stride()}): gloo would "
                         f"reduce its storage, not its elements")


class MeshAxis:
    """The ranks of one axis of a mesh as the model code sees them:
    ``size`` ranks, this process's ``rank`` among them, and the process
    group the collectives run over (None for one rank: every collective is
    then the identity).  ``calls`` and ``bytes`` count the collectives
    made and the bytes this rank put in."""

    name = "model"

    def __init__(self, group, rank: int, size: int):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a {self.name} axis of {size}")
        self.group, self.rank, self.size = group, rank, size
        self.backend = None if group is None else dist.get_backend(group)
        self.calls, self.bytes = 0, 0

    # ------------------------------------------------------- plain collectives

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` (contiguous) over the ranks in place; returns it."""
        _contiguous(t, f"a sum over the {self.name} axis")
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
            self.calls += 1
            self.bytes += t.numel() * t.element_size()
        return t

    def _gather(self, local: torch.Tensor, dim: int, lo: int,
                total: int) -> torch.Tensor:
        _contiguous(local, f"a gather over the {self.name} axis")
        dim = dim % local.ndim
        shape = list(local.shape)
        shape[dim] = total
        out = local.new_zeros(shape)
        if local.shape[dim]:                # a rank may hold none of it
            out.narrow(dim, lo, local.shape[dim]).copy_(local)
        return self.sum_(out)

    def _gather_parts(self, parts: list) -> list:
        for local, _, _ in parts:
            _contiguous(local, f"a gather over the {self.name} axis")
        totals = [total for _, _, total in parts]
        lead = parts[0][0].shape[:-1]
        out = parts[0][0].new_zeros((*lead, sum(totals)))
        off = 0
        for (local, lo, total) in parts:
            if local.shape[-1]:
                out[..., off + lo:off + lo + local.shape[-1]].copy_(local)
            off += total
        return list(self.sum_(out).split(totals, dim=-1))

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` (contiguous) over the ranks, a new
        tensor on every rank; no gradient."""
        _contiguous(t, f"a max over the {self.name} axis")
        if self.group is None:
            return t
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=self.group)
        self.calls += 1
        self.bytes += out.numel() * out.element_size()
        return out

    # -------------------------------------------------- under autograd too

    def reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, a new tensor (the row product's
        sum of partials); its gradient passes through unchanged, since
        what follows the sum is the same on every rank."""
        _contiguous(t, f"a sum over the {self.name} axis")
        if self.group is None:
            return t
        if torch.is_grad_enabled() and t.requires_grad:
            return _Sum.apply(t, self)
        return self.sum_(t.clone(memory_format=torch.contiguous_format))

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        """``t``, replicated on the ranks, as it enters a region where each
        rank computes its share from it: the identity, whose gradient is
        summed over the ranks (each rank's is the part its share saw)."""
        if self.group is None or not (torch.is_grad_enabled() and t.requires_grad):
            return t
        return _Enter.apply(t, self)

    def gather(self, local: torch.Tensor, dim: int, lo: int,
               total: int) -> torch.Tensor:
        """The whole tensor of which ``local`` is the slice ``[lo, lo +
        local.shape[dim])`` of dim ``dim`` (of extent ``total``), on every
        rank; the ranks' slices must tile ``[0, total)``.  Its gradient is
        the rank's slice of the whole one's."""
        if torch.is_grad_enabled() and local.requires_grad \
                and self.group is not None:
            return _Gather.apply(local, self, dim % local.ndim, lo, total)
        return self._gather(local, dim, lo, total)

    def gather_parts(self, parts: list) -> list:
        """:meth:`gather` of several tensors along their last dim in one
        collective: ``parts`` is ``[(local, lo, total)]``, tensors alike
        but for the last dim; returns each whole."""
        if torch.is_grad_enabled() and self.group is not None \
                and any(t.requires_grad for t, _, _ in parts):
            meta = [(lo, total, t.shape[-1]) for t, lo, total in parts]
            return list(_GatherParts.apply(self, meta, *(t for t, _, _ in parts)))
        return self._gather_parts(parts)

    def gather_shards(self, locals_: list, cuts: list) -> list:
        """FSDP's use of sharded weights: each ``locals_[i]`` is this
        rank's slice ``[lo, lo + n)`` of dim ``dim`` of a tensor of extent
        ``total`` there (``cuts[i] = (dim, lo, total)``); returns each
        whole, on every rank, all in one collective (the tensors must share
        a dtype).  Its gradient is the whole gradient summed over the ranks
        (each rank's batch shard gave its own), of which each rank keeps
        its slice: the reduce-scatter into the rank's shard."""
        if self.group is None or not locals_:
            return list(locals_)
        return list(_GatherShards.apply(self, cuts, *locals_))

    @classmethod
    def _over(cls, mesh, axes: tuple):
        """The axis over the dims ``axes`` of a ``DeviceMesh``, those of one
        rank left out, flattened major to minor in the mesh's order:
        ``rank`` is this process's index there; one group of all of them.
        None where they hold one rank."""
        names = list(mesh.mesh_dim_names or ())
        sizes = dict(zip(names, mesh.mesh.shape))
        dims = [a for a in names if a in axes and sizes[a] > 1]
        if not dims:
            return None
        coord = dict(zip(names, mesh.get_coordinate()))
        rank = 0
        for a in dims:
            rank = rank * sizes[a] + coord[a]
        group = (mesh.get_group(dims[0]) if len(dims) == 1
                 else mesh[tuple(dims)]._flatten().get_group())
        return cls(group, rank, math.prod(sizes[a] for a in dims))

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(rank {self.rank} of {self.size}, "
                f"{self.backend or 'no group'})")


class ModelAxis(MeshAxis):
    """The ``model`` axis: the tensor-parallel products' ranks."""

    name = "model"

    @classmethod
    def of(cls, mesh) -> Optional["ModelAxis"]:
        """The ``model`` axis of a ``DeviceMesh``; None where the mesh has
        none or it has one rank."""
        names = mesh.mesh_dim_names or ()
        if "model" not in names:
            return None
        size = mesh.mesh.shape[names.index("model")]
        if size == 1:
            return None
        return cls(mesh.get_group("model"), mesh.get_local_rank("model"), size)


class DataAxis(MeshAxis):
    """The data ranks of a ``DeviceMesh``: its ``pod`` and ``data`` dims
    flattened, major to minor, as ``batch_specs`` cut the batch over them;
    ``rank`` is this process's index there (its batch shard's)."""

    name = "data"

    @classmethod
    def of(cls, mesh) -> Optional["DataAxis"]:
        """The data axis of a ``DeviceMesh``; None where it has one rank."""
        return cls._over(mesh, ("pod", "data"))


class SeqAxis(MeshAxis):
    """The ranks over which a dense decode cache's sequence dim is cut:
    the mesh dims of a ``cache_specs`` entry (``("model",)``, or ``("pod",
    "data", "model")`` when the batch does not divide the data ranks),
    those of one rank left out, flattened major to minor, as
    ``P(("data", "model"))`` cuts the sequence: ``rank`` is ``d * R + m``
    on a ``(D, R)`` mesh, the index of the rank's sequence shard."""

    name = "seq"

    @classmethod
    def of(cls, mesh, axes: tuple) -> Optional["SeqAxis"]:
        """The axis over the mesh dims ``axes`` of a ``DeviceMesh``; None
        where they hold one rank."""
        return cls._over(mesh, axes)


# ------------------------------------------------------------ autograd pairs


def _own(g: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of an incoming gradient, which a collective may
    then write in place."""
    return g.clone(memory_format=torch.contiguous_format)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        return axis.sum_(t.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.sum_(_own(g)), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, axis, dim, lo, total):
        ctx.dim, ctx.lo, ctx.n = dim, lo, local.shape[dim]
        return axis._gather(local, dim, lo, total)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.lo, ctx.n).contiguous(), None, None, None, None


class _GatherParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, meta, *locals_):
        ctx.meta = meta
        return tuple(axis._gather_parts([(t, lo, total) for t, (lo, total, _)
                                         in zip(locals_, meta)]))

    @staticmethod
    def backward(ctx, *gs):
        out = []
        for g, (lo, total, n) in zip(gs, ctx.meta):
            out.append(None if g is None else g[..., lo:lo + n].contiguous())
        return (None, None, *out)


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, cuts, *locals_):
        ctx.axis, ctx.cuts = axis, cuts
        ctx.shapes = [t.shape for t in locals_]
        ctx.like = (locals_[0].dtype, locals_[0].device)
        wholes = []
        for t, (dim, _, total) in zip(locals_, cuts):
            _contiguous(t, "a gather of FSDP shards")
            shape = list(t.shape)
            shape[dim] = total
            wholes.append(tuple(shape))
        ctx.wholes = wholes
        sizes = [math.prod(s) for s in wholes]
        buf = locals_[0].new_zeros(sum(sizes))
        outs = [seg.view(s) for seg, s in zip(buf.split(sizes), wholes)]
        for t, o, (dim, lo, _) in zip(locals_, outs, cuts):
            if t.shape[dim]:
                o.narrow(dim, lo, t.shape[dim]).copy_(t)
        axis.sum_(buf)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gs):
        sizes = [math.prod(s) for s in ctx.wholes]
        dtype, device = ctx.like
        buf = torch.cat([(torch.zeros(n, dtype=dtype, device=device)
                          if g is None else g.reshape(-1).to(dtype))
                         for g, n in zip(gs, sizes)])
        ctx.axis.sum_(buf)
        out = []
        for seg, whole, shape, (dim, lo, _) in zip(buf.split(sizes), ctx.wholes,
                                                   ctx.shapes, ctx.cuts):
            out.append(seg.view(whole).narrow(dim, lo, shape[dim]).contiguous())
        return (None, None, *out)
