"""The collectives of serving across ranks: the ``model`` axis of a mesh.

The JAX package has no counterpart: under GSPMD its partitioner inserts
the collectives of a sharded program.  The port computes each rank's
tensors eagerly, so the model code asks for them here, on the
:class:`ModelAxis` its context carries (``MatmulContext.tp``):

- :meth:`ModelAxis.sum_`: a sum across ranks, in place (the float32
  partials of a row-parallel product);
- :meth:`ModelAxis.gather`: each rank's slice of one dim put back whole on
  every rank (the outputs of a column-parallel product, the ranks' shares
  of the flash-decode; :meth:`~ModelAxis.gather_parts` several at once,
  in one collective).  The gather is an
  ``all_reduce`` sum into a zeroed buffer holding the rank's slice at its
  offset: every element has one contributor, so the sum is exact, and the
  one code path serves gloo, which takes CUDA tensors in ``all_reduce``
  and ``broadcast`` but not in ``all_gather``, as it serves NCCL.

Backends (:func:`pick_backend`): gloo on the CPU and where ranks share a
card; NCCL only where each rank has a card of its own.  A gloo collective
is host work that a CUDA graph cannot capture, so the engine runs its
steps uncaptured across ranks (``models/model.py:capture_graph`` refuses
them).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["ModelAxis", "pick_backend"]


def pick_backend(device_type: str, world_size: int) -> str:
    """``"nccl"`` where every rank has a card of its own (``world_size``
    ranks on a host with at least as many cards), else ``"gloo"``: the CPU,
    or ranks that share a card (NCCL refuses two ranks on one device)."""
    if torch.device(device_type).type == "cuda" \
            and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


class ModelAxis:
    """The ranks of a mesh's ``model`` axis as the model code sees them:
    ``size`` ranks, this process's ``rank`` among them, and the process
    group the collectives run over (None for one rank: every collective is
    then the identity)."""

    def __init__(self, group, rank: int, size: int):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} of a model axis of {size}")
        self.group, self.rank, self.size = group, rank, size
        self.backend = None if group is None else dist.get_backend(group)
        # the collectives made and the bytes each rank put in
        self.calls, self.bytes = 0, 0

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

    def sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` (contiguous) over the ranks in place; returns it."""
        if self.group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
            self.calls += 1
            self.bytes += t.numel() * t.element_size()
        return t


    def gather(self, local: torch.Tensor, dim: int, lo: int,
               total: int) -> torch.Tensor:
        """The whole tensor of which ``local`` is the slice ``[lo, lo +
        local.shape[dim])`` of dim ``dim`` (of extent ``total``), on every
        rank; the ranks' slices must tile ``[0, total)``."""
        dim = dim % local.ndim
        shape = list(local.shape)
        shape[dim] = total
        out = local.new_zeros(shape)
        if local.shape[dim]:                # a rank may hold none of it
            out.narrow(dim, lo, local.shape[dim]).copy_(local)
        return self.sum_(out)

    def gather_parts(self, parts: list) -> list:
        """:meth:`gather` of several tensors along their last dim in one
        collective: ``parts`` is ``[(local, lo, total)]``, tensors alike
        but for the last dim; returns each whole."""
        totals = [total for _, _, total in parts]
        lead = parts[0][0].shape[:-1]
        out = parts[0][0].new_zeros((*lead, sum(totals)))
        off = 0
        for (local, lo, total) in parts:
            if local.shape[-1]:
                out[..., off + lo:off + lo + local.shape[-1]].copy_(local)
            off += total
        return list(self.sum_(out).split(totals, dim=-1))

    def __repr__(self) -> str:
        return (f"ModelAxis(rank {self.rank} of {self.size}, "
                f"{self.backend or 'no group'})")
