"""Carry parameters and training state across from the JAX package.

:func:`from_jax_params` takes the reference's parameter tree with every
leaf already turned into a numpy array (the caller does the
``np.asarray``; this module imports no JAX) and returns the port's tree:
the same keys, shapes and dtypes, as torch tensors.  Any tree of arrays
comes across so, an optimizer state too (int8 moments, float32 scales,
0-d scales of 1-D leaves); :func:`from_jax_state` carries a whole train
state, so both packages' trainers can start from one state.

Across ranks (``mesh=``), :func:`from_jax_params` gives one rank its own
shard of a parameter tree (``distributed/sharding.py:shard_params``
under ``param_specs``: every linear cut in whole tiles, with its
``w_split``): only the shard is copied to ``device``, and
``Engine(mesh=)`` serves it as it is; :func:`from_jax_state` gives a
rank its shard of a train state (``sharding.shard_state`` under
``state_specs``), which ``make_train_step`` trains across ranks, and
:func:`~repro_torch.distributed.sharding.unshard_state` puts the ranks'
shards back together.

A rank's windows of the dense decode caches (the static batch loop
across ranks, ``cache_specs``): :func:`cut_caches` cuts a whole cache
tree (the JAX package's, as numpy arrays, or the port's one-rank one)
into a rank's windows, :func:`join_caches` puts the ranks' windows back
together.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.distributed.sharding import unshard_state

__all__ = ["from_jax_params", "from_jax_state", "unshard_state", "cut_caches",
           "join_caches"]


def _leaf(a: np.ndarray, device) -> torch.Tensor:
    """A copy of ``a`` (the port updates pools in place; the caller's
    arrays stay untouched)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes bf16: reinterpret bits
        return torch.tensor(a.view(np.int16), device=device).view(torch.bfloat16)
    return torch.tensor(a, device=device)


def from_jax_params(tree, device="cpu", *, mesh=None, run=None,
                    layout_of=None, coord=None):
    """Nested dicts of numpy arrays -> nested dicts of tensors on ``device``.

    With ``mesh`` (and the model's ``run`` and ``layout_of``, its
    ``ctx.layout``): this rank's shard of the tree, at ``coord`` (default
    the process's coordinate on a ``DeviceMesh``)."""
    if mesh is None:
        if isinstance(tree, dict):
            return {k: from_jax_params(v, device) for k, v in tree.items()}
        return _leaf(tree, device)
    from repro_torch.distributed import sharding
    from repro_torch.models.transformer import tree_map
    whole = from_jax_params(tree, "cpu")
    coord = sharding.mesh_coord(mesh) if coord is None else coord
    local = sharding.shard_params(whole, sharding.param_specs(whole, run, mesh),
                                  mesh, coord, layout_of)
    return tree_map(lambda t: t.to(device, copy=True), local)


def from_jax_state(step, params, opt_state, device="cpu", *, mesh=None,
                   run=None, layout_of=None):
    """The port's ``TrainState`` from the JAX package's ``TrainState``
    fields, each leaf a numpy array (``step`` a 0-d array or an int).

    With ``mesh`` (and the model's ``run`` and ``layout_of``): this rank's
    shard of the state under ``state_specs``, at the process's coordinate
    on the ``DeviceMesh``, as :func:`from_jax_params`
    gives a rank its parameters; only the shard is copied to ``device``."""
    from repro_torch.training.train_state import TrainState
    if mesh is None:
        return TrainState(step=int(step), params=from_jax_params(params, device),
                          opt_state=from_jax_params(opt_state, device))
    from repro_torch.distributed import sharding
    from repro_torch.models.transformer import tree_map
    whole = from_jax_state(step, params, opt_state, "cpu")
    local = sharding.shard_state(whole, run, mesh, sharding.mesh_coord(mesh),
                                 layout_of)
    return TrainState(step=local.step,
                      params=tree_map(lambda t: t.to(device, copy=True),
                                      local.params),
                      opt_state=tree_map(lambda t: t.to(device, copy=True),
                                         local.opt_state))



def cut_caches(tree, mesh, run, batch: int, coord: dict):
    """A rank's windows of a whole dense cache tree of ``batch`` rows
    (numpy arrays or tensors) under ``cache_specs`` on ``mesh`` (an
    ``AbstractMesh`` will do), at mesh coordinate ``coord``: its batch
    rows and its positions of each K/V's sequence (``sharding.shard_tree``,
    copies on the CPU)."""
    from repro_torch.distributed import sharding
    whole = from_jax_params(tree, "cpu")
    return sharding.shard_tree(whole, sharding.cache_specs(whole, mesh, run, batch),
                               mesh, coord)


def join_caches(windows: dict, like, mesh, run, batch: int):
    """The whole dense cache tree put back together from ``windows``
    (``{coordinate: the rank's windows}``, every coordinate of ``mesh``),
    ``like`` a whole tree of the same shapes (meta tensors will do); the
    copies of a piece that several ranks hold must agree bit for bit
    (``sharding.unshard_tree``).  Each leaf comes back on the CPU."""
    from repro_torch.distributed import sharding
    return sharding.unshard_tree(windows, like,
                                 sharding.cache_specs(like, mesh, run, batch), mesh)
