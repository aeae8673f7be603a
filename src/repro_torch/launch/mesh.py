"""Device meshes for the production topology, the JAX package's
``launch/mesh.py`` over ``torch.distributed``.

Production topology: 16 x 16 = 256 devices a pod, ``("data", "model")``;
the multi-pod mesh adds a leading ``"pod"`` axis (2 pods = 512 devices)
for pure data parallelism across pods.

- :func:`make_production_mesh` and :func:`make_elastic_mesh` return a
  ``torch.distributed.device_mesh.DeviceMesh`` over the default process
  group, which the caller initialises (``init_process_group`` with its own
  store, world size and rank: nothing on a machine tells a program of a
  cluster).  Both are functions, so importing this module touches no
  process group; both raise when the world size does not fill the mesh,
  as ``jax.make_mesh`` raises for too few devices.  The device type is
  ``"cuda"`` unless the caller asks for ``"cpu"`` (gloo).
- :class:`AbstractMesh` is ``jax.sharding.AbstractMesh``'s counterpart: a
  mesh's axis names and sizes and nothing else, no process group.  The
  sharding rules, the model's context and the dry-run need only that, so
  a 512-device cell is priced in one process.

:func:`axis_sizes` reads either kind as ``{name: size}``.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.core.hardware import require_device

__all__ = ["AbstractMesh", "axis_sizes", "make_production_mesh",
           "make_elastic_mesh", "elastic_shape", "dp_axes", "MESHES",
           "ABSTRACT_MESHES"]

_POD = ((16, 16), ("data", "model"))
_MULTIPOD = ((2, 16, 16), ("pod", "data", "model"))


class AbstractMesh:
    """A mesh's shape and axis names only (``jax.sharding.AbstractMesh``):
    ``axis_names``, ``shape`` ({name: size}, in mesh order) and ``size``."""

    def __init__(self, sizes, names):
        sizes, names = tuple(int(s) for s in sizes), tuple(names)
        if len(sizes) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"AbstractMesh: sizes {sizes} and names {names} "
                             f"must pair up, each name once")
        self.axis_names = names
        self.shape = dict(zip(names, sizes))
        self.size = math.prod(sizes)

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` in mesh order, of an :class:`AbstractMesh` or
    a ``DeviceMesh`` (whose dims must be named)."""
    if isinstance(mesh, AbstractMesh):
        return dict(mesh.shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh without mesh_dim_names has no axes to "
                         "shard by name")
    return dict(zip(names, mesh.mesh.shape))


def _make_mesh(shape: tuple, names: tuple, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    require_device(device_type)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs the default process group: "
                           f"call torch.distributed.init_process_group first")
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {shape} mesh over {names} needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    return init_device_mesh(torch.device(device_type).type, shape,
                            mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """``(16, 16)`` over ``("data", "model")``, or ``(2, 16, 16)`` over
    ``("pod", "data", "model")`` with ``multi_pod``."""
    shape, names = _MULTIPOD if multi_pod else _POD
    return _make_mesh(shape, names, device_type)


def elastic_shape(n: int, model_parallel: int = 0) -> tuple:
    """``(data, model)`` of an elastic mesh over ``n`` devices:
    ``model_parallel=0`` picks the largest power of two up to 16 (one ICI
    dimension in the JAX package's topology) that divides ``n``."""
    if model_parallel <= 0:
        model_parallel = 1
        while (model_parallel < 16 and n % (model_parallel * 2) == 0
               and model_parallel * 2 <= n):
            model_parallel *= 2
    return n // model_parallel, model_parallel


def make_elastic_mesh(model_parallel: int = 0, device_type: str = "cuda"):
    """Best-effort ``(data, model)`` mesh over the process group's ranks,
    the restart path after a node failure (checkpoints are mesh-agnostic)."""
    if not dist.is_initialized():
        raise RuntimeError("make_elastic_mesh needs the default process group: "
                           "call torch.distributed.init_process_group first")
    shape = elastic_shape(dist.get_world_size(), model_parallel)
    return _make_mesh(shape, ("data", "model"), device_type)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (pod included when present)."""
    names = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


MESHES = {
    "pod": lambda device_type="cuda": make_production_mesh(
        multi_pod=False, device_type=device_type),
    "multipod": lambda device_type="cuda": make_production_mesh(
        multi_pod=True, device_type=device_type),
}

# the same topologies without a process group: what the dry-run prices
ABSTRACT_MESHES = {"pod": AbstractMesh(*_POD), "multipod": AbstractMesh(*_MULTIPOD)}
