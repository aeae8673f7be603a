"""Sharding rules: DP / TP / EP / FSDP / sequence-sharded KV, the JAX
package's ``distributed/sharding.py``.

A spec is a tuple with one entry per tensor dim, the JAX package's
``PartitionSpec`` as plain data: ``None`` (replicated), an axis name, or
a tuple of two or more names (one dim split over several mesh axes,
major to minor).  A one-name tuple is written as the name and an empty
one as ``None``, as ``PartitionSpec`` normalises them, so a port spec
equals ``tuple(reference_spec)``.

Tile-aligned discipline for packed tensors: packed weights ``w_pack
[N_o, K_o, n_r, k_r]`` shard on outer tile dims only, so no collective
splits a hardware tile.  The rules map parameter *paths* to specs:

  - column-parallel (wq/wk/wv/wu/wg, embed, lm_head): out-dim over
    "model", in-dim over "data" when FSDP;
  - row-parallel (wo/wd): in-dim over "model";
  - expert stacks [E, in, out]: E over "model" (expert parallelism),
    in-dim over "data" when FSDP;
  - everything small (norms, biases, scalars): replicated;
  - scan-stacked layer groups carry a leading [G] dim that is never
    sharded; the rules apply to the remaining dims;
  - a mesh axis is dropped from a dim it does not divide (whisper's vocab
    of 51865 on a 16-way axis).

:func:`named` turns specs into DTensor placements over a ``DeviceMesh``
(``Shard(d)`` / ``Replicate()`` per mesh dim), :func:`distribute` places a
tree with them, and :func:`local_shape` / :func:`device_bytes` give each
device's shard of a leaf and of a tree from the specs alone (an
:class:`~repro_torch.launch.mesh.AbstractMesh` is enough).
"""

from __future__ import annotations

import math
import re

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import axis_sizes, dp_axes

__all__ = ["param_specs", "batch_specs", "cache_specs", "state_specs",
           "named", "distribute", "tree_paths", "local_shape",
           "device_bytes"]


def tree_paths(tree) -> dict:
    """Flatten nested dicts into {'a/b/c': leaf} (sorted keys)."""
    out = {}

    def rec(prefix, t):
        if isinstance(t, dict):
            for k in sorted(t):
                rec(f"{prefix}/{k}" if prefix else str(k), t[k])
        else:
            out[prefix] = t

    rec("", tree)
    return out


def _unflatten_like(tree, flat: dict, prefix=""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    return flat[prefix]


def _entry(ax):
    """One spec entry, normalised as ``PartitionSpec`` normalises it."""
    if isinstance(ax, tuple):
        if not ax:
            return None
        return ax[0] if len(ax) == 1 else ax
    return ax


def _spec(*entries) -> tuple:
    return tuple(_entry(a) for a in entries)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


_COL = re.compile(r"(wq|wk|wv|wu|wg|wr|in_proj|x_proj|frontend_proj|"
                  r"vision_proj|lm_head)/w$")
_EMBED = re.compile(r"embed/e$")


def _spec_for_param(path: str, leaf, fsdp_axis) -> tuple:
    nd = leaf.ndim
    if nd < 2:
        return ()
    # scan-stacked layer groups: the leading [G] dim is never sharded
    stacked = "groups/" in path or path.startswith("groups")
    lead: tuple = (None,) if stacked else ()
    nd_eff = nd - len(lead)

    def spec(*rest):
        return _spec(*lead, *rest)

    if path.endswith("/b") or nd_eff < 2:
        return spec(*(None,) * nd_eff)            # biases / vectors
    if re.search(r"(wu|wg|wd)/w$", path) and nd_eff == 3:
        return spec("model", fsdp_axis, None)     # expert stack: EP + FSDP
    if _EMBED.search(path):
        # vocab over data (FSDP) only, as the JAX package (its GSPMD
        # mis-partitions the token gather against a model-sharded dim)
        return _spec(fsdp_axis, None)
    if re.search(r"(wo|wd|out_proj)/w$", path):
        return spec("model", fsdp_axis)
    if _COL.search(path):
        return spec(fsdp_axis, "model")
    if re.search(r"router/w$", path):
        return spec(fsdp_axis, None)
    if re.search(r"(pe_enc|pe_dec)$", path):
        return _spec(None, "model")
    if re.search(r"(w_a|w_b|a_log|conv_w|mu(/.*)?|u|dt_proj/w)$", path):
        return spec(*(None,) * nd_eff)            # small mixer params
    if nd_eff == 2:
        return spec(fsdp_axis, "model")           # default 2-D weight
    return spec(*(None,) * nd_eff)


def _sanitize(spec: tuple, shape, sizes: dict) -> tuple:
    """Drop mesh axes from dims they do not divide; one entry per dim."""
    shape = tuple(shape)
    if len(spec) > len(shape):
        return (None,) * len(shape)
    out = [ax if shape[i] % math.prod(sizes[a] for a in _axes(ax)) == 0 else None
           for i, ax in enumerate(spec)]
    return tuple(out) + (None,) * (len(shape) - len(spec))


def param_specs(params, run: RunConfig, mesh) -> dict:
    """The spec tree of ``params`` (nested dicts of tensors, meta ones
    included)."""
    sizes = axis_sizes(mesh)
    fsdp_axis = "data" if run.fsdp and "data" in sizes else None
    specs = {p: _sanitize(_spec_for_param(p, l, fsdp_axis), l.shape, sizes)
             for p, l in tree_paths(params).items()}
    return _unflatten_like(params, specs)


def _dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in dp_axes(mesh))


def batch_specs(batch_like, mesh):
    """Inputs: the leading batch dim over the DP axes (pod x data) where it
    divides; a single tensor or nested dicts of them."""
    dp, dp_size = dp_axes(mesh), _dp_size(mesh)

    def spec(leaf):
        nd = leaf.ndim
        if nd == 0:
            return ()
        b = leaf.shape[0]
        if b % dp_size == 0 and b >= dp_size:
            return _spec(dp, *(None,) * (nd - 1))
        return (None,) * nd

    if isinstance(batch_like, dict):
        return {k: batch_specs(v, mesh) for k, v in batch_like.items()}
    return spec(batch_like)


def cache_specs(caches, mesh, run: RunConfig, global_batch: int) -> dict:
    """Decode caches: batch over DP where it divides; the KV sequence over
    "model" (distributed flash-decode); batch 1 long-context shards the
    sequence over every axis.  Paged pools ``[G, P, T, Hkv, dh]`` shard
    their page dim (``seq_shard_kv``) or their heads; a page's ``[T, dh]``
    tile is never split."""
    dp, dp_size = dp_axes(mesh), _dp_size(mesh)
    sizes = axis_sizes(mesh)
    batch_ok = global_batch % dp_size == 0 and global_batch >= dp_size
    bspec = dp if batch_ok else None
    seq_axes = ("model",) if batch_ok else (*dp, "model")

    def spec(path, leaf):
        nd = leaf.ndim
        if path.endswith(("/k_pages", "/v_pages")):
            lead = (None,) * (nd - 4)
            if run.seq_shard_kv:
                return _spec(*lead, "model", None, None, None)
            return _spec(*lead, None, None, "model", None)
        if path.endswith("/k") or path.endswith("/v"):
            lead = (None,) * (nd - 4)
            if run.seq_shard_kv:
                return _spec(*lead, bspec, seq_axes, None, None)
            return _spec(*lead, bspec, None, "model", None)
        if path.endswith("ssm"):                  # [G, B, di, N]
            return _spec(*(None,) * (nd - 3), bspec, "model", None)
        if path.endswith("conv"):                 # [G, B, W, di]
            return _spec(*(None,) * (nd - 3), bspec, None, "model")
        if path.endswith("state"):                # [G, B, H, dh, dh]
            return _spec(*(None,) * (nd - 4), bspec, "model", None, None)
        if path.endswith(("tm_shift", "cm_shift")):   # [G, B, D]
            return _spec(*(None,) * (nd - 2), bspec, "model")
        return (None,) * nd

    specs = {p: _sanitize(spec(p, l), l.shape, sizes)
             for p, l in tree_paths(caches).items()}
    return _unflatten_like(caches, specs)


def _map_specs(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def state_specs(state_like, run: RunConfig, mesh):
    """The train state's specs: parameters and moments follow the
    parameter rules; the 8-bit moments' scales (``m_s``, ``v_s``) follow
    their parameter less its quantised last axis."""
    from repro_torch.training.train_state import TrainState

    p_specs = param_specs(state_like.params, run, mesh)
    opt = {}
    for k, tree in state_like.opt_state.items():
        if k in ("m", "v", "err", "m_q", "v_q"):
            opt[k] = p_specs
        elif k in ("m_s", "v_s"):
            opt[k] = _map_specs(lambda s: s[:-1], p_specs)
        else:
            opt[k] = _map_specs(lambda _: (), tree)
    return TrainState(step=(), params=p_specs, opt_state=opt)


def local_shape(shape, spec: tuple, mesh) -> tuple:
    """One device's shard of a leaf of ``shape`` under ``spec``: each dim
    divided by the product of its axes' sizes (rounded up, as a ragged
    last shard is allocated whole)."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(-(-int(n) // math.prod(sizes[a] for a in _axes(ax)))
                 for n, ax in zip(shape, spec))


def device_bytes(tree, specs, mesh, block: int = 1) -> int:
    """Bytes of one device's shards of ``tree``'s tensors (meta ones
    included) under ``specs`` (the same structure; a ``TrainState`` of
    trees too), each shard rounded up to a multiple of ``block`` bytes."""
    from repro_torch.training.train_state import TrainState
    if isinstance(tree, TrainState):
        return (device_bytes(tree.params, specs.params, mesh, block)
                + device_bytes(tree.opt_state, specs.opt_state, mesh, block))
    if isinstance(tree, dict):
        return sum(device_bytes(v, specs[k], mesh, block) for k, v in tree.items())
    if not isinstance(tree, torch.Tensor):
        return 0
    n = math.prod(local_shape(tree.shape, specs, mesh)) * tree.element_size()
    return -(-n // block) * block


def named(mesh, spec_tree):
    """Each spec as DTensor placements over ``mesh`` (a ``DeviceMesh``):
    one per mesh dim, ``Shard(d)`` for the tensor dim ``d`` whose entry
    names it, else ``Replicate()``.  A dim split over several axes takes
    them major to minor; they must be in mesh order, which is the order
    DTensor shards in (and the rules only write ``("pod", "data")``)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(axis_sizes(mesh))

    def placements(spec):
        out = [Replicate()] * len(names)
        for d, entry in enumerate(spec):
            axes = _axes(entry)
            order = [names.index(a) for a in axes]
            if order != sorted(order):
                raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                                 f"in mesh order {names}")
            for i in order:
                out[i] = Shard(d)
        return tuple(out)

    def rec(s):
        if isinstance(s, dict):
            return {k: rec(v) for k, v in s.items()}
        return placements(s)

    return rec(spec_tree)


def distribute(tree, mesh, spec_tree):
    """``tree``'s tensors as DTensors over ``mesh`` under ``spec_tree``
    (``distribute_tensor`` of each leaf, from rank 0's)."""
    from torch.distributed.tensor import distribute_tensor
    places = named(mesh, spec_tree)

    def rec(t, p):
        if isinstance(t, dict):
            return {k: rec(v, p[k]) for k, v in t.items()}
        return distribute_tensor(t, mesh, p)

    return rec(tree, places)
