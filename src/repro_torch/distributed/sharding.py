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

A rank's own shards, for serving across ranks (no DTensor: the model code
computes on plain local tensors): :func:`unit_range` is the slice of
one dim a mesh coordinate holds, cut as :func:`local_shape` allocates it
(``ceil(n / parts)`` units a rank, the last ranks' shards shorter or
empty); :func:`shard_tree` takes a rank's shard of every leaf of a tree by
its specs; :func:`shard_params` and :func:`shard_prepacked` that of a
parameter tree unpacked or prepacked, where a linear's weight is cut in
whole tiles: ``w [.., K, N]`` in units of ``k_r`` and ``n_r``, ``w_pack
[.., N_o, K_o, n_r, k_r]`` over ``N_o`` and ``K_o``, so that no tile is
ever split (the layout contract carried across ranks).  Such a linear
records its cut as ``w_split``: ``("col", lo, hi, N)`` (output tiles
``[lo, hi)`` of an ``N``-wide output) or ``("row", lo, hi, K_o)``
(contraction tiles ``[lo, hi)`` of ``K_o``), which
``core/linear.py:linear_apply`` reads.

A rank's window of a dense decode cache (the static batch loop across
ranks): :func:`leaf_window` gives the batch rows and the sequence
positions ``cache_specs`` hand a mesh coordinate, :func:`shard_tree`
cuts a whole cache tree so and :func:`unshard_tree` puts the windows
back together.

A rank's shard of a train state (training across ranks):
:func:`shard_state` cuts the parameters as :func:`shard_params` does and
each optimizer leaf as its parameter (an 8-bit moment's scales as its
parameter less the last dim), in the same whole tiles;
:func:`unshard_state` puts the ranks' shards back together, and checks
that every copy of a replicated piece agrees.
"""

from __future__ import annotations

import math
import re

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import axis_sizes, dp_axes

__all__ = ["param_specs", "batch_specs", "cache_specs", "state_specs",
           "named", "distribute", "tree_paths", "local_shape",
           "device_bytes", "tile_range", "unit_range", "mesh_coord",
           "shard_tree", "shard_params", "shard_prepacked", "head_split",
           "leaf_units", "shard_state", "unshard_state", "leaf_window",
           "unshard_tree"]


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


# ---------------------------------------------------------------- a rank's shards


def tile_range(n: int, parts: int, idx: int) -> tuple:
    """``[lo, hi)`` of part ``idx`` when ``n`` units are cut into ``parts``
    parts of ``ceil(n / parts)`` units (the last parts shorter, or empty):
    the ragged last shard that :func:`local_shape` allocates whole."""
    c = -(-n // parts) if parts else n
    lo = min(n, idx * c)
    return lo, min(n, lo + c)


def mesh_coord(mesh) -> dict:
    """``{axis name: this process's index}`` on a ``DeviceMesh``."""
    return dict(zip(axis_sizes(mesh), mesh.get_coordinate()))


def unit_range(units: int, entry, mesh, coord: dict) -> tuple:
    """The range ``[lo, hi)`` of ``units`` whole units (tiles, or elements)
    of a dim under a spec ``entry`` that mesh coordinate ``coord`` holds:
    the dim's axes index it major to minor, as :func:`named` places it."""
    sizes = axis_sizes(mesh)
    parts, idx = 1, 0
    for a in _axes(entry):
        parts *= sizes[a]
        idx = idx * sizes[a] + coord[a]
    return tile_range(units, parts, idx)


def _cut(t: torch.Tensor, spec: tuple, mesh, coord: dict, units=None):
    """``t``'s shard under ``spec``, dim ``d`` cut in whole ``units[d]``;
    returns (the shard, each dim's range in units)."""
    spec = _full(spec, t.ndim)
    units = units or (1,) * t.ndim
    ranges = []
    for d, (entry, unit) in enumerate(zip(spec, units)):
        lo, hi = unit_range(-(-t.shape[d] // unit), entry, mesh, coord)
        ranges.append((lo, hi))
        e0, e1 = min(t.shape[d], lo * unit), min(t.shape[d], hi * unit)
        if (e0, e1) != (0, t.shape[d]):
            t = t.narrow(d, e0, e1 - e0)
    return t.contiguous(), ranges


def leaf_window(shape, spec: tuple, mesh, coord: dict) -> list:
    """Each dim's element range ``(lo, hi)`` of a leaf of ``shape`` that
    mesh coordinate ``coord`` holds under ``spec``: the shard
    :func:`shard_tree` cuts (a rank's window of a decode cache under
    ``cache_specs``: its batch rows and its positions of the sequence)."""
    return [unit_range(int(n), e, mesh, coord)
            for n, e in zip(shape, _full(spec, len(shape)))]


def shard_tree(tree, specs, mesh, coord: dict):
    """Each tensor leaf's shard that ``coord`` holds under ``specs`` (the
    same structure), a copy; other leaves pass through."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh, coord) for k, v in tree.items()}
    if not isinstance(tree, torch.Tensor):
        return tree
    return _cut(tree, specs, mesh, coord)[0]


def _linear_split(spec: tuple, k_rng: tuple, n_rng: tuple, k_tiles: int,
                  n: int, mesh=None):
    """A linear's ``w_split`` from the tile ranges its K and N dims were
    cut to (None where the model axis cuts neither, or has one rank)."""
    if mesh is not None and axis_sizes(mesh).get("model", 1) == 1:
        return None
    ent_k, ent_n = spec[-2], spec[-1]
    if "model" in _axes(ent_k) and "model" in _axes(ent_n):
        raise ValueError(f"a linear split over 'model' on both dims: {spec}")
    if "model" in _axes(ent_n):
        return ("col", *n_rng, n)
    if "model" in _axes(ent_k):
        return ("row", *k_rng, k_tiles)
    return None


def _is_linear(p, key) -> bool:
    from repro_torch.core.linear import PLAIN_PRODUCTS
    return (key not in PLAIN_PRODUCTS and isinstance(p, dict)
            and isinstance(p.get("w"), torch.Tensor) and p["w"].ndim >= 2)


def shard_params(params, specs, mesh, coord: dict, layout_of):
    """The rank's shard of an unpacked parameter tree under
    :func:`param_specs`' ``specs``: every linear's ``w [.., K, N]`` cut in
    whole tiles (``layout_of(dtype)``'s ``k_r`` and ``n_r``), with its
    ``w_split``; every other leaf by :func:`shard_tree`.  Packing the
    result gives :func:`shard_prepacked` of the packed tree, tile for
    tile."""
    def rec(p, s, key=None):
        if _is_linear(p, key):
            lay = layout_of(p["w"].dtype)
            w, (*_, k_rng, n_rng) = _cut(p["w"], s["w"], mesh, coord,
                                         (1,) * (p["w"].ndim - 2) + (lay.k_r, lay.n_r))
            out = {k: rec(v, s[k], k) for k, v in p.items() if k != "w"}
            out["w"] = w
            split = _linear_split(_full(s["w"], p["w"].ndim), k_rng, n_rng,
                                  -(-p["w"].shape[-2] // lay.k_r),
                                  p["w"].shape[-1], mesh)
            if split is not None:
                out["w_split"] = split
            return out
        if isinstance(p, dict):
            return {k: rec(v, s[k], k) for k, v in p.items()}
        return shard_tree(p, s, mesh, coord)

    return rec(params, specs)


def _full(spec: tuple, nd: int) -> tuple:
    return tuple(spec) + (None,) * (nd - len(spec))


def shard_prepacked(packed, specs, mesh, coord: dict):
    """The rank's shard of a prepacked parameter tree
    (``core/linear.py:prepack_params``), ``specs`` being the unpacked
    tree's (:func:`param_specs`): a ``w_pack [.., N_o, K_o, n_r, k_r]``
    cut over ``N_o`` by its weight's N entry and over ``K_o`` by its K
    entry, in whole tiles, ``w_n`` the shard's output width and ``w_split``
    the cut; every other leaf by :func:`shard_tree`."""
    def rec(p, s):
        if isinstance(p, dict) and "w_pack" in p:
            wp, n = p["w_pack"], p["w_n"]
            spec = _full(s["w"], wp.ndim - 2)         # (.., K entry, N entry)
            lead, k_ent, n_ent = spec[:-2], spec[-2], spec[-1]
            n_r = wp.shape[-2]
            local, rngs = _cut(wp, (*lead, n_ent, k_ent, None, None), mesh,
                               coord)
            (no_lo, no_hi) = rngs[-4]
            out = {k: rec(v, s[k]) for k, v in p.items()
                   if k not in ("w_pack", "w_n")}
            out["w_pack"] = local
            out["w_n"] = min(no_hi * n_r, n) - min(no_lo * n_r, n)
            split = _linear_split(spec, rngs[-3], rngs[-4], wp.shape[-3], n, mesh)
            if split is not None:
                out["w_split"] = split
            return out
        if isinstance(p, dict):
            return {k: rec(v, s[k]) for k, v in p.items()}
        return shard_tree(p, s, mesh, coord)

    return rec(packed, specs)


def head_split(vocab: int, d_model: int, rank: int, size: int, n_r: int):
    """The tied head's cut (``{"w": embed.T}``, packed at each call) on
    rank ``rank`` of a model axis of ``size``: the rule of an ``lm_head/w
    [d, V]`` leaf, so its vocab tiles split over ``model`` where V
    divides, as the JAX package's ``tp="col"`` splits them.  The rank's
    range ``[lo, hi)`` of the ``ceil(V / n_r)`` tiles, or None (the head
    is computed whole)."""
    shape = (d_model, vocab)
    spec = _sanitize(_spec_for_param("lm_head/w", torch.empty(
        shape, device="meta"), None), shape, {"model": size})
    if "model" not in _axes(spec[-1]):
        return None
    return tile_range(-(-vocab // n_r), size, rank)


# ------------------------------------------------------- a rank's train state


def leaf_units(params, layout_of) -> dict:
    """``{path: (leaf, units)}``: every tensor leaf of a parameter tree and
    the units its dims are cut in: a linear's ``w [.., K, N]`` in
    ``layout_of(dtype)``'s ``k_r`` and ``n_r`` (as :func:`shard_params`
    cuts it), every other leaf in elements."""
    out = {}

    def rec(p, prefix, key=None):
        if isinstance(p, dict):
            lin = _is_linear(p, key)
            for k in sorted(p):
                path = f"{prefix}/{k}" if prefix else str(k)
                v = p[k]
                if lin and k == "w":
                    lay = layout_of(v.dtype)
                    out[path] = (v, (1,) * (v.ndim - 2) + (lay.k_r, lay.n_r))
                else:
                    rec(v, path, k)
        elif isinstance(p, torch.Tensor):
            out[prefix] = (p, (1,) * p.ndim)

    rec(params, "")
    return out


def _opt_units(units: dict, key: str) -> dict:
    """An optimizer tree's units by path: its parameter's, less the last
    dim for the 8-bit moments' scales."""
    if key in ("m_s", "v_s"):
        return {p: u[:-1] for p, u in units.items()}
    return units


def _state_trees(state, specs, units):
    """(name, tree, specs, units by path) of each tree of a train state."""
    yield "params", state.params, specs.params, units
    for k, tree in state.opt_state.items():
        yield k, tree, specs.opt_state[k], _opt_units(units, k)


def shard_state(state, run: RunConfig, mesh, coord: dict, layout_of):
    """The rank's shard at ``coord`` of a whole ``TrainState`` under
    :func:`state_specs`: the parameters by :func:`shard_params` (every
    linear in whole tiles, with its ``w_split``), each moment, 8-bit
    moment and error buffer cut as its parameter, an 8-bit moment's scales
    as its parameter less the last dim; the step as it is."""
    from repro_torch.training.train_state import TrainState
    specs = state_specs(state, run, mesh)
    units = {p: u for p, (_, u) in leaf_units(state.params, layout_of).items()}
    opt = {}
    for name, tree, spec, unit in _state_trees(state, specs, units):
        if name == "params":
            continue
        flat, sp = tree_paths(tree), tree_paths(spec)
        opt[name] = _unflatten_like(tree, {
            p: (_cut(t, sp[p], mesh, coord, unit.get(p))[0]
                if isinstance(t, torch.Tensor) else t) for p, t in flat.items()})
    return TrainState(step=state.step,
                      params=shard_params(state.params, specs.params, mesh,
                                          coord, layout_of),
                      opt_state=opt)


def _unshard_leaf(what: str, t, spec: tuple, units: tuple, pieces: dict,
                  mesh) -> torch.Tensor:
    """The whole leaf (on the CPU) shaped as ``t`` from ``pieces``
    (``{coordinate: the rank's piece}``, every coordinate of ``mesh``),
    each piece where ``spec`` cut in whole ``units`` puts it; every copy of
    a piece that more than one rank holds must be the same, bit for bit."""
    names = list(axis_sizes(mesh))
    dst = torch.empty(t.shape, dtype=t.dtype)
    seen = torch.zeros(t.shape, dtype=torch.bool)
    spec = _full(spec, t.ndim)
    for c, piece in pieces.items():
        coord = dict(zip(names, c))
        piece = piece.cpu()
        region, mask = dst, seen
        for d in range(t.ndim):
            lo, hi = unit_range(-(-t.shape[d] // units[d]), spec[d], mesh, coord)
            e0, e1 = min(t.shape[d], lo * units[d]), min(t.shape[d], hi * units[d])
            region = region.narrow(d, e0, e1 - e0)
            mask = mask.narrow(d, e0, e1 - e0)
        if tuple(piece.shape) != tuple(region.shape):
            raise ValueError(f"{what} at {coord}: a shard of "
                             f"{tuple(piece.shape)} where the rules "
                             f"give {tuple(region.shape)}")
        held = region[mask]
        if held.numel() and not torch.equal(held, piece[mask]):
            raise ValueError(f"{what} at {coord}: the ranks' "
                             f"copies of a replicated piece differ")
        region.copy_(piece)
        mask.fill_(True)
    if not bool(seen.all()):
        raise ValueError(f"{what}: the shards do not cover it")
    return dst


def _coords(mesh) -> list:
    import itertools
    return list(itertools.product(*(range(n) for n in axis_sizes(mesh).values())))


def unshard_tree(shards: dict, like, specs, mesh):
    """The whole tree put back together from ``shards`` (``{coordinate:
    the rank's shard}``, every coordinate of ``mesh``, each as
    :func:`shard_tree` cuts it under ``specs``), ``like`` a whole tree of
    the same shapes (meta tensors will do): a cache tree's windows
    (``cache_specs``), say.  Replicated pieces must agree bit for bit
    (else ``ValueError``); each leaf comes back on the CPU."""
    sp = tree_paths(specs)
    pieces = {c: tree_paths(t) for c, t in shards.items()}
    whole = {path: _unshard_leaf(path, t, sp[path], (1,) * t.ndim,
                                 {c: p[path] for c, p in pieces.items()}, mesh)
             for path, t in tree_paths(like).items()
             if isinstance(t, torch.Tensor)}
    return _unflatten_like(like, whole)


def unshard_state(shards: dict, like, run: RunConfig, mesh, layout_of):
    """The whole ``TrainState`` put back together from ``shards``
    (``{coordinate: the rank's TrainState}``, a coordinate a tuple of the
    mesh's axis indices in mesh order, every coordinate of ``mesh``
    present), ``like`` a whole state of the same shapes (meta tensors will
    do).  Every copy of a piece that more than one rank holds must be the
    same, bit for bit (else ``ValueError``); the ``w_split`` entries are
    dropped.  Each leaf comes back on the CPU."""
    from repro_torch.training.optimizer import tensors
    from repro_torch.training.train_state import TrainState
    coords = _coords(mesh)
    specs = state_specs(like, run, mesh)
    units = {p: u for p, (_, u) in leaf_units(like.params, layout_of).items()}
    out = {}
    for name, tree, spec, unit in _state_trees(like, specs, units):
        sp = tree_paths(spec)
        whole = {}
        for path, t in tree_paths(tree).items():
            if not isinstance(t, torch.Tensor):
                continue
            pieces = {c: tree_paths(shards[c].params if name == "params"
                                    else shards[c].opt_state[name])[path]
                      for c in coords}
            whole[path] = _unshard_leaf(f"{name}/{path}", t, sp[path],
                                        unit.get(path) or (1,) * t.ndim,
                                        pieces, mesh)
        out[name] = _unflatten_like(tensors(tree), whole)
    return TrainState(step=shards[coords[0]].step, params=out.pop("params"),
                      opt_state=out)
