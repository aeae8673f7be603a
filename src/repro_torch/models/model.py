"""Model facade: init, the full-sequence forward and the loss (training),
the serving steps, and their compiled forms, for the dense, vlm (a stub
vision prefix, as in the JAX package), encdec (whisper), ssm (RWKV-6),
moe (qwen3-moe, arctic) and hybrid (mamba beside attention, jamba's moe
layers) families.

The port's ``ReproModel`` serves continuous batching through
``paged_decode_step`` (the dense chunked and monolithic engine steps) and
``flat_decode_step`` (the flat token-level step), and the static batch
loop through ``decode_step`` against a dense cache (``init_cache``,
``prefill_cache``; whisper runs its encoder there).  ``compiled_step(kind)``
stands where the JAX package's ``jit_step`` stands: one program per step
signature and model, counted in ``trace_counts`` and logged in
``trace_log``, so a second engine over one model counts nothing new.  On
the card the program is a CUDA graph.  A graph holds the addresses of the
parameters and caches it was captured with, and every engine has its own,
so the graphs live in the caller's :class:`GraphTable` (one per engine,
and one per model-backed drafter): signatures per model, captures per
engine, and a dropped engine frees its graphs.  The other families arrive
in later slices of the port.
"""

from __future__ import annotations

import gc
import time
import weakref
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import kernels

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.core.hardware import HardwareSpec, query, require_device
from repro_torch.core.layout import LayoutPolicy
from repro_torch.core.linear import MatmulContext, linear_apply
from repro_torch.distributed.comm import DataAxis, ModelAxis, SeqAxis
from repro_torch.kernels.ragged_attn.ops import RaggedPlan
from repro_torch.launch.mesh import AbstractMesh, axis_sizes
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import SeqWindow
from repro_torch.models.common import embed_apply

__all__ = ["ReproModel", "CompiledStep", "GraphTable", "capture_graph", "build_model",
           "MetaGenerator", "ACROSS_RANKS", "refuse_across_ranks", "CacheWindow",
           "RankCaches"]


class CacheWindow(NamedTuple):
    """A rank's window of the dense decode caches of a global batch of
    ``batch`` rows, as ``cache_specs`` lay them out on the mesh: its rows
    ``[lo, hi)`` (all of them where the batch does not divide the data
    ranks) and its :class:`~repro_torch.models.attention.SeqWindow` of the
    layer caches' sequence and of whisper's cross K/V's encoder positions
    (None: whole on every rank)."""
    batch: int
    rows: tuple
    seq: Optional[SeqWindow]
    cross: Optional[SeqWindow]


class RankCaches(dict):
    """A rank's dense decode caches (``ReproModel.init_cache`` across
    ranks): the cache tree, a dict of its windows of every leaf, and
    ``window``, the :class:`CacheWindow` they are; ``decode_step`` reads
    it."""

    def __init__(self, tree: dict, window: CacheWindow):
        super().__init__(tree)
        self.window = window


def _xent(logits: torch.Tensor, labels: torch.Tensor, z_loss: float,
          axis=None, lo: Optional[int] = None):
    """Mean next-token cross-entropy plus ``z_loss`` times the mean squared
    log-partition, in float32.  Returns (loss, {"nll", "z_loss"}).

    Across the ranks of ``axis`` (a model axis) ``logits`` are this rank's
    vocab columns from ``lo`` on: the log-sum-exp spans the ranks (the max
    of the ranks' row maxima, then one sum of the rows' exponential sums
    and of the label's logit, which the rank holding it gives), so no rank
    holds the whole logits; the sum's gradient passes to every rank's
    columns unchanged."""
    logits = logits.float()
    if axis is None:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        n = logits.shape[-1]
        top = (logits.detach().amax(dim=-1) if n else
               logits.new_full(logits.shape[:-1], -torch.inf))
        top = axis.max(top.contiguous())
        sums = torch.exp(logits - top[..., None]).sum(dim=-1)
        idx = labels.long() - lo
        mine = (idx >= 0) & (idx < n)
        ll = (torch.gather(logits, -1, idx.clamp(0, max(n - 1, 0))[..., None])[..., 0]
              if n else torch.zeros_like(sums))
        both = axis.reduce(torch.stack([sums, torch.where(mine, ll, 0.0)], dim=-1))
        lse = top + torch.log(both[..., 0])
        ll = both[..., 1]
    nll = (lse - ll).mean()
    zl = (lse ** 2).mean()
    return nll + z_loss * zl, {"nll": nll, "z_loss": zl}


class ReproModel:
    """One model configuration on one device.  ``device`` defaults to
    ``cuda`` and raises without a card; ``device="cpu"`` runs the kernels'
    plain versions; ``device="meta"`` (with ``hw`` given) holds shapes
    only, for the dry-run: its trees allocate nothing and a step raises.

    ``mesh`` (the JAX package's ``mesh=``): an ``AbstractMesh`` or a
    ``DeviceMesh`` whose axes set the context's ``mesh_axes``, ``dp_size``
    and ``tp_size``.  An ``AbstractMesh`` is the global view (this process
    computes every token: the dry-run, or the moe layer's blocked dispatch
    on one device); a ``DeviceMesh`` is a rank's local view: of its batch
    shard on the data axes, and on a ``"model"`` axis of R > 1 ranks
    (``ctx.tp``, :class:`~repro_torch.distributed.comm.ModelAxis`) of the
    tensor-parallel serving steps, over the rank's shard of the weights
    and pools that ``Engine(mesh=)`` hands it.  There the dense family
    serves with a data axis of one, and its full-sequence forward and loss
    run on a ``(D, R)`` mesh (``ctx.dp``, the data ranks): each rank takes
    its shard of the parameters under ``param_specs`` (FSDP: gathered
    over the data ranks at each call, :meth:`gather_shards`) and of the
    batch.  The dense-cache ``decode_step`` (the reference's decode cell)
    runs on a ``(D, R)`` mesh for the dense, vlm and encdec families: the
    rank takes its batch rows and holds its window of the caches
    (:meth:`init_cache`, :class:`CacheWindow`).  The other families
    across a model axis are refused (ROADMAP A13)."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, shape: ShapeSpec,
                 hw: Optional[HardwareSpec] = None, device="cuda", mesh=None):
        self.device = require_device(device, meta=True)
        if self.device.type == "meta" and hw is None:
            raise ValueError("a meta model needs hw=: the meta device has no "
                             "descriptor of its own")
        self.cfg = cfg
        self.run = run
        self.shape = shape
        mesh_axes, dp_size, tp_size, local = None, 1, 1, False
        if mesh is not None:
            sizes = axis_sizes(mesh)
            mesh_axes = tuple(sizes)
            tp_size = sizes.get("model", 1)
            dp_size = sizes.get("pod", 1) * sizes.get("data", 1)
            local = not isinstance(mesh, AbstractMesh)
            if local and tp_size > 1:
                refuse_across_ranks(cfg, tp_size)
            if local and mesh.device_type != self.device.type:
                raise ValueError(f"the mesh is over {mesh.device_type} devices, "
                                 f"the model on {self.device}")
        dp = DataAxis.of(mesh) if local else None
        self.mesh = mesh if local else None
        self.ctx = MatmulContext(policy=LayoutPolicy(run.layout_policy),
                                 hw=hw or query(self.device),
                                 propagate=run.propagate, mesh_axes=mesh_axes,
                                 dp_size=dp_size, tp_size=tp_size,
                                 moe_local=run.moe_local_dispatch,
                                 dp_local=local,
                                 tp=ModelAxis.of(mesh) if local else None,
                                 dp=dp)
        self.compute_dtype = getattr(torch, run.compute_dtype)

    @property
    def across_ranks(self) -> bool:
        """Whether this process is one rank of several (a ``DeviceMesh``
        with a model or a data axis of more than one rank)."""
        return self.ctx.tp is not None or self.ctx.dp is not None

    def shard_specs(self) -> dict:
        """The parameter tree's specs on this model's mesh
        (``sharding.param_specs`` of the whole tree's shapes, built on the
        meta device), cached."""
        if getattr(self, "_shard_specs", None) is None:
            from repro_torch.distributed import sharding
            self._shard_specs = sharding.param_specs(self.meta_params(),
                                                     self.run, self.mesh)
        return self._shard_specs

    def meta_params(self) -> dict:
        """The whole parameter tree's paths, shapes and dtypes on the meta
        device (nothing allocated)."""
        gen = MetaGenerator()
        if self.cfg.family == "encdec":
            return encdec_mod.encdec_init(
                gen, self.cfg, self.run, max_src=max(self.enc_len, 8),
                max_tgt=max(self.shape.seq_len, 8))
        return tfm.lm_init(gen, self.cfg, self.run)

    def fsdp_cuts(self) -> dict:
        """``{path: (dim, lo, hi, total)}``: each leaf the rules cut over the
        data ranks (FSDP), the dim, this rank's element range of it and its
        extent (a linear's weight in whole tiles, as ``shard_params`` cuts
        it); empty without a data axis or with ``run.fsdp`` off.  Cached."""
        if getattr(self, "_fsdp_cuts", None) is not None:
            return self._fsdp_cuts
        from repro_torch.distributed import sharding
        cuts = {}
        if self.ctx.dp is not None:
            dims = tuple(a for a in ("pod", "data")
                         if axis_sizes(self.mesh).get(a, 1) > 1)
            coord = sharding.mesh_coord(self.mesh)
            specs = sharding.tree_paths(self.shard_specs())
            for path, (leaf, units) in sharding.leaf_units(
                    self.meta_params(), self.ctx.layout).items():
                for d, entry in enumerate(sharding._full(specs[path], leaf.ndim)):
                    axes = sharding._axes(entry)
                    if not set(axes) & set(dims):
                        continue
                    if tuple(a for a in axes if a in dims) != dims or "model" in axes:
                        raise NotImplementedError(
                            f"{path}: a dim cut over {axes}; the port's FSDP "
                            f"gathers over the data ranks {dims} alone")
                    n = leaf.shape[d]
                    lo, hi = sharding.unit_range(-(-n // units[d]), entry,
                                                 self.mesh, coord)
                    cuts[path] = (d, min(n, lo * units[d]), min(n, hi * units[d]), n)
        self._fsdp_cuts = cuts
        return cuts

    def gather_shards(self, params: dict) -> dict:
        """The parameters as this rank's products use them: every leaf FSDP
        cuts over the data ranks (:meth:`fsdp_cuts`) gathered whole there,
        one collective a dtype, whose gradient is reduce-scattered back
        into the rank's shard (``DataAxis.gather_shards``); the model axis's
        cuts (``w_split``) stay.  Without such cuts, ``params`` itself."""
        cuts = self.fsdp_cuts()
        if not cuts:
            return params
        from repro_torch.distributed import sharding
        flat = sharding.tree_paths(params)
        by_dtype = {}
        for path, (d, lo, hi, n) in cuts.items():
            t = flat.get(path)
            if t is None:
                raise KeyError(f"{path}: missing from the parameters")
            if t.shape[d] != hi - lo:
                raise ValueError(f"{path}: {tuple(t.shape)} is not this rank's "
                                 f"FSDP shard ({hi - lo} of dim {d}'s {n}); "
                                 f"across data ranks the model takes the "
                                 f"shards of from_jax_params(mesh=)")
            by_dtype.setdefault(t.dtype, []).append(path)
        out = dict(flat)
        for paths in by_dtype.values():
            wholes = self.ctx.dp.gather_shards(
                [flat[p] for p in paths],
                [(cuts[p][0], cuts[p][1], cuts[p][3]) for p in paths])
            out.update(zip(paths, wholes))
        return sharding._unflatten_like(params, out)

    @property
    def text_len(self) -> int:
        s = self.shape.seq_len
        if self.cfg.family == "vlm":
            return s - self.cfg.vision_tokens
        return s

    @property
    def enc_len(self) -> int:
        """Encoder frames of a ``seq_len`` cell (encdec)."""
        return self.shape.seq_len // self.cfg.audio_downsample

    def input_specs(self, kind: Optional[str] = None) -> dict:
        """Every model input of this cell as a meta tensor (its shape and
        dtype; the JAX package's ``ShapeDtypeStruct``): tokens (and labels,
        frames) for ``train`` and ``prefill``; for ``decode`` the caches (a
        tree of meta tensors), one token per row and the 0-d position.
        Nothing is allocated."""
        kind = kind or self.shape.kind
        b, s, d = self.shape.global_batch, self.shape.seq_len, self.cfg.d_model
        i32, f = torch.int32, self.compute_dtype

        def spec(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        if kind in ("train", "prefill"):
            specs = {"tokens": spec((b, self.text_len), i32)}
            if kind == "train":
                specs["labels"] = spec((b, self.text_len), i32)
            if self.cfg.family == "encdec":
                specs["frames"] = spec((b, self.enc_len, d), f)
            if self.cfg.family == "vlm":
                specs["patches"] = spec((b, self.cfg.vision_tokens, d), f)
            return specs
        return {"caches": self.init_cache(b, s, device="meta"),
                "token": spec((b, 1), i32), "pos": spec((), i32)}

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters with the JAX package's tree, shapes and
        scales, drawn from ``generator`` on its device, then moved to the
        model's.  A CPU generator gives the same weights on every device
        (what a card-against-CPU comparison needs); a CUDA generator draws
        each leaf on the card, which a model of billions of parameters
        needs to start in seconds."""
        if self.cfg.family == "encdec":
            params = encdec_mod.encdec_init(
                generator, self.cfg, self.run, max_src=max(self.enc_len, 8),
                max_tgt=max(self.shape.seq_len, 8))
        else:
            params = tfm.lm_init(generator, self.cfg, self.run)
        return tfm.tree_map(lambda t: t.to(self.device), params)

    def _embeds(self, params: dict, batch: dict) -> torch.Tensor:
        """The token embeddings [B, S, d]; the vlm family prepends
        ``vision_proj`` of ``batch["patches"]`` [B, vision_tokens, d]
        (across ranks column-parallel over ``model``, gathered whole;
        ``params`` with its FSDP shards gathered)."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = embed_apply(params["embed"], tokens).to(self.compute_dtype)
        if self.cfg.family == "vlm":
            patches = torch.as_tensor(batch["patches"], device=self.device)
            vis = linear_apply(params["vision_proj"],
                               patches.to(self.compute_dtype), self.ctx, tp="col")
            x = torch.cat([vis, x], dim=1)
        return x

    def _frames(self, batch: dict) -> torch.Tensor:
        """``batch["frames"]`` on the device in the compute dtype (the
        packed product takes both operands in one dtype)."""
        return torch.as_tensor(batch["frames"], device=self.device).to(
            self.compute_dtype)

    def forward(self, params: dict, batch: dict, last_only: bool = False):
        """Full-sequence forward over ``batch["tokens"]`` [B, S] (a tensor
        or a numpy array; encdec also ``batch["frames"]`` [B, S_enc, d],
        vlm ``batch["patches"]`` [B, vision_tokens, d], whose positions
        come first).  Returns (logits [B, S, V] (vlm: [B, vision_tokens +
        S, V]), or [B, 1, V] for the last position with ``last_only``,
        aux)."""
        return self._forward(params, batch, last_only, True)

    def _forward(self, params: dict, batch: dict, last_only: bool,
                 gather: bool):
        """:meth:`forward`; across ranks over the rank's shards (FSDP's
        gathered first), the logits gathered whole over the model ranks
        unless ``gather`` is False (then the rank's vocab columns)."""
        params = self.gather_shards(params)
        if self.cfg.family == "encdec":
            tokens = torch.as_tensor(batch["tokens"], device=self.device)
            logits = encdec_mod.encdec_forward(
                params, {"tokens": tokens, "frames": self._frames(batch)},
                self.ctx, self.cfg, self.run)
            return (logits[:, -1:] if last_only else logits), dict(tfm.AUX_ZERO)
        x = self._embeds(params, batch)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        logits, _, aux = tfm.lm_apply(params, x, self.ctx, self.cfg, self.run,
                                      positions=positions, last_only=last_only,
                                      gather_logits=gather)
        return logits, aux

    def loss(self, params: dict, batch: dict):
        """(loss, metrics): next-token cross-entropy of ``batch["labels"]``
        plus the z-loss (``run.z_loss``); metrics {"nll", "z_loss", "loss"}.
        The vlm family's vision positions carry no label.  A moe model adds
        ``router_aux_weight`` x the load balance and ``router_z_weight`` x
        the router z-loss, its aux losses (and ``dropped_frac``) among the
        metrics.  Across ranks: the loss of this rank's batch shard, over
        its parameter shards; the head's logits stay split over the model
        ranks, the cross-entropy spanning them (:func:`_xent`)."""
        tp = self.ctx.tp
        lo = (None if tp is None or self.cfg.family == "encdec"
              else tfm.head_columns(params, self.ctx, self.cfg))
        logits, aux = self._forward(params, batch, False, lo is None)
        if self.cfg.family == "vlm":
            logits = logits[:, self.cfg.vision_tokens:]
        labels = torch.as_tensor(batch["labels"], device=self.device)
        loss, metrics = _xent(logits, labels, self.run.z_loss,
                              None if lo is None else tp, lo)
        if self.cfg.moe:
            loss = (loss + self.cfg.router_aux_weight * aux["load_balance"]
                    + self.cfg.router_z_weight * aux["router_z"])
            metrics.update(aux)
        metrics["loss"] = loss
        return loss, metrics

    def _seq_axis(self, entry) -> Optional[Any]:
        """The ranks a cache dim is cut over under the spec ``entry``: the
        model's own :class:`ModelAxis` or data axis where the entry's mesh
        dims of more than one rank are theirs, else a :class:`SeqAxis`
        over them (made once per model: a new process group is a
        collective of every rank); None where they hold one rank."""
        from repro_torch.distributed import sharding
        sizes = axis_sizes(self.mesh)
        dims = tuple(a for a in sizes if a in sharding._axes(entry)
                     and sizes[a] > 1)
        if not dims:
            return None
        if dims == ("model",):
            return self.ctx.tp
        if dims == tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1):
            return self.ctx.dp
        axes = self.__dict__.setdefault("_seq_axes", {})
        if dims not in axes:
            axes[dims] = SeqAxis.of(self.mesh, dims)
        return axes[dims]

    @property
    def rank_axes(self) -> list:
        """Every axis of ranks this model's collectives run over (for their
        ``calls`` and ``bytes`` counts)."""
        out = [a for a in (self.ctx.tp, self.ctx.dp) if a is not None]
        return out + list(self.__dict__.get("_seq_axes", {}).values())

    def cache_window(self, batch: int, max_len: int,
                     enc_len: Optional[int] = None) -> CacheWindow:
        """This rank's :class:`CacheWindow` of dense caches of ``batch``
        rows and ``max_len`` positions (whisper's cross K/V: ``enc_len``
        encoder positions, ``max_len / audio_downsample`` by default), as
        ``sharding.cache_specs`` cut them on the model's mesh: the batch
        over the data ranks where it divides them, the sequence over
        ``model`` (or over the data and model ranks where the batch does
        not divide), a dim that its axes do not divide left whole.  The
        heads over ``model`` (``seq_shard_kv=False``) are refused."""
        from repro_torch.distributed import sharding
        if not self.run.seq_shard_kv:
            raise NotImplementedError(
                f"the dense decode caches' heads over 'model' "
                f"(seq_shard_kv=False); ROADMAP {ACROSS_RANKS['heads']}")
        cfg = self.cfg
        groups = cfg.n_layers // tfm.pattern_period(cfg)
        enc_len = max_len // cfg.audio_downsample if enc_len is None else enc_len

        def leaf(n):
            return torch.empty((groups, batch, n, cfg.n_kv_heads, cfg.d_head),
                               device="meta")

        kv, cross = {"p0": {"kv": {"k": leaf(max_len)}}}, {"p0": {"k": leaf(enc_len)}}
        like = ({"layers": kv, "cross": cross} if cfg.family == "encdec"
                else kv)
        specs = sharding.tree_paths(sharding.cache_specs(like, self.mesh,
                                                         self.run, batch))
        coord = sharding.mesh_coord(self.mesh)

        def window(path, t):
            spec = sharding._full(specs[path], t.ndim)
            rng = sharding.leaf_window(t.shape, spec, self.mesh, coord)
            axis = self._seq_axis(spec[2])
            return rng[1], (None if axis is None
                            else SeqWindow(rng[2][0], t.shape[2], axis))

        if cfg.family != "encdec":
            rows, seq = window("p0/kv/k", kv["p0"]["kv"]["k"])
            return CacheWindow(batch, rows, seq, None)
        rows, seq = window("layers/p0/kv/k", kv["p0"]["kv"]["k"])
        return CacheWindow(batch, rows, seq,
                           window("cross/p0/k", cross["p0"]["k"])[1])

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        """The dense decode caches of the static batch loop, zero: stacked
        ``[G, batch, max_len, Hkv, dh]`` K/V per attention slot of the
        pattern, ``[G, batch, ...]`` state per recurrent one; encdec
        ``{"layers": those, "cross": [G, batch, max_len / 4, Hkv, dh]}``.
        Across ranks (a ``DeviceMesh``) the rank's windows of them, a
        :class:`RankCaches` carrying its :meth:`cache_window`."""
        dev = self.device if device is None else device
        dt = self.compute_dtype
        win = self.cache_window(batch, max_len) if self.across_ranks else None
        rows = batch if win is None else win.rows[1] - win.rows[0]
        layers = tfm.init_layer_caches(self.cfg, rows,
                                       _held(max_len, None if win is None
                                             else win.seq),
                                       dt, dev)
        if self.cfg.family != "encdec":
            return layers if win is None else RankCaches(layers, win)
        groups = self.cfg.n_layers // tfm.pattern_period(self.cfg)
        shp = (groups, rows,
               _held(max_len // self.cfg.audio_downsample,
                     None if win is None else win.cross),
               self.cfg.n_kv_heads, self.cfg.d_head)
        cross = {name: {k: torch.zeros(shp, dtype=dt, device=dev)
                        for k in ("k", "v")} for name in layers}
        tree = {"layers": layers, "cross": cross}
        return tree if win is None else RankCaches(tree, win)

    def prefill_cache(self, params: dict, batch: dict,
                      into: Optional[dict] = None) -> dict:
        """The caches a static batch decodes from: zero dense caches at
        ``seq_len`` (whisper: with the cross K/V of its encoder over
        ``batch["frames"]``).  With ``into`` (caches of the same shapes,
        the cross K/V's at ``frames``' length) they are zeroed and filled
        in place instead of allocated.  Across ranks the rank's windows
        (:meth:`init_cache`): whisper's encoder runs over the rank's rows
        of the frames, and the rank keeps its window of the cross K/V."""
        b = torch.as_tensor(batch["tokens"]).shape[0]
        if into is None:
            caches = self.init_cache(b, self.shape.seq_len)
        else:
            caches = into
            tfm.tree_map(lambda t: t.zero_(),
                         caches["layers"] if self.cfg.family == "encdec"
                         else caches)
        if self.cfg.family == "encdec":
            frames = self._frames(batch)
            window = None
            if self.across_ranks:
                win = self.cache_window(b, self.shape.seq_len, frames.shape[1])
                caches.window = win
                frames, window = frames[win.rows[0]:win.rows[1]], win.cross
                params = self.gather_shards(params)
            enc_out = encdec_mod.encode(params, frames, self.ctx, self.cfg,
                                        self.run)
            cross = encdec_mod.compute_cross_kv(params, enc_out, self.ctx,
                                                self.cfg, window)
            if into is None:
                caches["cross"] = cross
            else:
                for name, kv in cross.items():
                    for k, t in kv.items():
                        caches["cross"][name][k].copy_(t)
        return caches

    def decode_step(self, params: dict, caches: dict, token: torch.Tensor,
                    pos: torch.Tensor, embeds: Optional[torch.Tensor] = None):
        """Token step(s) against the dense cache: ``token`` [B, s] at
        positions ``pos ..`` (s = 1 decode, s > 1 a prefill into the
        cache); ``pos`` a 0-d integer tensor on the device (the step reads
        it on the device only); ``embeds`` [B, s, d] stands for the token
        embeddings (the vlm family's patch prefix).  The caches are written
        in place.  Returns (logits [B, s, V], caches).

        Across ranks (the reference's decode cell): ``token`` and
        ``embeds`` are the global batch, of which the rank takes its rows
        (``batch_specs``: all of them where the batch does not divide the
        data ranks); ``caches`` are the rank's windows (a
        :class:`RankCaches` of :meth:`init_cache` or :meth:`prefill_cache`);
        the FSDP shards are gathered for the call (:meth:`gather_shards`);
        the logits are the rank's rows over the whole vocab, the same on
        every rank of the model axis."""
        windows = (None, None)
        if self.across_ranks:
            win = getattr(caches, "window", None)
            if win is None:
                raise ValueError("across ranks decode_step takes the rank's "
                                 "windows of the caches: a RankCaches of "
                                 "init_cache or prefill_cache")
            if token.shape[0] != win.batch:
                raise ValueError(f"a batch of {token.shape[0]} rows against "
                                 f"caches made for {win.batch}")
            lo, hi = win.rows
            token = token[lo:hi]
            embeds = None if embeds is None else embeds[lo:hi]
            params = self.gather_shards(params)
            windows = (win.seq, win.cross)
        if self.cfg.family == "encdec":
            return encdec_mod.encdec_decode_step(params, caches, token, pos,
                                                 self.ctx, self.cfg, self.run,
                                                 windows)
        if embeds is None:
            x = embed_apply(params["embed"], token).to(self.compute_dtype)
        else:
            x = embeds.to(self.compute_dtype)
        positions = pos + torch.arange(x.shape[1], dtype=pos.dtype,
                                       device=x.device)
        logits, _, _ = tfm.lm_apply(params, x, self.ctx, self.cfg, self.run,
                                    positions=positions, caches=caches,
                                    cache_pos=pos, kv_window=windows[0])
        return logits, caches

    def init_paged_cache(self, num_pages: int, page_tokens: int,
                         slots: int) -> dict:
        """The continuous-batching caches, zero: the attention layers'
        shared K/V page pools ``[G, P, T, Hkv, dh]`` (page 0 = trash) and
        the recurrent layers' per-slot state ``[G, slots, ...]``."""
        return tfm.init_paged_caches(self.cfg, num_pages, page_tokens, slots,
                                     self.compute_dtype, self.device)

    def paged_decode_step(self, params: dict, caches: dict, token: torch.Tensor,
                          block_tables: torch.Tensor, lens: torch.Tensor,
                          new_counts: torch.Tensor,
                          logits_idx: Optional[torch.Tensor] = None,
                          kv_shard: Optional[tuple] = None):
        """The continuous-batching ``[B, s]`` step: row ``b`` carries
        ``new_counts[b]`` new tokens at positions ``lens[b]..`` (1 for a
        decode row, a prompt chunk for a prefill row, 0 for an inert row
        whose writes go to the trash page).  ``block_tables`` [B, MP];
        ``logits_idx`` [B, K] within-row positions to read logits at, or
        None for each row's last valid token.  Returns (logits [B, K, V],
        caches), K = 1 when ``logits_idx`` is None.  The pools in
        ``caches`` are updated in place; the returned ``caches`` is the
        same object.  ``kv_shard``: across ranks, the global pages
        ``(page_lo, page_count)`` this rank's pools hold
        (``models/attention.py``); None: the pools are whole."""
        x = embed_apply(params["embed"], token).to(self.compute_dtype)
        positions = lens[:, None] + torch.arange(token.shape[1], dtype=lens.dtype,
                                                 device=token.device)
        paged = {"block_tables": block_tables, "lens": lens,
                 "new_counts": new_counts, "kv_shard": kv_shard}
        logits_at = (torch.clamp(new_counts - 1, min=0) if logits_idx is None
                     else logits_idx)
        logits, _, _ = tfm.lm_apply(params, x, self.ctx, self.cfg, self.run,
                                    positions=positions, caches=caches,
                                    paged=paged, logits_at=logits_at)
        return logits, caches

    def flat_decode_step(self, params: dict, caches: dict, token: torch.Tensor,
                         block_tables: torch.Tensor, row_ids: torch.Tensor,
                         q_pos: torch.Tensor, logits_idx: torch.Tensor,
                         plan: Optional[RaggedPlan] = None,
                         kv_shard: Optional[tuple] = None):
        """One flat ``[1, W]`` step: position ``i`` is token ``q_pos[i]`` of
        engine row ``row_ids[i]`` (-1 = padding); ``block_tables`` [B, MP];
        ``logits_idx`` [K] flat positions to read logits at; ``plan``: the
        ragged-attention plan of row_ids/q_pos on this device (needed on
        the card, ignored on the CPU); ``kv_shard`` as for
        :meth:`paged_decode_step`.  Returns (logits [1, K, V], caches).

        The page pools in ``caches`` are updated in place (the JAX package
        donates them to its jitted step instead); the returned ``caches``
        is the same object."""
        x = embed_apply(params["embed"], token).to(self.compute_dtype)
        paged = {"block_tables": block_tables, "row_ids": row_ids,
                 "q_pos": q_pos, "plan": plan, "kv_shard": kv_shard}
        logits, _, _ = tfm.lm_apply(params, x, self.ctx, self.cfg, self.run,
                                    positions=q_pos[None, :], caches=caches,
                                    paged=paged, logits_at=logits_idx[None, :])
        return logits, caches

    @property
    def trace_counts(self) -> dict:
        """Distinct step signatures made per step kind over this model (the
        JAX package's traces), on the CPU and the card alike; the card's
        graphs are counted per engine, in ``GraphTable.captures``.  No
        growth after ``Engine.warmup`` is the no-compile contract.  A
        ``"train"`` entry appears with the first train step signature
        (:class:`repro_torch.training.step.CompiledTrainStep`); the JAX
        package counts its jitted train steps apart, so a model that never
        trained keeps the reference's three kinds."""
        if not hasattr(self, "_trace_counts"):
            self._trace_counts = {"decode": 0, "paged": 0, "flat": 0}
        return self._trace_counts

    @property
    def trace_log(self) -> list:
        """One entry per program made: ``{"kind", "args"}``, ``args``
        mapping each step input to its (shape, dtype), or None."""
        if not hasattr(self, "_trace_log"):
            self._trace_log = []
        return self._trace_log

    @property
    def capture_stream(self) -> torch.cuda.Stream:
        """The side stream every CUDA graph over this model is captured on,
        after its eager warmup there (:func:`capture_graph`): one per model
        and not per owner of graphs, since cuBLAS keeps a workspace for
        every stream it runs on until the process ends."""
        if getattr(self, "_capture_stream", None) is None:
            self._capture_stream = torch.cuda.Stream(self.device)
        return self._capture_stream

    def compiled_step(self, kind: str) -> "CompiledStep":
        """The cached compiled form of the ``"decode"``, ``"paged"`` or
        ``"flat"`` step,
        shared by every engine over this model (the JAX package's
        ``jit_step``)."""
        if not hasattr(self, "_steps"):
            self._steps = {}
        if kind not in self._steps:
            self._steps[kind] = CompiledStep(self, kind)
        return self._steps[kind]


_ARG_NAMES = {"decode": ("token", "pos", "embeds"),
              "paged": ("token", "block_tables", "lens", "new_counts",
                        "logits_idx"),
              "flat": ("token", "block_tables", "row_ids", "q_pos",
                       "logits_idx")}


class _Graph:
    """One captured step: the graph, its static inputs (the step copies
    each call's inputs into them), its output, and the counts its kernel
    launches add to the wrappers' (:mod:`repro_torch.kernels`) per replay."""

    def __init__(self, graph, inputs, plan, out, counts):
        self.graph, self.inputs, self.plan = graph, inputs, plan
        self.out, self.counts = out, counts


class GraphTable:
    """The CUDA graphs of one owner's compiled steps (an engine's, or a
    model-backed drafter's), by step signature, with the memory pool they
    were captured into and ``captures``, the graphs captured per step
    kind.  Its graphs hold the addresses of one set of parameters and of
    one cache tree per step kind and set of cache shapes, which the first
    capture over them binds; a call with others raises.  Dropping the table frees the
    graphs, their static buffers and their pool."""

    def __init__(self):
        self.graphs = {}
        self.captures = {"decode": 0, "paged": 0, "flat": 0}
        self.pool = None
        self.param_ptrs = None
        self.cache_ptrs = {}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class CompiledStep:
    """A step kind run as one program per signature: the kind, each
    input's shape and dtype (None stays None), the shapes of the cache
    tree's pools, and the ragged plan's shape and split count (the
    kernel's grid and cluster).  The first call of a signature over the
    model counts as its trace, on every device.

    On the CPU every call runs eagerly.  On the card a call looks its
    signature up in the caller's :class:`GraphTable`; the first call of a
    signature there runs eagerly (which also sets each kernel's launch
    attributes before any capture), then captures the step into a CUDA
    graph over copies of its inputs, into the table's memory pool
    (:func:`capture_graph`).  Each later call copies its
    inputs into the graph's buffers, replays it and returns the graph's
    own output tensor, which the next replay overwrites: read it first.  A
    capture that fails raises; nothing falls back to the eager step."""

    def __init__(self, model: ReproModel, kind: str):
        # a weak reference: the model holds its compiled steps, and without
        # a cycle a dropped model (and its graphs) is freed at once
        self._model = weakref.ref(model)
        self.kind = kind
        self._seen = set()

    @property
    def model(self) -> ReproModel:
        return self._model()

    @property
    def fn(self):
        """The eager step method this step compiles."""
        return {"decode": self.model.decode_step,
                "paged": self.model.paged_decode_step,
                "flat": self.model.flat_decode_step}[self.kind]

    def signature(self, args, plan, caches=None) -> tuple:
        """The kind, each input's (shape, dtype), the cache leaves' shapes
        and the plan's shape and split count."""
        return (self.kind,
                tuple(None if a is None else (tuple(a.shape), a.dtype)
                      for a in args),
                None if caches is None else
                tuple(tuple(t.shape) for t in _leaves(caches)),
                None if plan is None else (tuple(plan.items.shape), plan.splits))

    def __call__(self, params: dict, caches: dict, *args,
                 plan: Optional[RaggedPlan] = None,
                 graphs: Optional[GraphTable] = None,
                 kv_shard: Optional[tuple] = None):
        """``args``: the step method's inputs after ``caches``; ``graphs``:
        the caller's graph table (needed on the card).  Returns (logits,
        caches) as the step method does.  Across ranks (the model's
        ``ctx.tp`` or ``ctx.dp``) every call runs eagerly, on the card too: the gloo
        collectives between its kernels cannot be captured
        (:func:`capture_graph` refuses them), and ``kv_shard`` (the rank's
        pages) goes to the step method."""
        sig = self.count(args, plan, caches)
        if self.model.device.type == "cpu" or self.model.across_ranks:
            extra = {} if plan is None else {"plan": plan}
            if kv_shard is not None:
                extra["kv_shard"] = kv_shard
            if plan is not None and self.model.device.type != "cpu":
                extra["plan"] = plan.to(self.model.device)
            return self.fn(params, caches, *(None if a is None else
                                             a.to(self.model.device)
                                             for a in args), **extra)
        if graphs is None:
            raise ValueError("a compiled step on the card needs the caller's "
                             "GraphTable (graphs=)")
        param_ptrs = tuple(t.data_ptr() for t in _leaves(params))
        cache_ptrs = tuple(t.data_ptr() for t in _leaves(caches))
        if graphs.param_ptrs is None:
            graphs.param_ptrs = param_ptrs
        # a recurrent model's static and paged caches can share shapes
        bound = graphs.cache_ptrs.setdefault((self.kind, sig[2]), cache_ptrs)
        if graphs.param_ptrs != param_ptrs or bound != cache_ptrs:
            raise ValueError("this GraphTable's graphs were captured over "
                             "other parameters or caches; each engine keeps "
                             "its own table")
        g = graphs.graphs.get(sig)
        if g is None:
            out, graphs.graphs[sig] = self._capture(graphs, params, caches,
                                                    args, plan)
            graphs.captures[self.kind] += 1
            return out, caches
        for buf, a in zip(g.inputs, args):
            if buf is not None:
                buf.copy_(a)
        if g.plan is not None:
            g.plan.items.copy_(torch.as_tensor(plan.items))
        g.graph.replay()
        kernels.add_counts(g.counts)
        return g.out, caches

    def count(self, args, plan=None, caches=None) -> tuple:
        """Count a call's signature as a trace the first time it is seen,
        and return it; a caller that runs :attr:`fn` itself counts its
        calls here."""
        sig = self.signature(args, plan, caches)
        if sig in self._seen:
            return sig
        self._seen.add(sig)
        self.model.trace_counts[self.kind] += 1
        self.model.trace_log.append({"kind": self.kind, "args": {
            name: None if a is None else (tuple(a.shape), str(a.dtype))
            for name, a in zip(_ARG_NAMES[self.kind], args)}})
        return sig

    def _capture(self, table: GraphTable, params, caches, args, plan):
        dev = self.model.device
        if table.pool is None:
            table.pool = torch.cuda.graph_pool_handle()
        inputs = [None if a is None else a.to(dev, copy=True) for a in args]
        splan = None if plan is None else RaggedPlan(
            torch.as_tensor(plan.items).to(dev, copy=True), plan.splits)
        extra = {} if splan is None else {"plan": splan}
        cap = capture_graph(self.model, table.pool,
                            lambda: self.fn(params, caches, *inputs, **extra)[0])
        return cap.eager, _Graph(cap.graph, inputs, splan, cap.out, cap.counts)


class Capture(NamedTuple):
    """What :func:`capture_graph` made: the warmup call's result, the
    graph, the captured call's result (tensors the graph owns and each
    replay overwrites), the wrappers' counts one replay adds, and the host
    seconds the capture took (the warmup not included)."""
    eager: Any
    graph: torch.cuda.CUDAGraph
    out: Any
    counts: dict
    seconds: float


def capture_graph(model: ReproModel, pool, fn: Callable) -> Capture:
    """Call ``fn()`` eagerly on the model's :attr:`~ReproModel.capture_stream`,
    then capture a second call of it there into a CUDA graph whose memory
    comes from ``pool``.  The eager call is the capture's warmup: it sets
    each kernel's launch attributes and cuBLAS's workspace on the stream,
    which a capture may not allocate.  A capture runs nothing, so the
    wrappers' counts it added are taken back and returned for the replays
    to add.  A capture that fails raises, and so does one of a model
    across ranks (its collectives are host work under gloo; under NCCL the
    capture is queued)."""
    if model.across_ranks:
        raise NotImplementedError(
            f"a CUDA graph of a step across ranks "
            f"({model.ctx.tp or model.ctx.dp}): a gloo collective cannot be captured, and "
            f"capture with NCCL is ROADMAP {ACROSS_RANKS['nccl']}; the "
            f"engine runs such steps uncaptured")
    dev = model.device
    s = model.capture_stream
    s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s):
        eager = fn()
        before = kernels.counters()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # no cyclic garbage collection inside the capture: it could
        # destroy a dropped owner's graphs, and releasing their pool frees
        # device memory, which a capture forbids.  disable() stops the
        # automatic collections; freeze() puts every object tracked now out
        # of reach of a gc.collect() another thread makes meanwhile
        collecting = gc.isenabled()
        gc.disable()
        gc.freeze()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=s):
                out = fn()
        finally:
            gc.unfreeze()
            if collecting:
                gc.enable()
        seconds = time.perf_counter() - t0
        after = kernels.counters()
    torch.cuda.current_stream(dev).wait_stream(s)
    counts = {k: after[k] - before[k] for k in after}
    kernels.add_counts(counts, -1)        # the capture ran nothing
    return Capture(eager, graph, out, counts, seconds)


# the queue items (ROADMAP A13) of what the port does not yet serve across
# the ranks of a 'model' axis
ACROSS_RANKS = {
    "data": "A13.1 (the data axis for the engine)",
    "heads": "A13.2 (seq_shard_kv=False: heads over 'model')",
    "moe": "A13.3 (moe across ranks: experts over 'model')",
    "recurrent": "A13.4 (recurrent across ranks: the ssm/state leaves over "
                 "'model')",
    "prefix": "A13.5 (the prefix cache and speculative decode across ranks)",
    "nccl": "A13.6 (graph capture with NCCL on a host with a card a rank)",
    "train": "A13.7 (the Trainer and checkpoints across ranks)",
    "unpacked": "A13.9 (unpacked weights across ranks: prepack=False, the "
                "unpacked policy)",
    "train-static": "A13.10 (training the encdec and vlm families across "
                    "ranks)",
}


def refuse_across_ranks(cfg: ModelConfig, ranks: int,
                        where: Optional[str] = None,
                        training: bool = False) -> None:
    """Raise ``NotImplementedError``, naming its ROADMAP item, for a
    config the port does not serve or (``training``) train across
    ``ranks`` ranks: the moe and recurrent families, and in training the
    encdec and vlm families too."""
    what = None
    if any(t != "attn" for t in cfg.layer_types):
        what = "recurrent"
    elif cfg.moe:
        what = "moe"
    elif training and cfg.family in ("encdec", "vlm"):
        what = "train-static"
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}) on "
            f"{where or f'a {chr(39)}model{chr(39)} axis of {ranks} ranks'}: "
            f"the port serves the dense, vlm and encdec families and trains "
            f"the dense family across ranks; ROADMAP {ACROSS_RANKS[what]}")


def _held(n: int, window: Optional[SeqWindow]) -> int:
    """The positions of ``n`` a rank holds in ``window`` (all without)."""
    return n if window is None else window.held


class MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` is the meta device.  The model's
    init draws every leaf with ``device=generator.device``, so through it
    the init builds the parameter tree's paths, shapes and dtypes and
    allocates nothing (drawing from a CPU generator onto meta is allowed):
    the dry-run's trees and the analyzer's fake engines."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def build_model(cfg: ModelConfig, run: RunConfig, shape: ShapeSpec,
                hw: Optional[HardwareSpec] = None, device="cuda",
                mesh=None) -> ReproModel:
    return ReproModel(cfg, run, shape, hw, device=device, mesh=mesh)
