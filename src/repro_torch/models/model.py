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
from repro_torch.kernels.ragged_attn.ops import RaggedPlan
from repro_torch.launch.mesh import AbstractMesh, axis_sizes
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import embed_apply

__all__ = ["ReproModel", "CompiledStep", "GraphTable", "capture_graph", "build_model"]


def _xent(logits: torch.Tensor, labels: torch.Tensor, z_loss: float):
    """Mean next-token cross-entropy plus ``z_loss`` times the mean squared
    log-partition, in float32.  Returns (loss, {"nll", "z_loss"})."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
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
    on one device); a ``DeviceMesh`` is a rank's local view, data-parallel
    only: the rank computes its batch shard with whole weights, so a
    ``"model"`` axis of more than one rank is refused."""

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
                raise NotImplementedError(
                    f"a DeviceMesh with a 'model' axis of {tp_size} ranks: the "
                    f"port's ranks are data-parallel (each computes its batch "
                    f"shard with whole weights); tensor-parallel products "
                    f"across ranks are not implemented")
            if local and mesh.device_type != self.device.type:
                raise ValueError(f"the mesh is over {mesh.device_type} devices, "
                                 f"the model on {self.device}")
        self.ctx = MatmulContext(policy=LayoutPolicy(run.layout_policy),
                                 hw=hw or query(self.device),
                                 propagate=run.propagate, mesh_axes=mesh_axes,
                                 dp_size=dp_size, tp_size=tp_size,
                                 moe_local=run.moe_local_dispatch,
                                 dp_local=local,
                                 dp_group=(_data_group(mesh) if local and dp_size > 1
                                           else None))
        self.compute_dtype = getattr(torch, run.compute_dtype)

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
        ``vision_proj`` of ``batch["patches"]`` [B, vision_tokens, d]."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = embed_apply(params["embed"], tokens).to(self.compute_dtype)
        if self.cfg.family == "vlm":
            patches = torch.as_tensor(batch["patches"], device=self.device)
            vis = linear_apply(params["vision_proj"],
                               patches.to(self.compute_dtype), self.ctx)
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
        if self.cfg.family == "encdec":
            tokens = torch.as_tensor(batch["tokens"], device=self.device)
            logits = encdec_mod.encdec_forward(
                params, {"tokens": tokens, "frames": self._frames(batch)},
                self.ctx, self.cfg, self.run)
            return (logits[:, -1:] if last_only else logits), dict(tfm.AUX_ZERO)
        x = self._embeds(params, batch)
        positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
        logits, _, aux = tfm.lm_apply(params, x, self.ctx, self.cfg, self.run,
                                      positions=positions, last_only=last_only)
        return logits, aux

    def loss(self, params: dict, batch: dict):
        """(loss, metrics): next-token cross-entropy of ``batch["labels"]``
        plus the z-loss (``run.z_loss``); metrics {"nll", "z_loss", "loss"}.
        The vlm family's vision positions carry no label.  A moe model adds
        ``router_aux_weight`` x the load balance and ``router_z_weight`` x
        the router z-loss, its aux losses (and ``dropped_frac``) among the
        metrics."""
        logits, aux = self.forward(params, batch)
        if self.cfg.family == "vlm":
            logits = logits[:, self.cfg.vision_tokens:]
        labels = torch.as_tensor(batch["labels"], device=self.device)
        loss, metrics = _xent(logits, labels, self.run.z_loss)
        if self.cfg.moe:
            loss = (loss + self.cfg.router_aux_weight * aux["load_balance"]
                    + self.cfg.router_z_weight * aux["router_z"])
            metrics.update(aux)
        metrics["loss"] = loss
        return loss, metrics

    def init_cache(self, batch: int, max_len: int, device=None) -> dict:
        """The dense decode caches of the static batch loop, zero: stacked
        ``[G, batch, max_len, Hkv, dh]`` K/V per attention slot of the
        pattern, ``[G, batch, ...]`` state per recurrent one; encdec
        ``{"layers": those, "cross": [G, batch, max_len / 4, Hkv, dh]}``."""
        dev = self.device if device is None else device
        dt = self.compute_dtype
        layers = tfm.init_layer_caches(self.cfg, batch, max_len, dt, dev)
        if self.cfg.family != "encdec":
            return layers
        groups = self.cfg.n_layers // tfm.pattern_period(self.cfg)
        shp = (groups, batch, max_len // self.cfg.audio_downsample,
               self.cfg.n_kv_heads, self.cfg.d_head)
        cross = {name: {k: torch.zeros(shp, dtype=dt, device=dev)
                        for k in ("k", "v")} for name in layers}
        return {"layers": layers, "cross": cross}

    def prefill_cache(self, params: dict, batch: dict,
                      into: Optional[dict] = None) -> dict:
        """The caches a static batch decodes from: zero dense caches at
        ``seq_len`` (whisper: with the cross K/V of its encoder over
        ``batch["frames"]``).  With ``into`` (caches of the same shapes,
        the cross K/V's at ``frames``' length) they are zeroed and filled
        in place instead of allocated."""
        b = torch.as_tensor(batch["tokens"]).shape[0]
        if into is None:
            caches = self.init_cache(b, self.shape.seq_len)
        else:
            caches = into
            tfm.tree_map(lambda t: t.zero_(),
                         caches["layers"] if self.cfg.family == "encdec"
                         else caches)
        if self.cfg.family == "encdec":
            enc_out = encdec_mod.encode(params, self._frames(batch), self.ctx,
                                        self.cfg, self.run)
            cross = encdec_mod.compute_cross_kv(params, enc_out, self.ctx,
                                                self.cfg)
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
        in place.  Returns (logits [B, s, V], caches)."""
        if self.cfg.family == "encdec":
            return encdec_mod.encdec_decode_step(params, caches, token, pos,
                                                 self.ctx, self.cfg, self.run)
        if embeds is None:
            x = embed_apply(params["embed"], token).to(self.compute_dtype)
        else:
            x = embeds.to(self.compute_dtype)
        positions = pos + torch.arange(x.shape[1], dtype=pos.dtype,
                                       device=x.device)
        logits, _, _ = tfm.lm_apply(params, x, self.ctx, self.cfg, self.run,
                                    positions=positions, caches=caches,
                                    cache_pos=pos)
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
                          logits_idx: Optional[torch.Tensor] = None):
        """The continuous-batching ``[B, s]`` step: row ``b`` carries
        ``new_counts[b]`` new tokens at positions ``lens[b]..`` (1 for a
        decode row, a prompt chunk for a prefill row, 0 for an inert row
        whose writes go to the trash page).  ``block_tables`` [B, MP];
        ``logits_idx`` [B, K] within-row positions to read logits at, or
        None for each row's last valid token.  Returns (logits [B, K, V],
        caches), K = 1 when ``logits_idx`` is None.  The pools in
        ``caches`` are updated in place; the returned ``caches`` is the
        same object."""
        x = embed_apply(params["embed"], token).to(self.compute_dtype)
        positions = lens[:, None] + torch.arange(token.shape[1], dtype=lens.dtype,
                                                 device=token.device)
        paged = {"block_tables": block_tables, "lens": lens,
                 "new_counts": new_counts}
        logits_at = (torch.clamp(new_counts - 1, min=0) if logits_idx is None
                     else logits_idx)
        logits, _, _ = tfm.lm_apply(params, x, self.ctx, self.cfg, self.run,
                                    positions=positions, caches=caches,
                                    paged=paged, logits_at=logits_at)
        return logits, caches

    def flat_decode_step(self, params: dict, caches: dict, token: torch.Tensor,
                         block_tables: torch.Tensor, row_ids: torch.Tensor,
                         q_pos: torch.Tensor, logits_idx: torch.Tensor,
                         plan: Optional[RaggedPlan] = None):
        """One flat ``[1, W]`` step: position ``i`` is token ``q_pos[i]`` of
        engine row ``row_ids[i]`` (-1 = padding); ``block_tables`` [B, MP];
        ``logits_idx`` [K] flat positions to read logits at; ``plan``: the
        ragged-attention plan of row_ids/q_pos on this device (needed on
        the card, ignored on the CPU).  Returns (logits [1, K, V], caches).

        The page pools in ``caches`` are updated in place (the JAX package
        donates them to its jitted step instead); the returned ``caches``
        is the same object."""
        x = embed_apply(params["embed"], token).to(self.compute_dtype)
        paged = {"block_tables": block_tables, "row_ids": row_ids,
                 "q_pos": q_pos, "plan": plan}
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
                 graphs: Optional[GraphTable] = None):
        """``args``: the step method's inputs after ``caches``; ``graphs``:
        the caller's graph table (needed on the card).  Returns (logits,
        caches) as the step method does."""
        sig = self.count(args, plan, caches)
        if self.model.device.type == "cpu":
            extra = {} if plan is None else {"plan": plan}
            return self.fn(params, caches, *args, **extra)
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
    to add.  A capture that fails raises."""
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
        # device memory, which a capture forbids
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=s):
                out = fn()
        finally:
            if collecting:
                gc.enable()
        seconds = time.perf_counter() - t0
        after = kernels.counters()
    torch.cuda.current_stream(dev).wait_stream(s)
    counts = {k: after[k] - before[k] for k in after}
    kernels.add_counts(counts, -1)        # the capture ran nothing
    return Capture(eager, graph, out, counts, seconds)


def _data_group(mesh):
    """The process group over a ``DeviceMesh``'s data ranks (its ``pod``
    and ``data`` dims; its ``model`` dim has one rank)."""
    dims = [a for a in ("pod", "data") if axis_sizes(mesh).get(a, 1) > 1]
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    return mesh[tuple(dims)]._flatten().get_group()


def build_model(cfg: ModelConfig, run: RunConfig, shape: ShapeSpec,
                hw: Optional[HardwareSpec] = None, device="cuda",
                mesh=None) -> ReproModel:
    return ReproModel(cfg, run, shape, hw, device=device, mesh=mesh)
