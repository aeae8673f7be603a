"""The train step: loss -> gradients (with microbatch accumulation) ->
optional compression -> AdamW update (the JAX package's
``training/step.py``), and its compiled form, :class:`CompiledTrainStep`
(the JAX package's ``jax.jit(train_step, donate_argnums=(0,))``).

Gradients come from ``torch.autograd.grad`` over the parameter leaves,
through mmt4d's gradient kernels on the card.  With ``run.microbatch = n >
1`` the batch is split into n slices along its first dim, run one after
another, and their gradients summed in float32, each divided by n.  The
step writes the new parameters, moments and error buffer into the state's
own tensors, as the reference's donated state lets XLA do, so a CUDA graph
of the step binds one state for good.  Every family trains: the recurrent
mixers through the backward kernels of wkv6 and selective_scan, the moe
experts through mmt4d's gradient kernels over the expert dim.

Across ranks (a model built on a ``DeviceMesh``: the reference's dry-run
train cell, ``make_train_step`` under ``state_specs`` and
``batch_specs``) the state is the rank's shard (``from_jax_state(mesh=)``)
and the step takes the global batch, of which each rank runs its shard
under ``batch_specs`` (each microbatch's; one the data ranks do not
divide is run whole on each, as the reference replicates it).  Each
rank's loss is its shard's mean, its gradient taken at ``1 / D`` (D data
ranks), so that the sums over the data ranks are the mean's: FSDP's
gathers reduce-scatter the cut leaves' gradients in the backward
(``ReproModel.gather_shards``), and one all-reduce over the data ranks
sums every other leaf's.  The loss and the metrics are the data ranks'
mean; the norm, the 8-bit moments and the compression span the shards
(``optimizer.Ranks``).  The dense family only (the others name their
ROADMAP item); the step runs eagerly: :class:`CompiledTrainStep` refuses
a model across ranks (its gloo collectives cannot be captured).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch import kernels
from repro_torch.configs.base import RunConfig
from repro_torch.models.model import (ACROSS_RANKS, capture_graph,
                                      refuse_across_ranks)
from repro_torch.training import compression
from repro_torch.training.optimizer import AdamW, Ranks, leaves, tree_map
from repro_torch.training.train_state import TrainState

__all__ = ["make_train_step", "make_eval_step", "value_and_grad",
           "CompiledTrainStep"]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it) if isinstance(tree, torch.Tensor) else tree


def value_and_grad(model, params, batch, scale: float = 1.0):
    """((loss, metrics), grads) of ``model.loss`` at ``params``; the
    parameters passed in are not modified and need no ``requires_grad``.
    ``scale``: the gradients are of ``scale`` times the loss (a rank's
    share of the data ranks' mean).  A leaf the loss does not read (a
    rank's empty shard) gets a zero gradient."""
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = model.loss(ps, batch)
        ls = leaves(ps)
        gs = torch.autograd.grad(loss, ls, grad_outputs=torch.full_like(loss, scale),
                                 allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(ls, gs)]
    grads = _rebuild(ps, iter(gs))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), grads


def make_train_step(model, optimizer: AdamW, run: RunConfig) -> Callable:
    """Returns train_step(state, batch, scalars=None) -> (state', metrics).

    ``state'`` holds ``state``'s own tensors, updated in place, and the
    step ``state.step + 1``.  ``scalars``: ``optimizer.scalars(state.step)``
    on the model's device, made here when None (a captured step reads them
    from a buffer its caller fills before each replay).  Across ranks
    (module docstring) ``state`` is the rank's shard and ``batch`` the
    global batch; ``train_step.grads_of(params, batch)`` gives the rank's
    gradients and metrics alone."""
    across = getattr(model, "across_ranks", False)
    dp = model.ctx.dp if across else None
    ranks = None
    if across:
        sizes = (1 if dp is None else dp.size,
                 1 if model.ctx.tp is None else model.ctx.tp.size)
        refuse_across_ranks(model.cfg, sizes[0] * sizes[1],
                            where=f"a (data, model) = {sizes} mesh",
                            training=True)
        ranks = Ranks(dp, model.ctx.tp, model.shard_specs())
    scale = 1.0 if dp is None else 1.0 / dp.size

    def local(mb):
        """The rank's rows of a (micro)batch under ``batch_specs``."""
        if dp is None:
            return mb
        out = {}
        for k, v in mb.items():
            v = torch.as_tensor(v)
            b = v.shape[0]
            if b % dp.size == 0 and b >= dp.size:
                v = v[dp.rank * (b // dp.size):(dp.rank + 1) * (b // dp.size)]
            out[k] = v
        return out

    def grads_of(params, batch):
        n = run.microbatch
        if n <= 1:
            (_, metrics), grads = value_and_grad(model, params, local(batch), scale)
        else:
            b = next(iter(batch.values())).shape[0]
            micro = [{k: v.reshape(n, b // n, *v.shape[1:])[i]
                      for k, v in batch.items()} for i in range(n)]
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for mb in micro:
                (_, metrics), g = value_and_grad(model, params, local(mb), scale)
                grads = tree_map(lambda a, g_: a + g_.float() / n, grads, g)
        if dp is not None:
            _sum_replicated(model, grads, dp)
            metrics = _mean_over(metrics, dp)
        return grads, metrics

    def train_step(state: TrainState, batch, scalars: Optional[torch.Tensor] = None):
        if scalars is None:
            scalars = optimizer.scalars(state.step, model.device)
        grads, metrics = grads_of(state.params, batch)
        if run.grad_compression:
            grads, _ = compression.compress_with_feedback(
                grads, state.opt_state["err"], ranks)
        _, _, opt_metrics = optimizer.update(grads, state.opt_state, state.params,
                                             scalars, ranks=ranks)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=state.opt_state), {**metrics, **opt_metrics}

    train_step.grads_of = grads_of
    return train_step


def _sum_replicated(model, grads, dp) -> None:
    """Sum over the data ranks, in place, every gradient leaf the data
    ranks do not cut (FSDP's cut leaves were reduce-scattered in the
    backward): one all-reduce a dtype, over their concatenation."""
    from repro_torch.distributed import sharding
    cut = model.fsdp_cuts()
    by_dtype = {}
    for path, g in sharding.tree_paths(grads).items():
        if isinstance(g, torch.Tensor) and path not in cut:
            by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = dp.sum_(torch.cat([g.reshape(-1) for g in gs]))
        for g, part in zip(gs, flat.split([g.numel() for g in gs])):
            g.copy_(part.view(g.shape))


def _mean_over(metrics: dict, dp) -> dict:
    """The data ranks' mean of each 0-d metric, in one collective."""
    keys = sorted(metrics)
    dev = next(v.device for v in metrics.values() if isinstance(v, torch.Tensor))
    vals = dp.sum_(torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32,
                                                device=dev) for k in keys]))
    return {k: v / dp.size for k, v in zip(keys, vals.unbind())}


def make_eval_step(model) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model.loss(params, batch)
        return metrics
    return eval_step


def _state_leaves(state: TrainState) -> list:
    return leaves({"params": state.params, "opt_state": state.opt_state})


@dataclasses.dataclass
class _TrainGraph:
    """One captured train step: the graph, its static batch and scalar
    buffers, its metrics (graph-owned), the wrapper counts one replay adds
    and the host seconds of its capture."""
    graph: torch.cuda.CUDAGraph
    inputs: dict
    scalars: torch.Tensor
    out: dict
    counts: dict
    seconds: float


class CompiledTrainStep:
    """The train step run as one program per signature, the state updated
    in place: the JAX package's ``jax.jit(train_step, donate_argnums=(0,))``.

    A signature is each batch leaf's (shape, dtype), ``run.microbatch``,
    the model's ``remat`` and each state leaf's (shape, dtype).  The first
    call of a signature counts as a trace in ``model.trace_counts["train"]``
    and ``model.trace_log``, on every device; each step has its own
    signatures, as each JAX trainer jits its own step.

    On the CPU every call runs :attr:`fn` eagerly.  On the card the first
    call of a signature runs the real step eagerly on the model's capture
    stream (the capture's warmup; it moves the state one step), then
    captures it into a CUDA graph over static batch and scalar buffers and
    the caller's state tensors (:func:`~repro_torch.models.model.capture_graph`;
    a capture runs nothing, so the state stays where the warmup left it).
    Each later call copies the batch in, fills the scalars, replays, adds
    the graph's launches to the wrappers' counts and returns the graph's
    own metrics, which the next replay overwrites: read them first.  Every
    graph binds the state tensors of the first call on the card; a call
    with others raises.  A capture that fails raises; nothing falls back to
    the eager step.  Dropping the step frees its graphs and their pool."""

    def __init__(self, model, optimizer: AdamW, run: RunConfig):
        if getattr(model, "across_ranks", False):
            raise NotImplementedError(
                f"a compiled train step across ranks: a gloo collective "
                f"cannot be captured, and capture with NCCL is ROADMAP "
                f"{ACROSS_RANKS['nccl']}; make_train_step runs the step "
                f"eagerly")
        self.model = model
        self.optimizer = optimizer
        self.run = run
        self.fn = make_train_step(model, optimizer, run)
        self.graphs: dict = {}
        self._seen: set = set()
        self._pool = None
        self._state_ptrs: Optional[tuple] = None

    @property
    def captures(self) -> int:
        return len(self.graphs)

    @property
    def capture_seconds(self) -> float:
        return sum(g.seconds for g in self.graphs.values())

    def signature(self, state: TrainState, batch: dict) -> tuple:
        return (tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items())),
                self.run.microbatch, self.model.run.remat,
                tuple((tuple(t.shape), t.dtype) for t in _state_leaves(state)))

    def count(self, state: TrainState, batch: dict) -> tuple:
        """Count a call's signature as a trace the first time it is seen,
        and return it."""
        sig = self.signature(state, batch)
        if sig not in self._seen:
            self._seen.add(sig)
            counts = self.model.trace_counts
            counts["train"] = counts.get("train", 0) + 1
            self.model.trace_log.append({"kind": "train", "args": {
                k: (tuple(v.shape), str(v.dtype)) for k, v in batch.items()}})
        return sig

    def __call__(self, state: TrainState, batch: dict):
        """``batch``: numpy arrays or tensors on any device.  Returns
        (state', metrics) as :attr:`fn` does."""
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        sig = self.count(state, batch)
        dev = self.model.device
        if dev.type == "cpu":
            return self.fn(state, batch)
        ptrs = tuple(t.data_ptr() for t in _state_leaves(state))
        if self._state_ptrs is None:
            self._state_ptrs = ptrs
        if ptrs != self._state_ptrs:
            raise ValueError("this train step's graphs were captured over "
                             "another state's tensors; a new state needs a "
                             "new step (a new Trainer)")
        g = self.graphs.get(sig)
        if g is None:
            return self._capture(sig, state, batch)
        for k, buf in g.inputs.items():
            buf.copy_(batch[k], non_blocking=True)
        g.scalars.copy_(self.optimizer.scalars(state.step), non_blocking=True)
        g.graph.replay()
        kernels.add_counts(g.counts)
        return TrainState(step=state.step + 1, params=state.params,
                          opt_state=state.opt_state), g.out

    def _capture(self, sig, state: TrainState, batch: dict):
        dev = self.model.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        inputs = {k: v.to(dev, copy=True) for k, v in batch.items()}
        scalars = self.optimizer.scalars(state.step, dev)
        cap = capture_graph(self.model, self._pool,
                            lambda: self.fn(state, inputs, scalars))
        self.graphs[sig] = _TrainGraph(cap.graph, inputs, scalars, cap.out[1],
                                       cap.counts, cap.seconds)
        return cap.eager
