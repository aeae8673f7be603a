"""The train step: loss -> gradients (with microbatch accumulation) ->
optional compression -> AdamW update (the JAX package's
``training/step.py``), run eagerly.

Gradients come from ``torch.autograd.grad`` over the parameter leaves,
through mmt4d's gradient kernels on the card.  With ``run.microbatch = n >
1`` the batch is split into n slices along its first dim, run one after
another, and their gradients summed in float32, each divided by n.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.training import compression
from repro_torch.training.optimizer import AdamW, leaves, tree_map
from repro_torch.training.train_state import TrainState

__all__ = ["make_train_step", "make_eval_step", "value_and_grad"]


def _rebuild(tree, it):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    return next(it)


def value_and_grad(model, params, batch):
    """((loss, metrics), grads) of ``model.loss`` at ``params``; the
    parameters passed in are not modified and need no ``requires_grad``."""
    ps = tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = model.loss(ps, batch)
        gs = torch.autograd.grad(loss, leaves(ps))
    grads = _rebuild(ps, iter(gs))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return (loss.detach(), metrics), grads


def make_train_step(model, optimizer: AdamW, run: RunConfig) -> Callable:
    """Returns train_step(state, batch) -> (state', metrics)."""

    def grads_of(params, batch):
        n = run.microbatch
        if n <= 1:
            (_, metrics), grads = value_and_grad(model, params, batch)
            return grads, metrics
        b = next(iter(batch.values())).shape[0]
        micro = [{k: v.reshape(n, b // n, *v.shape[1:])[i] for k, v in batch.items()}
                 for i in range(n)]
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        for mb in micro:
            (_, metrics), g = value_and_grad(model, params, mb)
            acc = tree_map(lambda a, g_: a + g_.float() / n, acc, g)
        return acc, metrics

    def train_step(state: TrainState, batch) -> tuple:
        grads, metrics = grads_of(state.params, batch)
        opt_state = dict(state.opt_state)
        if run.grad_compression:
            grads, opt_state["err"] = compression.compress_with_feedback(
                grads, opt_state["err"])
        new_params, new_opt, opt_metrics = optimizer.update(
            grads, opt_state, state.params, state.step)
        if run.grad_compression:
            new_opt["err"] = opt_state["err"]
        return TrainState(step=state.step + 1, params=new_params,
                          opt_state=new_opt), {**metrics, **opt_metrics}

    return train_step


def make_eval_step(model) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = model.loss(params, batch)
        return metrics
    return eval_step
