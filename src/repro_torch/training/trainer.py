"""Fault-tolerant training loop (the JAX package's ``training/trainer.py``).

The step is a :class:`~repro_torch.training.step.CompiledTrainStep`, as the
JAX package jits its step and donates the state to it: eager on the CPU,
one CUDA graph per signature on the card, the state updated in place.
The step counter stays a host int that the loop advances.

- auto-resume: on start, restore the latest *valid* checkpoint (partial or
  corrupt saves are skipped) and continue bitwise: the data pipeline is a
  pure function of the step counter, so there is no separate cursor state;
- atomic checkpoints every ``ckpt_every`` steps and at the end, keeping
  the last ``keep``;
- config fingerprinting: a restored checkpoint must match the model/run
  fingerprint (the JAX package's hash of equal configs);
- straggler watchdog: an EWMA of each step's wall time (host clock, after
  the loss is read back, which waits for the whole step on the device); a
  step slower than ``straggler_factor`` times the EWMA is logged and
  counted; every step's time is kept in ``step_ms``;
- ``fail_at`` injects a crash before a step, for restart drills.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from typing import Callable, Optional

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import compression
from repro_torch.training.optimizer import make_optimizer
from repro_torch.training.step import CompiledTrainStep
from repro_torch.training.train_state import TrainState

__all__ = ["Trainer", "fingerprint_of"]


def _to_device(tree, device):
    """A copy of a nested dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device, copy=True)


def fingerprint_of(cfg, run: RunConfig) -> str:
    blob = json.dumps({"cfg": dataclasses.asdict(cfg),
                       "run": dataclasses.asdict(run)}, sort_keys=True)
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


class Trainer:
    def __init__(self, model, data: SyntheticLM, run: RunConfig, *,
                 ckpt_dir: Optional[str] = None, total_steps: int = 1000,
                 ckpt_every: int = 50, keep: int = 3,
                 straggler_factor: float = 3.0,
                 log_fn: Callable[[str], None] = print):
        self.model = model
        self.data = data
        self.run = run
        self.ckpt_dir = ckpt_dir
        self.total_steps = total_steps
        self.ckpt_every = ckpt_every
        self.keep = keep
        self.straggler_factor = straggler_factor
        self.log = log_fn
        self.optimizer = make_optimizer(run, total_steps)
        self.fingerprint = fingerprint_of(model.cfg, run)
        if getattr(model, "across_ranks", False):
            from repro_torch.models.model import ACROSS_RANKS
            raise NotImplementedError(
                f"a Trainer across ranks: make_train_step trains the rank's "
                f"shards; the Trainer and its checkpoints across ranks are "
                f"ROADMAP {ACROSS_RANKS['train']}")
        self.step_fn = CompiledTrainStep(model, self.optimizer, run)
        self.ewma_ms: Optional[float] = None
        self.straggler_events = 0
        self.step_ms: list[float] = []

    def init_state(self, generator: torch.Generator,
                   params: Optional[dict] = None) -> TrainState:
        """A fresh state: ``params`` (moved to the model's device), or the
        model's init drawn from ``generator``; zero optimizer moments."""
        params = (self.model.init(generator) if params is None
                  else _to_device(params, self.model.device))
        state = TrainState.create(params, self.optimizer)
        if self.run.grad_compression:
            state.opt_state["err"] = compression.init_error_buffer(params)
        return state

    def restore_or_init(self, generator: torch.Generator,
                        params: Optional[dict] = None) -> TrainState:
        if self.ckpt_dir is not None and ckpt.latest_step(self.ckpt_dir) is not None:
            tree, _, step = ckpt.restore(self.ckpt_dir, fingerprint=self.fingerprint,
                                         device=self.model.device)
            self.log(f"[trainer] resumed from step {step}")
            return TrainState(step=step, params=tree["params"],
                              opt_state=tree["opt_state"])
        return self.init_state(generator, params)

    def save(self, state: TrainState) -> None:
        if self.ckpt_dir is None:
            return
        ckpt.save(self.ckpt_dir, int(state.step),
                  {"params": state.params, "opt_state": state.opt_state},
                  extra={"ewma_ms": self.ewma_ms}, fingerprint=self.fingerprint)
        ckpt.prune(self.ckpt_dir, keep=self.keep)

    def fit(self, generator: torch.Generator, steps: Optional[int] = None,
            fail_at: Optional[int] = None,
            on_step: Optional[Callable[[int], None]] = None,
            params: Optional[dict] = None):
        """Run the loop from the restored (or fresh) state to ``steps`` (by
        default ``total_steps``), calling ``on_step(step)`` after each step's
        loss is read.  A fresh state starts from ``params`` when given (a
        copy: the step updates the state in place), else from the model's
        init drawn from ``generator``.  Returns (state, loss history).  The step's graphs
        bind the state of the first call, so a trainer fits once: a resume
        is a new trainer."""
        state = self.restore_or_init(generator, params)
        start = int(state.step)
        end = steps if steps is not None else self.total_steps
        history = []
        for step in range(start, end):
            batch = self.data.batch_at(step)
            t0 = time.perf_counter()
            if fail_at is not None and step == fail_at:
                raise RuntimeError(f"injected failure at step {step}")
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = (time.perf_counter() - t0) * 1e3
            self.step_ms.append(dt)
            if on_step is not None:
                on_step(step)
            if self.ewma_ms is None:
                self.ewma_ms = dt
            else:
                if dt > self.straggler_factor * self.ewma_ms:
                    self.straggler_events += 1
                    self.log(f"[trainer] straggler step {step}: {dt:.0f}ms "
                             f"(ewma {self.ewma_ms:.0f}ms)")
                self.ewma_ms = 0.9 * self.ewma_ms + 0.1 * dt
            history.append(loss)
            if (step + 1) % self.ckpt_every == 0 or step + 1 == end:
                self.save(state)
        return state, history
