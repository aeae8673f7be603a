"""Model facade: init and the flat serving step.

The port's ``ReproModel`` serves the flat token-level continuous-batching
step (``flat_decode_step``).  Training, the dense and monolithic serving
steps and the other families arrive in later slices of the port.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeSpec
from repro_torch.core.hardware import HardwareSpec, query, require_device
from repro_torch.core.layout import LayoutPolicy
from repro_torch.core.linear import MatmulContext
from repro_torch.kernels.ragged_attn.ops import RaggedPlan
from repro_torch.models import transformer as tfm
from repro_torch.models.common import embed_apply

__all__ = ["ReproModel", "build_model"]


class ReproModel:
    """One model configuration on one device.  ``device`` defaults to
    ``cuda`` and raises without a card; ``device="cpu"`` runs the kernels'
    plain versions."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, shape: ShapeSpec,
                 hw: Optional[HardwareSpec] = None, device="cuda"):
        self.device = require_device(device)
        self.cfg = cfg
        self.run = run
        self.shape = shape
        self.ctx = MatmulContext(policy=LayoutPolicy(run.layout_policy),
                                 hw=hw or query(self.device),
                                 propagate=run.propagate)
        self.compute_dtype = getattr(torch, run.compute_dtype)

    def init(self, generator: torch.Generator) -> dict:
        """Random parameters with the JAX package's tree, shapes and
        scales, drawn from ``generator`` (a CPU generator: the same seed
        gives the same weights on every device), then moved to the device."""
        params = tfm.lm_init(generator, self.cfg, self.run)
        return tfm.tree_map(lambda t: t.to(self.device), params)

    def init_paged_cache(self, num_pages: int, page_tokens: int,
                         slots: int) -> dict:
        """The shared K/V page pools ``[G, P, T, Hkv, dh]`` (page 0 = trash).
        ``slots`` is accepted for parity with the JAX package, whose
        recurrent families keep per-slot state; attention needs none."""
        del slots
        return tfm.init_paged_caches(self.cfg, num_pages, page_tokens,
                                     self.compute_dtype, self.device)

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
        logits = tfm.lm_apply(params, x, self.ctx, self.cfg, self.run,
                              positions=q_pos[None, :], caches=caches,
                              paged=paged, logits_at=logits_idx[None, :])
        return logits, caches


def build_model(cfg: ModelConfig, run: RunConfig, shape: ShapeSpec,
                hw: Optional[HardwareSpec] = None, device="cuda") -> ReproModel:
    return ReproModel(cfg, run, shape, hw, device=device)
