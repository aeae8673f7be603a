"""Three-term roofline of a dry-run cell, the JAX package's
``roofline/analysis.py``:

    compute    = FLOPs / peak FLOP/s                (per device)
    memory     = HBM bytes / HBM bandwidth          (per device)
    collective = collective bytes / link bandwidth  (per device)

The JAX package reads the per-device FLOPs, bytes and collective bytes
from the compiled SPMD program's HLO.  The port has no compiler to ask:
:mod:`repro_torch.launch.dryrun` counts them in closed form from the
cell's shapes and the sharding rules' placements, and hands them to
:func:`roofline_terms`.  The rates come from a
:class:`~repro_torch.core.hardware.HardwareSpec` (on the card, the
``h100`` descriptor's published peaks), so every term is a prediction.

Also reports MODEL_FLOPS = 6·N·D (train; 2·N·D otherwise) with N the
active parameter count, and the usefulness ratio MODEL_FLOPS / (FLOPs ·
devices), which exposes padding and recomputation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.core.hardware import HardwareSpec

__all__ = ["model_flops", "roofline_terms", "RooflineReport"]


def model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    n_active = cfg.param_counts()["active"]
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    # decode: one new token per sequence
    return 2.0 * n_active * shape.global_batch


@dataclasses.dataclass
class RooflineReport:
    """The JAX package's record, field for field.  The ``hlo_`` names are
    kept for the reader who compares the two; in the port they hold the
    dry-run's analytic counts per device, not an HLO's.  ``op_counts``
    counts the collectives a step issues by kind; ``memory_per_device``
    holds the bytes each device holds (arguments, outputs, the step's
    reckoned transients)."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops_per_chip: float
    hlo_bytes_per_chip: float
    collective_bytes_per_chip: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    collective_detail: dict
    op_counts: dict
    memory_per_device: Optional[dict]
    step_time_bound_s: float = 0.0
    roofline_fraction: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def roofline_terms(*, arch: str, shape_spec: ShapeSpec, mesh_name: str,
                   chips: int, cfg: ModelConfig, hw: HardwareSpec,
                   flops: float, hbm_bytes: float, collective: dict,
                   op_counts: dict, compute_dtype: str = "bfloat16",
                   memory_stats: Optional[dict] = None) -> RooflineReport:
    """The report of one cell from the port's per-device counts: ``flops``,
    ``hbm_bytes`` and ``collective`` ({kind: bytes}, summed into the
    collective term)."""
    peak = hw.flops_bf16 if "16" in compute_dtype else hw.flops_f32
    cbytes = float(sum(collective.values()))
    terms = {"compute": flops / peak, "memory": hbm_bytes / hw.hbm_bw,
             "collective": cbytes / hw.ici_bw}
    bottleneck = max(terms, key=terms.get)
    mf = model_flops(cfg, shape_spec)
    # the step's lower bound if the dominant term hid the others; the
    # roofline fraction is the ideal model-compute time over it
    bound = max(terms.values())
    ideal = mf / (chips * peak)
    return RooflineReport(
        arch=arch, shape=shape_spec.name, mesh=mesh_name, chips=chips,
        hlo_flops_per_chip=float(flops), hlo_bytes_per_chip=float(hbm_bytes),
        collective_bytes_per_chip=cbytes,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"], bottleneck=bottleneck,
        model_flops=mf, useful_ratio=mf / max(1.0, flops * chips),
        collective_detail={"bytes": {**collective, "total": cbytes}},
        op_counts=op_counts, memory_per_device=memory_stats,
        step_time_bound_s=bound,
        roofline_fraction=(ideal / bound if bound > 0 else 0.0))
