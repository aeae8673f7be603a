"""Hardware descriptors — the runtime vector-length query of the paper.

Layouts are functions of a :class:`HardwareSpec`, never baked-in numbers.
:func:`query` is the one place the port asks what it runs on.  It resolves
an explicit ``name``, then ``$REPRO_HW``, then the device's own descriptor:

- a CPU device gets ``tpu_v5e``, and by name any of :data:`presets`, the
  JAX package's five descriptors mirrored field for field (``tpu_vl256``
  and ``tpu_vl512`` are ``tpu_v5e.scaled(2)`` and ``scaled(4)``), so the
  CPU parity runs share the reference's tile geometry (page size, chunk
  and flat ladders) at every vector length;
- a CUDA device gets an ``h100`` descriptor read from
  ``torch.cuda.get_device_properties`` (name, SM count, memory), with the
  published peak rates looked up by device name, because the SXM, PCIe and
  NVL parts differ; by name ``h100_vl256`` and ``h100_vl512``, its
  ``scaled(2)`` and ``scaled(4)``.  A scaled descriptor widens the tiles
  only: the card does not get wider vectors, and the scaled peak rates
  are not the card's.

The ``h100`` descriptor keeps ``lanes=128``, ``sublanes=8`` and
``mxu_k=128``: the scalable tiles are then f32 (8, 128, 128) and bf16
(16, 128, 128), ``n_r == k_r`` holds (chain compatibility), pages stay 16
tokens and the flat ladders match the reference.  Retuning the tiles to the
warpgroup MMA shape (m_r = 64) would change the page size and the ladders,
so the descriptor does not do it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

__all__ = ["HardwareSpec", "presets", "query", "dtype_bits",
           "sublane_packing", "require_device"]


def dtype_bits(dtype: torch.dtype) -> int:
    """Bit width of an element of ``dtype``."""
    return dtype.itemsize * 8


def sublane_packing(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` per 32-bit word: f32 tiles are (8, 128), bf16
    (16, 128), 8-bit (32, 128)."""
    return max(1, 32 // dtype_bits(dtype))


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Implementation-defined hardware parameters (the ``VL`` of the paper).

    ``lanes``/``sublanes``/``mxu_k`` set the packed tile sizes; the rest
    prices work: ``hbm_bw`` bytes/s, ``flops_*`` peak FLOP/s, ``hbm_bytes``
    device memory.  ``vmem_bytes`` is the fast on-chip memory a kernel
    block can use (TPU VMEM; on a GPU the shared memory per block).
    ``sm_count`` and ``device_name`` are set for a CUDA device only.
    """

    name: str
    lanes: int = 128
    sublanes: int = 8
    mxu_k: int = 128
    vmem_bytes: int = 16 * 2**20
    hbm_bw: float = 819e9
    flops_bf16: float = 197e12
    flops_f32: float = 98.5e12
    ici_bw: float = 50e9
    hbm_bytes: int = 16 * 2**30
    sm_count: int = 0
    device_name: str = ""

    def vl(self, dtype: torch.dtype = torch.float32) -> int:
        """Vector length in elements (the minor dim), ``svcntw()``'s
        analogue: the lane count, whatever the dtype (a narrower dtype
        packs more rows instead, :func:`sublane_packing`)."""
        del dtype
        return self.lanes

    def native_tile(self, dtype: torch.dtype) -> tuple[int, int]:
        """The native (second-minor, minor) memory tile of ``dtype``."""
        return (self.sublanes * sublane_packing(dtype), self.lanes)

    def peak_flops(self, dtype: torch.dtype) -> float:
        return self.flops_f32 if dtype_bits(dtype) >= 32 else self.flops_bf16

    def scaled(self, factor: int) -> "HardwareSpec":
        """A hypothetical implementation with ``factor``× wider vectors:
        lanes, ``mxu_k`` and both peak FLOP rates scale, the memory system
        does not (the paper's SVE-128/256/512 study)."""
        return dataclasses.replace(
            self,
            name=f"{self.name}_vl{self.lanes * factor}",
            lanes=self.lanes * factor,
            mxu_k=self.mxu_k * factor,
            flops_bf16=self.flops_bf16 * factor,
            flops_f32=self.flops_f32 * factor,
        )


_TPU_V5E = HardwareSpec(name="tpu_v5e")

# the JAX package's descriptors, field for field; on the CPU they set the
# tiles (their rates price nothing the port measures)
presets: dict[str, HardwareSpec] = {
    "tpu_v5e": _TPU_V5E,
    "tpu_v4": HardwareSpec(name="tpu_v4", vmem_bytes=32 * 2**20,
                           hbm_bw=1228e9, flops_bf16=275e12,
                           flops_f32=137.5e12, hbm_bytes=32 * 2**30),
    "tpu_vl128": _TPU_V5E,
    "tpu_vl256": _TPU_V5E.scaled(2),
    "tpu_vl512": _TPU_V5E.scaled(4),
}

# the card's own descriptor and its scaled forms, by name
_GPU_NAMES = {"h100": 1, "h100_vl256": 2, "h100_vl512": 4}

# Published dense peaks (NVIDIA data sheets): (HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores), matched by substring of
# torch.cuda.get_device_name in this order.
_GPU_PEAKS = (
    ("H100 PCIe", (2.0e12, 756e12, 51e12)),
    ("H100 NVL", (3.9e12, 835e12, 60e12)),
    ("H100", (3.35e12, 989e12, 67e12)),
    ("H200", (4.8e12, 989e12, 67e12)),
)

_SMEM_PER_BLOCK = 232448      # 227 KB opt-in dynamic shared memory on Hopper


def _gpu_spec(device: torch.device) -> HardwareSpec:
    props = torch.cuda.get_device_properties(device)
    for key, (bw, bf16, f32) in _GPU_PEAKS:
        if key in props.name:
            break
    else:
        raise KeyError(f"no peak-rate entry for {props.name!r}; have "
                       f"{[k for k, _ in _GPU_PEAKS]}")
    return HardwareSpec(name="h100", vmem_bytes=_SMEM_PER_BLOCK, hbm_bw=bw,
                        flops_bf16=bf16, flops_f32=f32, ici_bw=450e9,
                        hbm_bytes=props.total_memory,
                        sm_count=props.multi_processor_count,
                        device_name=props.name)


def require_device(device) -> torch.device:
    """The device an entry point runs on.  ``cuda`` (the default of every
    entry point) raises when no card is visible: the port never falls back
    to the CPU unless the caller asks for it with ``device="cpu"``."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run the plain "
                           "PyTorch versions on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def query(device="cuda", name: Optional[str] = None) -> HardwareSpec:
    """The hardware descriptor of ``device`` (``svcntw()`` analogue):
    ``name``, else ``$REPRO_HW``, else the device's own.  A ``tpu_*``
    name on a CUDA device and an ``h100*`` name on the CPU raise: the one
    prices the card with a TPU's peaks, the other has no card to read."""
    device = require_device(device)
    name = (name or os.environ.get("REPRO_HW")
            or ("h100" if device.type == "cuda" else "tpu_v5e"))
    if name in _GPU_NAMES:
        if device.type != "cuda":
            raise ValueError(f"hardware {name!r} describes the card; "
                             f"device={device} has none (the CPU takes "
                             f"the tpu_* presets: {sorted(presets)})")
        factor = _GPU_NAMES[name]
        spec = _gpu_spec(device)
        return spec if factor == 1 else spec.scaled(factor)
    if name in presets:
        if device.type == "cuda":
            raise ValueError(f"hardware {name!r} is a TPU's descriptor; on "
                             f"the card use one of {sorted(_GPU_NAMES)}")
        return presets[name]
    raise KeyError(f"unknown hardware {name!r}; have {sorted(presets)} on "
                   f"the CPU and {sorted(_GPU_NAMES)} on the card")
