"""Hardware descriptors — the runtime vector-length query of the paper.

Layouts are functions of a :class:`HardwareSpec`, never baked-in numbers.
:func:`query` is the one place the port asks what it runs on:

- a CPU device gets ``tpu_v5e``, mirrored from the JAX package, so the CPU
  parity runs share the reference's tile geometry (page size, chunk and
  flat ladders);
- a CUDA device gets an ``h100`` descriptor read from
  ``torch.cuda.get_device_properties`` (name, SM count, memory), with the
  published peak rates looked up by device name, because the SXM, PCIe and
  NVL parts differ.

The ``h100`` descriptor keeps ``lanes=128``, ``sublanes=8`` and
``mxu_k=128``: the scalable tiles are then f32 (8, 128, 128) and bf16
(16, 128, 128), ``n_r == k_r`` holds (chain compatibility), pages stay 16
tokens and the flat ladders match the reference.  Retuning the tiles to the
warpgroup MMA shape (m_r = 64) changes the page size and the ladders, so it
waits for the PR that redesigns the kernels for Hopper.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["HardwareSpec", "presets", "query", "dtype_bits", "sublane_packing",
           "require_device"]


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

    def peak_flops(self, dtype: torch.dtype) -> float:
        return self.flops_f32 if dtype_bits(dtype) >= 32 else self.flops_bf16


presets: dict[str, HardwareSpec] = {"tpu_v5e": HardwareSpec(name="tpu_v5e")}

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


def query(device="cpu") -> HardwareSpec:
    """The hardware descriptor of ``device`` (``svcntw()`` analogue)."""
    device = require_device(device)
    if device.type == "cuda":
        return _gpu_spec(device)
    return presets["tpu_v5e"]
