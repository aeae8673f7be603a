"""Scalable packed layouts in PyTorch: the hardware query, tile functions,
pack/unpack, mmt4d, packed-domain ops and the model-facing linear layer.

Public surface (the JAX package's ``repro.core``, name for name):
  - hardware.HardwareSpec / query        — runtime hardware descriptor (VL analogue)
  - layout.make_layout / LayoutPolicy    — VL-parametric tile functions
  - packing.pack_lhs/pack_rhs/unpack_out — explicit layout transformation
  - mmt4d.mmt4d / packed_matmul          — compute on packed operands
  - propagation.PackedArray              — packed-domain pointwise/norm ops
  - linear.linear_apply / MatmulContext  — the model-facing matmul entry point
"""

from repro_torch.core.hardware import HardwareSpec, presets, query
from repro_torch.core.layout import (LayoutPolicy, PackedLayout, make_layout,
                                     MICROKERNELS)
from repro_torch.core.mmt4d import Epilogue, mmt4d, packed_matmul, matmul
from repro_torch.core.propagation import PackedArray, pack_activation
from repro_torch.core.linear import (MatmulContext, linear_init, linear_apply,
                                     batched_linear_apply, prepack_params)
from repro_torch.core import packing

__all__ = [
    "HardwareSpec", "presets", "query",
    "LayoutPolicy", "PackedLayout", "make_layout", "MICROKERNELS",
    "Epilogue", "mmt4d", "packed_matmul", "matmul",
    "PackedArray", "pack_activation",
    "MatmulContext", "linear_init", "linear_apply", "batched_linear_apply",
    "prepack_params", "packing",
]
