"""Wrapper of the mmt4d kernel (``csrc/mmt4d.cu``).

Replaces the Pallas ``mmt4d_kernel_call`` (src/repro/kernels/mmt4d/kernel.py:113).
A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the kernel or raises.  Operands are contiguous packed tiles of one dtype
(float32 or bfloat16); accumulation, bias and activation are float32, then
one cast.  At decode widths the kernel runs a handful of blocks on 132 SMs;
split-K and tensor cores are later work (see the source).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.mmt4d.ref import mmt4d_ref

__all__ = ["mmt4d", "ACTIVATION_CODES"]

# activation name -> the code csrc/mmt4d.cu switches on (same keys as ACTIVATIONS)
ACTIVATION_CODES = {None: 0, "gelu": 1, "silu": 2, "relu": 3, "tanh": 4}


def mmt4d(a_pack: torch.Tensor, b_pack: torch.Tensor,
          bias_pack: Optional[torch.Tensor] = None, *,
          activation: Optional[str] = None) -> torch.Tensor:
    """a_pack [M_o, K_o, m_r, k_r], b_pack [N_o, K_o, n_r, k_r], optional
    bias_pack [N_o, n_r] -> C_pack [M_o, N_o, m_r, n_r] in a_pack's dtype."""
    if activation not in ACTIVATION_CODES:
        raise ValueError(f"mmt4d: activation {activation!r} not in "
                         f"{list(ACTIVATION_CODES)}")
    if a_pack.ndim != 4 or b_pack.ndim != 4 \
            or a_pack.shape[1] != b_pack.shape[1] \
            or a_pack.shape[3] != b_pack.shape[3]:
        raise ValueError(f"mmt4d: shapes {tuple(a_pack.shape)} x "
                         f"{tuple(b_pack.shape)} do not contract")
    m_o, k_o, m_r, k_r = a_pack.shape
    n_o, _, n_r, _ = b_pack.shape
    if bias_pack is not None and tuple(bias_pack.shape) != (n_o, n_r):
        raise ValueError(f"mmt4d: bias {tuple(bias_pack.shape)} is not "
                         f"({n_o}, {n_r})")
    if a_pack.device.type == "cpu":
        return mmt4d_ref(a_pack, b_pack, bias_pack, activation=activation)
    extra = () if bias_pack is None else (bias_pack,)
    build.require_cuda("mmt4d", a_pack, b_pack, *extra)
    code = build.require_dtype("mmt4d", a_pack.dtype, a_pack, b_pack, *extra)
    build.require_contiguous("mmt4d", a_pack=a_pack, b_pack=b_pack,
                             **({"bias_pack": bias_pack} if extra else {}))
    out = torch.empty((m_o, n_o, m_r, n_r), dtype=a_pack.dtype,
                      device=a_pack.device)
    rc = build.load_library().repro_mmt4d(
        a_pack.data_ptr(), b_pack.data_ptr(),
        None if bias_pack is None else bias_pack.data_ptr(), out.data_ptr(),
        code, m_o, n_o, k_o, m_r, n_r, k_r, ACTIVATION_CODES[activation],
        build.stream_of(a_pack))
    build.check(rc, "mmt4d")
    mmt4d.launches += 1
    return out


mmt4d.launches = 0
