"""Wrapper of the selective_scan kernel (``csrc/selective_scan.cu``):
mamba's selective SSM recurrence with its output contraction, skip and
gate, from the state it is given, which it overwrites in place with the
final state.

Replaces no Pallas kernel: the JAX package runs the recurrence as a
``lax.associative_scan`` (src/repro/models/mamba.py:79, ``_ssm_scan``)
over ``[B, S, di, N]`` float32 tensors, which the port would otherwise
build three of a layer and loop over in about two launches per token.
A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches the kernel or raises.  ``x``, ``z``, ``b`` and ``c`` may be
views with a unit channel stride (``z`` a slice of the in-projection's
output, ``b`` and ``c`` of the x-projection's), read in place; the state
width N is one of :data:`STATE_WIDTHS`.

The kernel has no backward yet (ROADMAP B8): a CUDA call that autograd
would have to differentiate raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.selective_scan.ref import selective_scan_ref

__all__ = ["selective_scan", "STATE_WIDTHS"]

STATE_WIDTHS = (8, 16)   # one instance of the kernel each


def selective_scan(delta: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, a_log: torch.Tensor,
                   d_skip: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """delta [B, S, di] float32; x, z [B, S, di] and b, c [B, S, N] in one
    dtype (float32 or bfloat16); a_log [di, N] and d_skip [di] float32;
    state [B, di, N] float32: h0 in, the final state out.  Returns y
    [B, S, di] in x's dtype."""
    if delta.device.type == "cpu":
        return selective_scan_ref(delta, x, z, b, c, a_log, d_skip, state)
    name = "selective_scan"
    build.require_cuda(name, delta, x, z, b, c, a_log, d_skip, state)
    code = build.require_dtype(name, x.dtype, x, z, b, c)
    if any(t.dtype != torch.float32 for t in (delta, a_log, d_skip, state)):
        raise TypeError(f"{name}: delta, a_log, d_skip and state must be "
                        f"float32, not {[t.dtype for t in (delta, a_log, d_skip, state)]}")
    build.require_contiguous(name, delta=delta, a_log=a_log, d_skip=d_skip,
                             state=state)
    rows, s, di = delta.shape
    n = a_log.shape[-1]
    if (x.shape != delta.shape or z.shape != delta.shape
            or b.shape != (rows, s, n) or c.shape != (rows, s, n)
            or a_log.shape != (di, n) or d_skip.shape != (di,)
            or state.shape != (rows, di, n)):
        raise ValueError(f"{name}: shapes delta {tuple(delta.shape)}, x "
                         f"{tuple(x.shape)}, z {tuple(z.shape)}, b "
                         f"{tuple(b.shape)}, c {tuple(c.shape)}, a_log "
                         f"{tuple(a_log.shape)}, d_skip {tuple(d_skip.shape)}, "
                         f"state {tuple(state.shape)}")
    if n not in STATE_WIDTHS:
        raise ValueError(f"{name}: state width N = {n}; the kernel takes "
                         f"{STATE_WIDTHS}")
    if any(t.stride(-1) != 1 for t in (x, z, b, c)):
        raise ValueError(f"{name}: x, z, b and c need a unit last stride, not "
                         f"{[t.stride(-1) for t in (x, z, b, c)]}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (delta, x, z, b, c, a_log, d_skip, state)):
        raise NotImplementedError(f"{name} has no backward kernel yet (ROADMAP "
                                  f"B8): the mamba hybrids do not train on the card")
    y = torch.empty(delta.shape, dtype=x.dtype, device=x.device)
    rc = build.load_library().repro_selective_scan(
        delta.data_ptr(), x.data_ptr(), x.stride(0), x.stride(1),
        z.data_ptr(), z.stride(0), z.stride(1), b.data_ptr(), b.stride(0),
        b.stride(1), c.data_ptr(), c.stride(0), c.stride(1), a_log.data_ptr(),
        d_skip.data_ptr(), state.data_ptr(), y.data_ptr(), rows, s, di, n, code,
        build.stream_of(delta))
    build.check(rc, name)
    selective_scan.launches += 1
    return y


selective_scan.launches = 0
