"""Wrappers of the selective_scan kernels: mamba's selective SSM
recurrence with its output contraction, skip and gate, from the state it
is given, which it overwrites in place with the final state
(``csrc/selective_scan.cu``), and its backward
(``csrc/selective_scan_bwd.cu``).

Replaces no Pallas kernel: the JAX package runs the recurrence as a
``lax.associative_scan`` (src/repro/models/mamba.py:79, ``_ssm_scan``)
over ``[B, S, di, N]`` float32 tensors, which the port would otherwise
build three of a layer and loop over in about two launches per token.
The kernels are the ops ``torch.ops.repro_torch.selective_scan`` and
``repro_torch.selective_scan_bwd`` (:mod:`repro_torch.kernels.library`;
the state and the checkpoints are declared written in place): a CPU
tensor takes the plain versions (``ref.py``), a CUDA tensor launches the
kernels or raises.  ``x``, ``z``, ``b`` and ``c`` may be
views with a unit channel stride (``z`` a slice of the in-projection's
output, ``b`` and ``c`` of the x-projection's), read in place; the state
width N is one of :data:`STATE_WIDTHS`.

Under autograd :func:`selective_scan` is a ``torch.autograd.Function``:
its forward runs from a copy of ``state`` (which it leaves unwritten)
and also writes the state at every chunk boundary; its backward is
:func:`selective_scan_bwd`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build, library
from repro_torch.kernels.selective_scan.ref import (scan_chunk,
                                                    selective_scan_bwd_ref,
                                                    selective_scan_ref)

__all__ = ["selective_scan", "selective_scan_bwd", "checkpoints",
           "STATE_WIDTHS"]

STATE_WIDTHS = (8, 16)   # one instance of the kernel each


def checkpoints(delta: torch.Tensor, dtype: torch.dtype, n: int) -> torch.Tensor:
    """An empty buffer for the state before each chunk of the forward's
    steps but the first (:func:`~repro_torch.kernels.selective_scan.ref.
    scan_chunk`): [B, ceil(S / L) - 1, di, N] in delta's dtype."""
    rows, s, di = delta.shape
    return delta.new_empty((rows, max(0, -(-s // scan_chunk(dtype, n)) - 1),
                            di, n))


def _check(name, delta, x, z, b, c, a_log, d_skip, state, *extra):
    build.require_cuda(name, delta, x, z, b, c, a_log, d_skip, state, *extra)
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
    return code


def _forward(delta, x, z, b, c, a_log, d_skip, state, ckpt):
    return _OP(delta, x, z, b, c, a_log, d_skip, state, ckpt)


def _scan_cpu(delta, x, z, b, c, a_log, d_skip, state, ckpt):
    return library.fresh(selective_scan_ref(delta, x, z, b, c, a_log, d_skip,
                                            state, ckpt=ckpt),
                         delta, x, z, b, c, a_log, d_skip, state)


def _scan_cuda(delta, x, z, b, c, a_log, d_skip, state, ckpt):
    name = "selective_scan"
    code = _check(name, delta, x, z, b, c, a_log, d_skip, state)
    rows, s, di = delta.shape
    n = a_log.shape[-1]
    if ckpt is not None and (ckpt.shape != checkpoints(delta, x.dtype, n).shape
                             or not ckpt.is_contiguous()
                             or ckpt.device != delta.device):
        raise ValueError(f"{name}: ckpt {tuple(ckpt.shape)}")
    y = torch.empty(delta.shape, dtype=x.dtype, device=x.device)
    rc = build.load_library().repro_selective_scan(
        delta.data_ptr(), x.data_ptr(), x.stride(0), x.stride(1),
        z.data_ptr(), z.stride(0), z.stride(1), b.data_ptr(), b.stride(0),
        b.stride(1), c.data_ptr(), c.stride(0), c.stride(1), a_log.data_ptr(),
        d_skip.data_ptr(), state.data_ptr(), y.data_ptr(),
        None if ckpt is None or ckpt.numel() == 0 else ckpt.data_ptr(),
        rows, s, di, n, code, build.stream_of(delta))
    build.check(rc, name)
    selective_scan.launches += 1
    return y


def _scan_fake(delta, x, z, b, c, a_log, d_skip, state, ckpt):
    return x.new_empty(delta.shape)


def selective_scan(delta: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                   b: torch.Tensor, c: torch.Tensor, a_log: torch.Tensor,
                   d_skip: torch.Tensor, state: torch.Tensor, *,
                   ckpt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """delta [B, S, di] float32; x, z [B, S, di] and b, c [B, S, N] in one
    dtype (float32 or bfloat16); a_log [di, N] and d_skip [di] float32;
    state [B, di, N] float32: h0 in, the final state out.  Returns y
    [B, S, di] in x's dtype.  ``ckpt`` (:func:`checkpoints`) also takes
    the state at every chunk boundary.  Under autograd (an operand that
    requires a gradient) the call is differentiable, takes no ``ckpt`` and
    only reads ``state``."""
    operands = (delta, x, z, b, c, a_log, d_skip, state)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        if ckpt is not None:
            raise ValueError("selective_scan: under autograd the checkpoints "
                             "are the call's own")
        return _ScanFn.apply(*operands)
    return _forward(*operands, ckpt)


selective_scan.launches = 0


class _ScanFn(torch.autograd.Function):
    """selective_scan with its gradient: the forward runs from a copy of
    h0 and saves its operands (x, z, b and c as the views they are) and
    the checkpoints; the backward is one :func:`selective_scan_bwd`."""

    @staticmethod
    def forward(ctx, delta, x, z, b, c, a_log, d_skip, h0):
        ckpt = checkpoints(delta, x.dtype, a_log.shape[-1])
        y = _forward(delta, x, z, b, c, a_log, d_skip, h0.clone(), ckpt)
        ctx.save_for_backward(delta, x, z, b, c, a_log, d_skip, h0, ckpt)
        return y

    @staticmethod
    def backward(ctx, dout):
        # saved_tensors read once: under a checkpoint (remat) each read
        # unpacks the saved tensors again, which the checkpoint refuses
        saved = ctx.saved_tensors
        return selective_scan_bwd(*saved[:8], dout.contiguous(), saved[8])


def selective_scan_bwd(delta: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor, a_log: torch.Tensor,
                       d_skip: torch.Tensor, h0: torch.Tensor,
                       dout: torch.Tensor, ckpt: torch.Tensor):
    """(ddelta, dx, dz, db, dc, da_log, dd_skip, dh0): the gradients of
    :func:`selective_scan` at its operands (h0 the state it started from)
    from dout [B, S, di] (contiguous, x's dtype), with ``ckpt`` as the
    forward wrote it.  dx, dz, db and dc come in x's dtype, the rest in
    float32.  A CPU tensor takes :func:`~repro_torch.kernels.
    selective_scan.ref.selective_scan_bwd_ref`; a CUDA tensor launches
    the backward kernel (and the sums of its per-cluster and per-row
    partials, in order) or raises."""
    return _BWD(delta, x, z, b, c, a_log, d_skip, h0, dout, ckpt)


def _bwd_cpu(delta, x, z, b, c, a_log, d_skip, h0, dout, ckpt):
    return library.fresh(selective_scan_bwd_ref(delta, x, z, b, c, a_log,
                                                d_skip, h0, dout, ckpt),
                         delta, x, z, b, c, a_log, d_skip, h0, dout, ckpt)


def _bwd_cuda(delta, x, z, b, c, a_log, d_skip, h0, dout, ckpt):
    name = "selective_scan_bwd"
    code = _check(name, delta, x, z, b, c, a_log, d_skip, h0, dout, ckpt)
    rows, s, di = delta.shape
    n = a_log.shape[-1]
    if (dout.shape != delta.shape or dout.dtype != x.dtype
            or not dout.is_contiguous() or not ckpt.is_contiguous()
            or ckpt.shape != checkpoints(delta, x.dtype, n).shape):
        raise ValueError(f"{name}: dout {tuple(dout.shape)} {dout.dtype}, ckpt "
                         f"{tuple(ckpt.shape)}")
    # the kernel's clusters: 4 blocks of 128 // (n // 4) channels each
    clusters = -(-di // (4 * (128 // (n // 4))))
    ddelta = torch.empty_like(delta)
    dx, dz = (torch.empty(delta.shape, dtype=x.dtype, device=x.device)
              for _ in range(2))
    db, dc = (torch.empty((rows, s, n), dtype=x.dtype, device=x.device)
              for _ in range(2))
    da_log, dd = torch.empty_like(a_log), torch.empty_like(d_skip)
    dh0 = torch.empty_like(h0)
    f32 = dict(dtype=torch.float32, device=delta.device)
    part_b, part_c = (torch.empty((rows, clusters, s, n), **f32) for _ in range(2))
    part_a, part_d = torch.empty((rows, di, n), **f32), torch.empty((rows, di), **f32)
    rc = build.load_library().repro_selective_scan_bwd(
        delta.data_ptr(), x.data_ptr(), x.stride(0), x.stride(1),
        z.data_ptr(), z.stride(0), z.stride(1), b.data_ptr(), b.stride(0),
        b.stride(1), c.data_ptr(), c.stride(0), c.stride(1), a_log.data_ptr(),
        d_skip.data_ptr(), h0.data_ptr(), dout.data_ptr(),
        None if ckpt.numel() == 0 else ckpt.data_ptr(), ddelta.data_ptr(),
        dx.data_ptr(), dz.data_ptr(), db.data_ptr(), dc.data_ptr(),
        da_log.data_ptr(), dd.data_ptr(), dh0.data_ptr(), part_b.data_ptr(),
        part_c.data_ptr(), part_a.data_ptr(), part_d.data_ptr(), rows, s, di,
        n, code, build.stream_of(delta))
    build.check(rc, name)
    selective_scan_bwd.launches += 1
    return ddelta, dx, dz, db, dc, da_log, dd, dh0


def _bwd_fake(delta, x, z, b, c, a_log, d_skip, h0, dout, ckpt):
    rows, s, _ = delta.shape
    n = a_log.shape[-1]
    like = lambda t: torch.empty_like(t, memory_format=torch.contiguous_format)
    return (like(delta), x.new_empty(delta.shape), x.new_empty(delta.shape),
            x.new_empty((rows, s, n)), x.new_empty((rows, s, n)), like(a_log),
            like(d_skip), like(h0))


selective_scan_bwd.launches = 0


library.register("selective_scan", cpu=_scan_cpu, cuda=_scan_cuda,
                 fake=_scan_fake)
library.register("selective_scan_bwd", cpu=_bwd_cpu, cuda=_bwd_cuda,
                 fake=_bwd_fake)
_OP = library.op("selective_scan")
_BWD = library.op("selective_scan_bwd")
