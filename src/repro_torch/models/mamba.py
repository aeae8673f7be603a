"""Mamba (selective SSM) mixer, jamba's recurrent block: the JAX package's
``models/mamba.py``.

The in, x and out projections go through
:func:`~repro_torch.core.linear.linear_apply` (mmt4d); ``dt_proj`` stays a
plain float32 product, as in the JAX package
(:func:`~repro_torch.core.linear.prepack_params` leaves it unpacked).  The
depthwise causal convolution is plain PyTorch, as the JAX package leaves
it to XLA outside Pallas: the sum of its ``d_conv`` shifted products.
The selective scan, its output contraction, skip and gate are one call
of :func:`~repro_torch.kernels.selective_scan.ops.selective_scan`: the
``selective_scan`` kernel on the card, with no ``[B, S, di, N]`` tensor;
on the CPU its plain version, sequential over the sequence where the JAX
package runs ``lax.associative_scan`` (the same recurrence; float32 sums
in another order).

Modes: train/prefill from zero state (no cache; a zero state owned by the
call), and with a cache {"conv" [B, d_conv - 1, di], "ssm" [B, di, N]}:
one update at s = 1, or a prefill from the cached state (its ``h0``
injected into the first step).  The cache is read and updated in place.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.linear import MatmulContext, linear_apply, linear_init
from repro_torch.kernels.selective_scan.ops import selective_scan
from repro_torch.kernels.selective_scan.ref import _ssm_scan  # noqa: F401
from repro_torch.models.common import Stream, maybe_unpack

__all__ = ["mamba_init", "mamba_apply", "init_mamba_cache"]


def _dims(cfg: ModelConfig) -> tuple:
    d = cfg.d_model
    di = cfg.mamba_expand * d
    return d, di, -(-d // 16), cfg.mamba_d_state


def mamba_init(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype) -> dict:
    """The JAX package's tree, shapes and scales: ``in_proj`` [d, 2 di],
    ``conv_w`` [d_conv, 1, di], ``conv_b``, ``x_proj`` [di, dt_rank + 2N],
    ``dt_proj`` {"w" [dt_rank, di], "b" (the inverse softplus of a
    log-uniform step in [1e-3, 0.1], float32)}, ``a_log`` [di, N],
    ``d_skip`` and ``out_proj`` [di, d], drawn from ``generator`` on its
    device."""
    d, di, dt_rank, n = _dims(cfg)
    dev, f32 = generator.device, torch.float32
    in_proj = linear_init(generator, d, 2 * di, dtype=dtype)
    conv_w = (torch.randn((cfg.mamba_d_conv, 1, di), generator=generator,
                          device=dev) * cfg.mamba_d_conv ** -0.5).to(dtype)
    x_proj = linear_init(generator, di, dt_rank + 2 * n, dtype=dtype)
    dt_w = (torch.randn((dt_rank, di), generator=generator, device=dev)
            * dt_rank ** -0.5).to(dtype)
    lo, hi = math.log(1e-3), math.log(0.1)
    dt = torch.exp(torch.rand((di,), generator=generator, device=dev)
                   * (hi - lo) + lo)
    dt_bias = dt + torch.log(-torch.expm1(-dt))          # inverse softplus
    a = torch.arange(1, n + 1, dtype=f32, device=dev)
    return {"in_proj": in_proj, "conv_w": conv_w,
            "conv_b": torch.zeros((di,), dtype=dtype, device=dev),
            "x_proj": x_proj, "dt_proj": {"w": dt_w, "b": dt_bias},
            "a_log": torch.log(a).expand(di, n).contiguous(),
            "d_skip": torch.ones((di,), dtype=f32, device=dev),
            "out_proj": linear_init(generator, di, d, dtype=dtype,
                                    scale=di ** -0.5 / max(1, cfg.n_layers) ** 0.5)}


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device) -> dict:
    """Zero per-row state: the convolution's last ``d_conv - 1`` inputs in
    ``dtype`` and the SSM state in float32."""
    _, di, _, n = _dims(cfg)
    return {"conv": torch.zeros((batch, cfg.mamba_d_conv - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, di, n), dtype=torch.float32,
                               device=device)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prepend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d: x [B, S, di], w [W, 1, di]; the ``W - 1``
    positions before the first are ``prepend`` (the cached inputs) or
    zero.  ``out[t] = sum_j x_in[t + j] * w[j]``, the JAX package's
    ``conv_general_dilated`` (a correlation) in ``x``'s dtype."""
    width, s = w.shape[0], x.shape[1]
    if prepend is None:
        x_in = F.pad(x, (0, 0, width - 1, 0))
    else:
        x_in = torch.cat([prepend.to(x.dtype), x], dim=1)
    w = w[:, 0].to(x.dtype)
    out = x_in[:, :s] * w[0]
    for j in range(1, width):
        out = out + x_in[:, j:j + s] * w[j]
    return out + b.to(x.dtype)


def _delta(params: dict, dt: torch.Tensor) -> torch.Tensor:
    """The step size ``softplus(dt @ dt_proj.w + dt_proj.b)``, a plain
    float32 product."""
    return F.softplus(dt.float() @ params["w"].float() + params["b"])


def mamba_apply(params: dict, x: Stream, ctx: MatmulContext, cfg: ModelConfig,
                *, cache: Optional[dict] = None):
    """x: the stream [B, S, d].  Returns (out [B, S, d], cache), the cache
    updated in place (None in the train/prefill mode)."""
    d, di, dt_rank, n = _dims(cfg)
    xz = maybe_unpack(linear_apply(params["in_proj"], x, ctx))
    x_in, z = xz[..., :di], xz[..., di:]

    if cache is None:
        x_c = _causal_conv(x_in, params["conv_w"], params["conv_b"])
    else:
        x_c = _causal_conv(x_in, params["conv_w"], params["conv_b"],
                           prepend=cache["conv"])
        window = torch.cat([cache["conv"].to(x_in.dtype), x_in], dim=1)
        cache["conv"].copy_(window[:, -(cfg.mamba_d_conv - 1):])
    x_c = F.silu(x_c)

    proj = linear_apply(params["x_proj"], x_c, ctx)
    dt, b_ssm, c_ssm = proj.split([dt_rank, n, n], dim=-1)
    delta = _delta(params["dt_proj"], dt)                        # [B,S,di]
    if cache is None:
        state = torch.zeros((x_c.shape[0], di, n), dtype=torch.float32,
                            device=x_c.device)
    else:
        state = cache["ssm"]
    y = selective_scan(delta, x_c, z, b_ssm, c_ssm, params["a_log"],
                       params["d_skip"], state)
    return linear_apply(params["out_proj"], y, ctx), cache
