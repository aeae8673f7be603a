"""RWKV-6 ("Finch") mixer: attention-free recurrence with data-dependent
decay, the JAX package's ``models/rwkv6.py``.

Time-mix: a per-head matrix state ``S`` [dh, dh] updated as
``S_t = diag(w_t) S_{t-1} + k_t v_t^T``, read as
``y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t``, with the per-channel decay
``w_t = exp(-exp(w0 + tanh(x_w @ w_a) @ w_b))``; token-shift mixing with
static per-channel lerp coefficients.  Channel-mix: ``relu(x_k W_k)^2``
through ``W_v``, gated by ``sigmoid(x_r W_r)``.

The linears go through :func:`~repro_torch.core.linear.linear_apply`
(mmt4d), the decay LoRA is a plain float32 product, as in the JAX package,
and the recurrence is the wkv6 kernel (:mod:`repro_torch.kernels.wkv6`),
one launch per layer and call, decode and prefill alike.  With a cache the
mixers read and write its ``tm_shift``, ``cm_shift`` and ``state`` in
place, so a CUDA graph over the step updates the engine's own tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.linear import MatmulContext, linear_apply, linear_init
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.models.common import Stream, maybe_unpack

__all__ = ["rwkv_tm_init", "rwkv_tm_apply", "rwkv_cm_init", "rwkv_cm_apply",
           "init_rwkv_cache"]

_DECAY_LORA = 64


def _heads(cfg: ModelConfig) -> tuple:
    dh = cfg.rwkv_head_dim
    return cfg.d_model // dh, dh


def rwkv_tm_init(generator: torch.Generator, cfg: ModelConfig,
                 dtype: torch.dtype) -> dict:
    """The JAX package's time-mix tree, shapes and scales: ``mu`` [5, d]
    (r, k, v, g, w), ``wr``/``wk``/``wv``/``wg``/``wo`` [d, d], ``w0`` [d],
    the decay LoRA ``w_a`` [d, 64] and ``w_b`` [64, d], the bonus ``u``
    [H, dh] and the group-norm gain ``ln_g`` [d], drawn from ``generator``
    on its device (the non-linear leaves in float32)."""
    d = cfg.d_model
    h, dh = _heads(cfg)
    dev, f32 = generator.device, torch.float32

    def lin(scale=None):
        return linear_init(generator, d, d, dtype=dtype, scale=scale)

    p = {"mu": torch.full((5, d), 0.5, dtype=f32, device=dev),
         "wr": lin(), "wk": lin(), "wv": lin(), "wg": lin(),
         "wo": lin(d ** -0.5 / max(1, cfg.n_layers) ** 0.5),
         "w0": torch.full((d,), -6.0, dtype=f32, device=dev)}
    for name, shape in (("w_a", (d, _DECAY_LORA)), ("w_b", (_DECAY_LORA, d))):
        p[name] = torch.randn(shape, generator=generator, device=dev) * 0.01
    p["u"] = torch.zeros((h, dh), dtype=f32, device=dev)
    p["ln_g"] = torch.ones((d,), dtype=f32, device=dev)
    return p


def rwkv_cm_init(generator: torch.Generator, cfg: ModelConfig,
                 dtype: torch.dtype) -> dict:
    """Channel-mix: ``mu`` [2, d] (r, k), ``wr`` [d, d], ``wk`` [d, d_ff],
    ``wv`` [d_ff, d]."""
    d, f = cfg.d_model, cfg.d_ff
    return {"mu": torch.full((2, d), 0.5, dtype=torch.float32,
                             device=generator.device),
            "wr": linear_init(generator, d, d, dtype=dtype),
            "wk": linear_init(generator, d, f, dtype=dtype),
            "wv": linear_init(generator, f, d, dtype=dtype,
                              scale=f ** -0.5 / max(1, cfg.n_layers) ** 0.5)}


def init_rwkv_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                    device) -> dict:
    """Zero per-row state: the two token shifts [batch, d] in ``dtype`` and
    the recurrence's ``state`` [batch, H, dh, dh] in float32."""
    d = cfg.d_model
    h, dh = _heads(cfg)
    return {"tm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
            "cm_shift": torch.zeros((batch, d), dtype=dtype, device=device),
            "state": torch.zeros((batch, h, dh, dh), dtype=torch.float32,
                                 device=device)}


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """x_{t-1} along the sequence; the first position takes ``prev`` (the
    cached last token), or zero without a cache."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    else:
        prev = prev[:, None].to(x.dtype)
    return torch.cat([prev, x[:, :-1]], dim=1)


def _decay(params: dict, xw: torch.Tensor) -> torch.Tensor:
    """The per-channel decay ``exp(-exp(w0 + tanh(xw @ w_a) @ w_b))`` in
    float32 (the LoRA a plain float32 product)."""
    lora = torch.tanh(xw.float() @ params["w_a"]) @ params["w_b"]
    return torch.exp(-torch.exp(params["w0"] + lora))


def _group_norm(y: torch.Tensor) -> torch.Tensor:
    """Per-head normalisation of y [..., dh] (no gain)."""
    mean = y.mean(-1, keepdim=True)
    var = ((y - mean) ** 2).mean(-1, keepdim=True)
    return (y - mean) * torch.rsqrt(var + 1e-5)


def rwkv_tm_apply(params: dict, x: Stream, ctx: MatmulContext,
                  cfg: ModelConfig, *, cache: Optional[dict] = None):
    """Time-mix over x [B, S, d] (a tensor or the packed stream).  Returns
    (out [B, S, d], cache): ``cache`` {"tm_shift", "state"} is read and
    updated in place (None in the train/prefill mode, whose state starts
    at zero)."""
    xu = maybe_unpack(x)
    b, s, d = xu.shape
    h, dh = _heads(cfg)
    xs = _token_shift(xu, None if cache is None else cache["tm_shift"])
    mu = params["mu"].to(xu.dtype)
    xr, xk, xv, xg, xw = (xu + mu[i] * (xs - xu) for i in range(5))

    r = linear_apply(params["wr"], xr, ctx).reshape(b, s, h, dh)
    k = linear_apply(params["wk"], xk, ctx).reshape(b, s, h, dh)
    v = linear_apply(params["wv"], xv, ctx).reshape(b, s, h, dh)
    g = F.silu(linear_apply(params["wg"], xg, ctx))

    w = _decay(params, xw).reshape(b, s, h, dh)

    if cache is None:
        s0 = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=xu.device)
        y, _ = wkv6(r.float(), k.float(), v.float(), w, params["u"], s0)
    else:
        y, _ = wkv6(r.float(), k.float(), v.float(), w, params["u"],
                    cache["state"], state_out=cache["state"])
        cache["tm_shift"].copy_(xu[:, -1])

    y = (_group_norm(y).reshape(b, s, d) * params["ln_g"]).to(xu.dtype) * g
    return linear_apply(params["wo"], y, ctx), cache


def rwkv_cm_apply(params: dict, x: Stream, ctx: MatmulContext,
                  cfg: ModelConfig, *, cache: Optional[dict] = None):
    """Channel-mix over x [B, S, d].  Returns (out [B, S, d], cache):
    ``cache`` {"cm_shift"} is read and updated in place."""
    xu = maybe_unpack(x)
    xs = _token_shift(xu, None if cache is None else cache["cm_shift"])
    mu = params["mu"].to(xu.dtype)
    xr = xu + mu[0] * (xs - xu)
    xk = xu + mu[1] * (xs - xu)
    k = linear_apply(params["wk"], xk, ctx, activation="relu")
    k = k * k
    out = torch.sigmoid(linear_apply(params["wr"], xr, ctx)) * \
        linear_apply(params["wv"], k, ctx)
    if cache is not None:
        cache["cm_shift"].copy_(xu[:, -1])
    return out, cache
