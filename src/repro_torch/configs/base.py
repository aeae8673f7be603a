"""Configuration system: model configs, shape specs, run configs.

A copy of the JAX package's ``configs/base.py`` (the port imports nothing
of that package).  Every architecture is a :class:`ModelConfig`; every
input shape a :class:`ShapeSpec`; ``RunConfig`` carries the execution
knobs (layout policy, dtypes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeSpec", "RunConfig", "SHAPES", "reduced_config"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0               # 0 -> d_model // n_heads

    # attention details
    rope: str = "neox"            # neox | partial2d | none
    rope_theta: float = 1e4
    rope_pct: float = 1.0         # fraction of head dim rotated
    qk_norm: bool = False
    attn_bias: bool = False
    norm: str = "rmsnorm"         # rmsnorm | layernorm | layernorm_np
    act: str = "silu"
    glu: bool = True              # gated (SwiGLU-style) MLP
    tie_embeddings: bool = False

    # MoE
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1
    dense_residual: bool = False
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3

    # per-layer mixer pattern, cycled over layers ("attn" | "mamba" | "rwkv")
    block_pattern: Tuple[str, ...] = ("attn",)

    # mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2

    # rwkv6
    rwkv_head_dim: int = 64

    # enc-dec: decoder layers = n_layers, encoder layers below
    encoder_layers: int = 0

    # modality frontend stub
    frontend: str = "none"        # none | audio | vision
    vision_tokens: int = 256
    audio_downsample: int = 4

    attention: str = "full"

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(1, self.n_heads))

    @property
    def layer_types(self) -> Tuple[str, ...]:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def is_subquadratic(self) -> bool:
        return any(t != "attn" for t in self.layer_types)

    def moe_on_layer(self, i: int) -> bool:
        return self.moe and ((i + 1) % self.moe_every == 0)

    def param_counts(self) -> dict:
        """Total and active parameter counts (for MODEL_FLOPS = 6*N*D)."""
        d, dh = self.d_model, self.d_head
        hq, hkv = self.n_heads, self.n_kv_heads
        counts = {"embed": self.vocab * d,
                  "lm_head": 0 if self.tie_embeddings else self.vocab * d}
        attn = d * hq * dh + 2 * d * hkv * dh + hq * dh * d
        dense_ffn = (3 if self.glu else 2) * d * self.d_ff
        expert_ffn = (3 if self.glu else 2) * d * self.d_ff_expert
        mamba_inner = self.mamba_expand * d
        mamba = (d * 2 * mamba_inner + mamba_inner * self.mamba_d_conv
                 + mamba_inner * (2 * self.mamba_d_state + -(-d // 16))
                 + (-(-d // 16)) * mamba_inner + mamba_inner * d)
        rwkv = 4 * d * d + d * d + 2 * d * d

        total = counts["embed"] + counts["lm_head"]
        active = total
        for i, t in enumerate(self.layer_types):
            mixer = {"attn": attn, "mamba": mamba, "rwkv": rwkv}[t]
            total += mixer
            active += mixer
            if self.moe_on_layer(i):
                total += self.n_experts * expert_ffn + d * self.n_experts
                active += self.top_k * expert_ffn
                if self.dense_residual:
                    total += dense_ffn
                    active += dense_ffn
            else:
                total += dense_ffn
                active += dense_ffn
        if self.encoder_layers:
            enc = self.encoder_layers * (attn + dense_ffn)
            dec_cross = self.n_layers * attn
            total += enc + dec_cross
            active += enc + dec_cross
        return {"total": total, "active": active}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution knobs."""

    layout_policy: str = "scalable"     # scalable | fixed | unpacked
    propagate: bool = True              # packed-layout propagation across ops
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    microbatch: int = 0
    remat: bool = True
    fsdp: bool = True
    seq_shard_kv: bool = True
    moe_local_dispatch: bool = False
    lr: float = 3e-4
    warmup_steps: int = 100
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    adam_8bit: bool = False
    grad_compression: bool = False
    z_loss: float = 1e-4


def reduced_config(cfg: ModelConfig, *, layers: Optional[int] = None) -> ModelConfig:
    """A small same-family config for CPU smoke tests: keeps the
    architectural features (GQA ratio, pattern, tied embeddings) while
    shrinking every dimension."""
    pat = cfg.block_pattern
    n_layers = layers if layers is not None else max(2, min(len(pat), 8))
    hq = max(2, min(4, cfg.n_heads))
    ratio = max(1, cfg.n_heads // max(1, cfg.n_kv_heads))
    hkv = max(1, hq // min(ratio, hq))
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=hq,
        n_kv_heads=hkv,
        d_head=16,
        d_ff=128,
        d_ff_expert=96 if cfg.moe else 0,
        n_experts=min(4, cfg.n_experts) if cfg.moe else 0,
        top_k=min(2, cfg.top_k) if cfg.moe else 0,
        vocab=512,
        encoder_layers=2 if cfg.encoder_layers else 0,
        mamba_d_state=8,
        rwkv_head_dim=16,
        vision_tokens=8,
    )
