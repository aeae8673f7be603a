"""Jamba-v0.1 52B [arXiv:2403.19887]: attn:mamba 1:7 interleave, MoE 16e
top-2 on every 2nd layer (period-8 block pattern, attn at index 4)."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536, d_head=128,
        norm="rmsnorm", act="silu", glu=True,
        block_pattern=("mamba", "mamba", "mamba", "mamba",
                       "attn", "mamba", "mamba", "mamba"),
        moe=True, n_experts=16, top_k=2, d_ff_expert=14336, moe_every=2,
        mamba_d_state=16, mamba_d_conv=4, mamba_expand=2)
