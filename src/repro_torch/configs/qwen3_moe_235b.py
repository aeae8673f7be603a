"""Qwen3-235B-A22B MoE [hf:Qwen/Qwen3-30B-A3B family]: 128 experts, top-8,
GQA kv=4, qk_norm, expert d_ff=1536."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe", n_layers=94, d_model=4096,
        n_heads=64, n_kv_heads=4, d_ff=1536, vocab=151936, d_head=128,
        qk_norm=True, rope_theta=1e6, norm="rmsnorm", act="silu", glu=True,
        moe=True, n_experts=128, top_k=8, d_ff_expert=1536)
