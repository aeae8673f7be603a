"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base]: 128 experts
top-2 with a parallel dense-FFN residual branch."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b", family="moe", n_layers=35, d_model=7168,
        n_heads=56, n_kv_heads=8, d_ff=4864, vocab=32000, d_head=128,
        norm="rmsnorm", act="silu", glu=True,
        moe=True, n_experts=128, top_k=2, d_ff_expert=4864, dense_residual=True)
