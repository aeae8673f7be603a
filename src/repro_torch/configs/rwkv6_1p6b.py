"""RWKV-6 Finch 1.6B [arXiv:2404.05892]: attention-free, data-dependent
decay; channel-mix d_ff=7168."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048,
        n_heads=32, n_kv_heads=32, d_ff=7168, vocab=65536, d_head=64,
        rope="none", norm="layernorm", act="relu", glu=False,
        block_pattern=("rwkv",), rwkv_head_dim=64)
