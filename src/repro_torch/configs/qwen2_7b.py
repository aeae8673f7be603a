"""Qwen2-7B [arXiv:2407.10671; hf]: dense, GQA kv=4, QKV bias."""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-7b", family="dense", n_layers=28, d_model=3584,
        n_heads=28, n_kv_heads=4, d_ff=18944, vocab=152064, d_head=128,
        attn_bias=True, rope_theta=1e6, norm="rmsnorm", act="silu", glu=True)
